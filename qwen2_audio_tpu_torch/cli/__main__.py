import sys

from qwen2_audio_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
