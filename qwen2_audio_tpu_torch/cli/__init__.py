"""The port's command line: ``python -m qwen2_audio_tpu_torch.cli`` (main.py),
the bench (bench_cli.py) and the transcription and streaming examples
(transcribe.py, stream.py). Each runs on the card unless ``-ng`` asks for
the CPU."""
