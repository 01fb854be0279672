from qwen2_audio_tpu_torch.utils.logging import log, log_set, LogLevel  # noqa: F401
from qwen2_audio_tpu_torch.utils.timings import Timings  # noqa: F401
