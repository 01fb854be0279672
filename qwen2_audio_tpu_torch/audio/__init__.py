from qwen2_audio_tpu_torch.audio.capture import (  # noqa: F401
    decode_pcm,
    is_pipe_source,
    pcm_chunks,
)
from qwen2_audio_tpu_torch.audio.filters import mel_filterbank, resample  # noqa: F401
from qwen2_audio_tpu_torch.audio.mel import (  # noqa: F401
    LogMelSpectrogram,
    log_mel_spectrogram,
    log_mel_spectrogram_np,
    mel_input_window,
)
from qwen2_audio_tpu_torch.audio.mp3 import have_mp3, read_mp3  # noqa: F401
from qwen2_audio_tpu_torch.audio.wav import read_wav, write_wav  # noqa: F401


def read_audio(path: str, expect_rate: int | None = 16000, to_mono: bool = True):
    """Format-sniffing audio reader: RIFF/WAVE through read_wav, mp3 (an ID3
    tag or an MPEG sync word) through read_mp3; the reference's
    read_audio_data dispatch (examples/common.cpp:644-690: wav read
    directly, anything else through ffmpeg when built in)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head[:4] == b"RIFF":
        return read_wav(path, expect_rate=expect_rate, to_mono=to_mono)
    if head[:3] == b"ID3" or (len(head) >= 2 and head[0] == 0xFF
                              and (head[1] & 0xE0) == 0xE0):
        return read_mp3(path, expect_rate=expect_rate, to_mono=to_mono)
    # unknown magic: the wav parser gives the descriptive error
    return read_wav(path, expect_rate=expect_rate, to_mono=to_mono)
