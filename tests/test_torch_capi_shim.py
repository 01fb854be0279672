"""The port's C API shim (qwen2_audio_tpu_torch/native_src/qa_capi.cpp, which
embeds Python and delegates to qwen2_audio_tpu_torch.capi) run through its
command line (native_src/main.c, qa_main_torch) with ``-ng``, as
tests/test_capi_shim.py runs the JAX package's: two whisper_full passes print two equal
fingerprint lines, equal to the port's capi in this process on the same
files (the same code on the same host: the strings are equal), the elapsed
time and the vocabulary size. Without ``-ng`` the shim asks for the card and,
on a host without one, fails loudly."""

import subprocess

import numpy as np
import pytest

from qwen2_audio_tpu_torch import capi
from qwen2_audio_tpu_torch.audio import mel_filterbank, read_wav, write_wav
from qwen2_audio_tpu_torch.config import WhisperHParams
from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
from qwen2_audio_tpu_torch.models.encoder import random_encoder_params
from qwen2_audio_tpu_torch.runtime import ContextParams
from test_torch_native_builds import capi_build, embedded_env


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi_torch")
    hp = WhisperHParams(n_vocab=64, n_audio_state=64, n_audio_head=4,
                        n_audio_layer=2, n_mels=16)
    model = str(d / "m.bin")
    wav = str(d / "a.wav")
    write_encoder_checkpoint(model, random_encoder_params(np.random.default_rng(0), hp),
                             hp, mel_filterbank(16), [b"x"] * 60)
    t = np.arange(32000) / 16000
    write_wav(wav, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    return model, wav


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    return capi_build(tmp_path_factory)[1]


def _local_fingerprint(model: str, wav: str) -> str:
    ctx = capi.whisper_init_from_file_with_params(model, ContextParams(use_gpu=False))
    samples, _ = read_wav(wav)
    assert capi.whisper_full(ctx, capi.whisper_full_default_params(), samples) == 0
    return ctx.print_emb_enc()


def test_qa_main_torch_end_to_end(assets, program):
    model, wav = assets
    r = subprocess.run([str(program), "-ng", model, wav, "2"], capture_output=True,
                       text=True, env=embedded_env(), timeout=600)
    assert r.returncode == 0, r.stderr
    fps = [ln for ln in r.stdout.splitlines() if ln.startswith(" ")]
    assert len(fps) == 2 and fps[0] == fps[1]
    assert fps[0] == _local_fingerprint(model, wav)
    assert "Elapsed time is" in r.stdout
    assert "n_vocab=64" in r.stderr and "asked for the cpu; context on cpu)" in r.stderr
    assert "encode time" in r.stderr            # whisper_print_timings


def test_qa_main_torch_usage(program):
    r = subprocess.run([str(program), "-ng"], capture_output=True, text=True,
                       env=embedded_env(), timeout=60)
    assert r.returncode == 1 and "usage:" in r.stderr


def test_qa_main_torch_asks_for_the_card(assets, program):
    """Without -ng the shim passes use_gpu = true: on the card it runs
    there, and on a host without one the context is refused (exit 2), never
    moved to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs the program there")
    model, wav = assets
    r = subprocess.run([str(program), model, wav, "1"], capture_output=True, text=True,
                       env=embedded_env(), timeout=600)
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr and "failed to load model" in r.stderr
