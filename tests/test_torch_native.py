"""The port's native.py against the JAX package's native.py: the same library
(native/, built into the git-ignored native/build), the same paths, and the
same results with the library and, where it is missing, from each
package's host fallbacks (monkeypatched absent). Quantization and the wav
and mp3 readers are bit-equal; the mel within 5e-4 (the JAX test's bound for
the native mel against the Python one; here the port's plain CPU mel against
the JAX XLA mel in the fallback). The library cases load the library the
session builds for itself, not native/build."""

import ctypes

import numpy as np
import pytest

from qwen2_audio_tpu import native as jnative
from qwen2_audio_tpu.config import GGMLType
from qwen2_audio_tpu_torch import native as tnative
from qwen2_audio_tpu_torch.audio import mel_filterbank, write_wav
from test_torch_native_builds import native_build

FORMATS = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0]


@pytest.fixture(params=["library", "fallback"])
def mode(request, monkeypatch, tmp_path_factory):
    """Both modules with the library loaded, or with it absent (each
    package's host fallbacks). The library is the one the test session
    builds for itself (test_torch_native_builds.native_build), so these
    cases neither skip nor depend on whether native/build exists yet."""
    if request.param == "library":
        lib = str(native_build(tmp_path_factory) / "libqa_native.so")
        monkeypatch.setattr(tnative, "_lib", tnative._bind(ctypes.CDLL(lib)))
        monkeypatch.setattr(jnative, "_lib", jnative._bind(ctypes.CDLL(lib)))
    else:
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "load", lambda auto_build=False: None)
    return request.param


def test_same_library_paths():
    assert tnative._BUILD_DIR == jnative._BUILD_DIR
    assert tnative._LIB_PATHS == jnative._LIB_PATHS
    assert tnative.available() == jnative.available()


@pytest.mark.parametrize("ttype", FORMATS)
def test_quantize_round_trip_matches_jax(mode, ttype):
    x = np.random.default_rng(int(ttype)).standard_normal(32 * 33).astype(np.float32)
    got = tnative.quantize(x, ttype, n_threads=3)
    np.testing.assert_array_equal(got, jnative.quantize(x, ttype, n_threads=3))
    np.testing.assert_array_equal(tnative.dequantize(got, ttype, x.size, n_threads=3),
                                  jnative.dequantize(got, ttype, x.size, n_threads=3))


def test_wav_read_matches_jax(mode, tmp_path):
    path = str(tmp_path / "t.wav")
    x = (0.5 * np.sin(np.linspace(0, 100, 8000))).astype(np.float32)
    write_wav(path, x)
    got, rate = tnative.wav_read(path)
    want, jrate = jnative.wav_read(path)
    assert rate == jrate == 16000 and np.array_equal(got, want)
    np.testing.assert_allclose(got, x, atol=1e-4)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(mode, n_mels):
    rng = np.random.default_rng(n_mels)
    filters = mel_filterbank(n_mels)
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)
         + 0.05 * rng.standard_normal(16000)).astype(np.float32)
    data, n_len_org = tnative.log_mel(x, filters, n_threads=3)
    want, jn = jnative.log_mel(x, filters, n_threads=3)
    assert isinstance(data, np.ndarray) and data.shape == np.asarray(want).shape
    assert n_len_org == jn
    np.testing.assert_allclose(data, np.asarray(want), atol=5e-4, rtol=0)


def test_mp3_read_matches_jax(mode, tmp_path):
    from qwen2_audio_tpu_torch.audio import have_mp3
    from tests.test_mp3 import LAME, encode_mp3, tone
    if not have_mp3() or LAME is None:
        pytest.skip("libmpg123 or libmp3lame not available")
    path = str(tmp_path / "t.mp3")
    encode_mp3(path, tone(523.0, 22050), 22050)
    got, rate = tnative.mp3_read(path)
    want, jrate = jnative.mp3_read(path)
    assert rate == jrate == 22050 and np.array_equal(got, want)


def test_bench_memcpy(mode):
    assert tnative.bench_memcpy_gbps(bytes_=1 << 22, n_threads=2) > 0.01


def test_native_dataset_matches_host_path(tmp_path):
    """AudioTextDataset(use_native=True) gives the host path's example."""
    from qwen2_audio_tpu_torch.config import WhisperHParams
    from qwen2_audio_tpu_torch.training import data

    write_wav(str(tmp_path / "a.wav"), (0.3 * np.sin(np.arange(24000) / 9.0)).astype(np.float32))
    (tmp_path / "a.txt").write_text("hello")
    hp = WhisperHParams(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                        n_mels=16)
    ex = data.discover_pairs(tmp_path)
    tok = lambda s: [ord(c) % 60 for c in s]   # noqa: E731
    a = data.AudioTextDataset(ex, hp, mel_filterbank(16), tok, use_native=True).load(0)
    b = data.AudioTextDataset(ex, hp, mel_filterbank(16), tok).load(0)
    assert a[1] == b[1] and a[0].shape == b[0].shape == (16, 3000)
    np.testing.assert_allclose(a[0], b[0], atol=1e-3, rtol=0)
