"""The port's audio inputs (audio/mp3.py, audio/capture.py, audio/vad.py and
``read_audio``'s dispatch) against the JAX package's, on the same files and
samples made from a seed: mp3 decodes bit-equal (libmp3lame, where the host
has it, writes the mp3s, as in tests/test_mp3.py), PCM chunks and the VAD's
filter and decisions equal; and the port's streaming example fed raw PCM
on stdin."""

import os
import subprocess
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest

from qwen2_audio_tpu import audio as jaudio
from qwen2_audio_tpu.audio import capture as jcap
from qwen2_audio_tpu.audio import vad as jvad
from qwen2_audio_tpu_torch import audio as taudio
from qwen2_audio_tpu_torch.audio import capture as tcap
from qwen2_audio_tpu_torch.audio import vad as tvad
from tests.test_mp3 import LAME, encode_mp3, tone

ROOT = Path(__file__).resolve().parents[1]
needs_mp3 = pytest.mark.skipif(not taudio.have_mp3() or LAME is None,
                               reason="libmpg123 or libmp3lame not available")


def test_have_mp3_matches_jax():
    assert taudio.have_mp3() == jaudio.have_mp3()


@needs_mp3
@pytest.mark.parametrize("rate,stereo", [(16000, False), (44100, False), (16000, True),
                                         (22050, True)])
def test_mp3_decode_bit_equal(tmp_path, rate, stereo):
    rng = np.random.default_rng(rate)
    x = tone(440.0, rate) + 0.05 * rng.standard_normal(int(rate * 1.5)).astype(np.float32)
    if stereo:
        x = np.stack([x, tone(300.0, rate)], axis=1)
    path = str(tmp_path / "t.mp3")
    encode_mp3(path, x, rate)
    for kw in ({}, {"to_mono": False}, {"expect_rate": None}):
        got, sr = taudio.read_mp3(path, **kw)
        want, jsr = jaudio.read_mp3(path, **kw)
        assert sr == jsr and got.dtype == want.dtype and np.array_equal(got, want), kw


@needs_mp3
def test_read_audio_dispatch(tmp_path):
    sig = tone(440.0, 16000)
    w, m = str(tmp_path / "t.wav"), str(tmp_path / "t.mp3")
    taudio.write_wav(w, sig)
    encode_mp3(m, sig, 16000)
    for path in (w, m):
        got, sr = taudio.read_audio(path)
        want, jsr = jaudio.read_audio(path)
        assert sr == jsr == 16000 and np.array_equal(got, want)
    stereo = str(tmp_path / "s.wav")
    with wave.open(stereo, "wb") as f:   # write_wav writes mono only
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.stack([sig, -sig], axis=1) * 32767).astype("<i2").tobytes())
    got, _ = taudio.read_audio(stereo, to_mono=False)
    want, _ = jaudio.read_audio(stereo, to_mono=False)
    assert got.shape == (sig.size, 2) and np.array_equal(got, want)


def test_read_audio_unknown_magic(tmp_path):
    bad = tmp_path / "x.bin"
    bad.write_bytes(b"NOPE" + bytes(64))
    with pytest.raises(Exception) as t:
        taudio.read_audio(str(bad))
    with pytest.raises(Exception) as j:
        jaudio.read_audio(str(bad))
    assert type(t.value) is type(j.value)


def test_read_mp3_missing_file():
    if not taudio.have_mp3():
        with pytest.raises(RuntimeError, match="libmpg123"):
            taudio.read_mp3("missing.mp3")
    else:
        with pytest.raises((ValueError, OSError)):
            taudio.read_mp3(os.path.join(os.sep, "nonexistent", "x.mp3"))


@pytest.mark.parametrize("fmt", ["s16le", "f32le"])
def test_decode_pcm_matches_jax(fmt):
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, size=4000, dtype=np.uint8).tobytes()
    got, want = tcap.decode_pcm(raw, fmt), jcap.decode_pcm(raw, fmt)
    assert got.dtype == np.float32 and np.array_equal(got, want, equal_nan=True)
    with pytest.raises(ValueError):
        tcap.decode_pcm(raw, "u8")


def _pipe_chunks(mod, data: bytes, **kw):
    """pcm_chunks over an os.pipe fed by a thread in uneven writes."""
    r, w = os.pipe()

    def feed():
        with os.fdopen(w, "wb", buffering=0) as f:
            for i in range(0, len(data), 777):
                f.write(data[i:i + 777])

    t = threading.Thread(target=feed)
    t.start()
    with os.fdopen(r, "rb", buffering=0) as f:
        out = list(mod.pcm_chunks(f, **kw))
    t.join()
    return out


@pytest.mark.parametrize("fmt,nbytes", [("s16le", 3 * 3200 + 1001), ("f32le", 6400 * 2 + 6)])
def test_pcm_chunks_over_a_pipe(fmt, nbytes):
    rng = np.random.default_rng(4)
    data = (rng.standard_normal(nbytes // 2) * 0.1).astype("<f4").tobytes()[:nbytes] \
        if fmt == "f32le" else rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()
    got = _pipe_chunks(tcap, data, rate=16000, chunk_ms=100, fmt=fmt)
    want = _pipe_chunks(jcap, data, rate=16000, chunk_ms=100, fmt=fmt)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert len(got[-1]) < len(got[0])   # the short tail, partial sample dropped


def test_is_pipe_source(tmp_path):
    f = tmp_path / "x.raw"
    f.write_bytes(b"\0\0")
    fifo = str(tmp_path / "p.fifo")
    os.mkfifo(fifo)
    for src in ("-", str(f), fifo, str(tmp_path / "missing")):
        assert tcap.is_pipe_source(src) == jcap.is_pipe_source(src)
    assert tcap.is_pipe_source(fifo) and not tcap.is_pipe_source(str(f))


@pytest.mark.parametrize("cutoff", [50.0, 100.0, 1000.0])
def test_high_pass_filter_matches_jax(cutoff):
    x = np.random.default_rng(5).standard_normal(16000).astype(np.float32)
    got = tvad.high_pass_filter(x, cutoff, 16000)
    assert got.dtype == np.float32 and np.array_equal(got, jvad.high_pass_filter(x, cutoff, 16000))
    assert tvad.high_pass_filter(np.zeros(0, np.float32), cutoff, 16000).size == 0


def test_vad_simple_matches_jax():
    rng = np.random.default_rng(6)
    speech = 0.5 * rng.standard_normal(16000).astype(np.float32)
    cases = [np.concatenate([speech, 0.001 * rng.standard_normal(8000).astype(np.float32)]),
             speech, speech[:2000],
             np.concatenate([speech, 0.3 * rng.standard_normal(8000).astype(np.float32)])]
    got = [tvad.vad_simple(c, 16000, last_ms=300, vad_thold=0.6, freq_thold=f)
           for c in cases for f in (0.0, 100.0)]
    assert got == [jvad.vad_simple(c, 16000, last_ms=300, vad_thold=0.6, freq_thold=f)
                   for c in cases for f in (0.0, 100.0)]
    assert got[0] and not got[2]
    assert tvad.similarity("abc", "abd") == jvad.similarity("abc", "abd")


def test_stream_example_stdin_pipe(tmp_path):
    """Raw s16le PCM piped into the port's stream example ('-', -ng): the
    VAD fires a flush and the encoder-only tiny model prints its
    '<encoded ...>' line."""
    from qwen2_audio_tpu_torch.config import WhisperHParams
    from qwen2_audio_tpu_torch.io.export import write_encoder_checkpoint
    from qwen2_audio_tpu_torch.models.encoder import random_encoder_params

    hp = WhisperHParams(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                        n_mels=16)
    model = str(tmp_path / "model.bin")
    write_encoder_checkpoint(model, random_encoder_params(np.random.default_rng(0), hp), hp,
                             taudio.mel_filterbank(hp.n_mels), [b"t%d" % i for i in range(60)])
    t = np.arange(2 * 16000) / 16000
    sig = np.concatenate([0.3 * np.sin(2 * np.pi * 330 * t), np.zeros(16000)])
    pcm = np.clip(sig * 32768.0, -32768, 32767).astype("<i2").tobytes()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "qwen2_audio_tpu_torch.cli.stream", model, "-",
                        "-ng"], input=pcm, capture_output=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    lines = [ln for ln in r.stdout.decode().splitlines() if "<encoded" in ln]
    assert lines and lines[0].startswith("[   0.00s] <encoded (750, 64)>"), r.stdout
