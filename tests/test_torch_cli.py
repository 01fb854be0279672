"""The port's command line (cli/main.py, output_formats.py, bench_cli.py,
transcribe.py, stream.py) against the JAX package's CLI (top-level cli/) on
the CPU: a tiny ggml checkpoint, a wav and a tiny HF Qwen2-Audio decoder
(written by transformers' ``save_pretrained``; nothing is downloaded), the
same flags to both, ``-ng`` for the port.

With a decoder, ``-nf`` turns the temperature fallback off: a fallback
samples at temperature > 0, where the port draws from a seeded
``torch.Generator`` and JAX from its own key, so sampled tokens differ by
design; greedy tokens are the same. The output files are then byte-equal;
the printed fingerprints (20 floats at 3 decimals) within 1.5e-3 (the
embeddings differ by float32 summation order, about 1e-6, which can move a
printed value across one rounding step)."""

import dataclasses
import os
import shutil
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import cli.main as jcli
import cli.output_formats as jfmt
from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import WhisperHParams
from qwen2_audio_tpu.io.export import write_encoder_checkpoint
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu_torch.audio import write_wav
from qwen2_audio_tpu_torch.cli import bench_cli, transcribe
from qwen2_audio_tpu_torch.cli import main as tcli
from qwen2_audio_tpu_torch.cli import output_formats as tfmt

ROOT = Path(__file__).resolve().parents[1]
HP = WhisperHParams(n_vocab=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_mels=16)
FP_ATOL = 1.5e-3
OUTPUTS = ["-otxt", "-osrt", "-ovtt", "-oj", "-ocsv", "-olrc"]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from transformers import (Qwen2AudioConfig, Qwen2AudioEncoderConfig,
                              Qwen2AudioForConditionalGeneration)
    from transformers.models.qwen2.configuration_qwen2 import Qwen2Config

    d = tmp_path_factory.mktemp("torch_cli")
    model = str(d / "model.bin")
    write_encoder_checkpoint(model, random_encoder_params(np.random.default_rng(0), HP), HP,
                             mel_filterbank(HP.n_mels), [b"t%d" % i for i in range(60)])
    t = np.arange(48000) / 16000.0
    noise = np.random.default_rng(1).standard_normal(t.size)
    wav = str(d / "in.wav")
    write_wav(wav, (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * noise).astype(np.float32))
    stereo = str(d / "stereo.wav")
    left = 0.5 * np.sin(2 * np.pi * 330 * t)
    right = np.where(t < 1.5, 0.01, 0.6) * np.sin(2 * np.pi * 250 * t)
    with wave.open(stereo, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.stack([left, right], axis=1) * 32767).astype("<i2").tobytes())
    audio = Qwen2AudioEncoderConfig(d_model=64, encoder_attention_heads=4, encoder_layers=2,
                                    num_mel_bins=16, max_source_positions=1500,
                                    encoder_ffn_dim=256)
    text = Qwen2Config(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       rope_theta=1_000_000.0, tie_word_embeddings=False, eos_token_id=7)
    cfg = Qwen2AudioConfig(audio_config=audio.to_dict(), text_config=text.to_dict(),
                           audio_token_index=120)
    torch.manual_seed(11)
    hf = str(d / "hf")
    Qwen2AudioForConditionalGeneration(cfg).eval().save_pretrained(hf, safe_serialization=False)
    return {"dir": d, "model": model, "wav": wav, "stereo": stereo, "hf": hf}


@pytest.fixture(autouse=True)
def _default_log_sinks():
    """-np silences the process's log sink (both packages'): put it back."""
    yield
    from qwen2_audio_tpu.utils.logging import log_set as jlog_set
    from qwen2_audio_tpu_torch.utils.logging import log_set as tlog_set
    jlog_set(None)
    tlog_set(None)


def _fingerprints(out: str) -> list[np.ndarray]:
    return [np.array([float(v) for v in ln.split()]) for ln in out.splitlines()
            if ln.startswith(" ") and len(ln.split()) == 20]


def _in(d: Path, wav: str) -> str:
    d.mkdir(exist_ok=True)
    return str(shutil.copy(wav, d / Path(wav).name))


def _both(assets, tmp_path, capsys, flags, wav="wav"):
    """The JAX CLI and the port's (-ng) on the same flags, each on its own
    copy of the input; (rc, stdout, input path) of each."""
    res = {}
    for name, run, extra in (("jax", jcli.main, []), ("port", tcli.main, ["-ng"])):
        src = _in(tmp_path / name, assets[wav])
        rc = run(["-m", assets["model"], "-f", src, *flags, *extra])
        res[name] = (rc, capsys.readouterr().out, src)
    return res


def test_cli_with_decoder_matches_jax(assets, tmp_path, capsys):
    res = _both(assets, tmp_path, capsys, ["--decoder", assets["hf"], "--bench-iters", "2",
                                           "--max-new-tokens", "8", "-nf", *OUTPUTS])
    (jrc, jout, jsrc), (trc, tout, tsrc) = res["jax"], res["port"]
    assert jrc == trc == 0
    jf, tf = _fingerprints(jout), _fingerprints(tout)
    assert len(tf) == len(jf) == 2 and np.array_equal(tf[0], tf[1])
    np.testing.assert_allclose(tf[0], jf[0], atol=FP_ATOL, rtol=0)
    seg = lambda out: [ln for ln in out.splitlines()[out.splitlines().index(   # noqa: E731
        next(x for x in out.splitlines() if x.startswith("Elapsed"))) + 1:]]
    assert seg(tout) == seg(jout) and seg(tout)
    for ext in ("txt", "srt", "vtt", "json", "csv", "lrc"):
        got = Path(tsrc).with_suffix("." + ext).read_bytes()
        assert got == Path(jsrc).with_suffix("." + ext).read_bytes(), ext
        assert got


def test_cli_diarize_matches_jax(assets, tmp_path, capsys):
    res = _both(assets, tmp_path, capsys, ["--decoder", assets["hf"], "--bench-iters", "1",
                                           "--max-new-tokens", "4", "-nf", "-di", "-otxt"],
                wav="stereo")
    (jrc, jout, jsrc), (trc, tout, tsrc) = res["jax"], res["port"]
    assert jrc == trc == 0
    lines = [ln for ln in tout.splitlines() if ln.startswith("(speaker")]
    assert lines and lines == [ln for ln in jout.splitlines() if ln.startswith("(speaker")]
    assert Path(tsrc).with_suffix(".txt").read_bytes() == \
        Path(jsrc).with_suffix(".txt").read_bytes()


def test_cli_encode_bench_matches_jax(assets, tmp_path, capsys):
    res = _both(assets, tmp_path, capsys, ["--bench-iters", "2", "-np"])
    (jrc, jout, _), (trc, tout, _) = res["jax"], res["port"]
    assert jrc == trc == 0
    assert tout.count("Elapsed time is ") == 1
    tf, jf = _fingerprints(tout), _fingerprints(jout)
    assert len(tf) == 2 and np.array_equal(tf[0], tf[1])
    np.testing.assert_allclose(tf[0], jf[0], atol=FP_ATOL, rtol=0)


def test_cli_subprocess_writes_the_same_txt(assets, tmp_path, capsys):
    """``python -m qwen2_audio_tpu_torch.cli -ng -np`` (no JAX in the
    process) writes the txt the in-process run writes."""
    flags = ["--decoder", assets["hf"], "--bench-iters", "1", "--max-new-tokens", "8", "-nf",
             "-otxt", "-ng"]
    a = _in(tmp_path / "a", assets["wav"])
    assert tcli.main(["-m", assets["model"], "-f", a, *flags]) == 0
    b = _in(tmp_path / "b", assets["wav"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "qwen2_audio_tpu_torch.cli", "-m", assets["model"],
                        "-f", b, *flags, "-np"], capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "jax" not in r.stderr.lower()
    assert Path(b).with_suffix(".txt").read_bytes() == Path(a).with_suffix(".txt").read_bytes()


def test_cli_response_file(assets, tmp_path, capsys):
    src = _in(tmp_path, assets["wav"])
    rsp = tmp_path / "args.rsp"
    rsp.write_text(f"-m {assets['model']} -f {src} --bench-iters 1 -np -ng")
    rc, ctx = tcli.run([f"@{rsp}"])
    assert rc == 0 and ctx.device.type == "cpu"
    assert len(_fingerprints(capsys.readouterr().out)) == 1


def test_cli_errors(assets, capsys):
    assert tcli.main(["-m", "x.bin"]) == 1
    assert "no input files" in capsys.readouterr().err
    assert tcli.main(["-m", assets["model"], "-f", assets["wav"], "-di", "-tdrz", "-ng"]) == 1
    assert "cannot use both" in capsys.readouterr().err
    # --rpc connects before anything else: no server on the port, no run
    with pytest.raises(ConnectionRefusedError):
        tcli.main(["-m", assets["model"], "-f", assets["wav"], "--rpc", "127.0.0.1:1"])


def test_cli_runs_on_the_card_by_default(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["-m", assets["model"], "-f", assets["wav"], "--bench-iters", "1", "-np"])


@pytest.mark.parametrize("fail_in", ["init", "full"])
def test_cli_watchdog_cancelled_when_the_card_phase_raises(assets, monkeypatch, fail_in):
    """run() is an in-process API: a guarded phase that raises must cancel
    its deadline, else a daemon thread ends the host process later."""
    import threading

    import qwen2_audio_tpu_torch.runtime as truntime

    def _guards():
        return [t for t in threading.enumerate()
                if t.name.startswith("watchdog:cli:") and t.is_alive()]

    seen = []

    class Failing:
        def __init__(self, model, cparams):
            assert cparams.use_gpu
            seen.append([t.name for t in _guards()])
            if fail_in == "init":
                raise RuntimeError("upload failed")

        def full(self, fp, samples):
            # the upload's deadline was cancelled: its thread ends on its own
            for t in _guards():
                if t.name == "watchdog:cli:init":
                    t.join(timeout=5.0)
            seen.append([t.name for t in _guards()])
            raise RuntimeError("kernel failed")

    monkeypatch.setattr(truntime, "WhisperContext", Failing)
    with pytest.raises(RuntimeError, match="failed"):
        tcli.run(["-m", assets["model"], "-f", assets["wav"], "--bench-iters", "1", "-np"])
    # each phase ran under its own armed deadline ...
    want = [["watchdog:cli:init"]] + ([["watchdog:cli:full:in.wav"]] if fail_in == "full"
                                      else [])
    assert seen == want
    # ... and none is left armed after the exception
    for t in _guards():
        t.join(timeout=5.0)
    assert _guards() == []


def test_cli_residual_flags_warn(assets, capsys):
    rc = tcli.main(["-m", assets["model"], "-f", assets["wav"], "--bench-iters", "1", "-np",
                    "-ng", "-oved", "GPU", "--grammar-penalty", "5"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "--ov-e-device is inert" in err and "--grammar" in err


ARGVS = [
    ["-f", "x.wav"],
    ["-f", "x.wav", "-bs", "5", "-nf", "-wt", "0.5", "-mc", "64", "-tdrz", "-et", "3.1",
     "-lpt", "-0.5", "--temperature", "0.3"],
    ["-f", "x.wav", "-t", "7", "-pp", "-ot", "500", "-d", "2000", "-l", "de", "-dl", "-tr",
     "-ac", "750", "--spec-k", "3", "--max-new-tokens", "9", "-ps", "-nt"],
    ["-f", "x.wav", "-tpi", "0.35", "-ojf", "-sow"],
    ["-f", "x.wav", "-owts"],
    ["-f", "x.wav", "-ml", "12", "--suppress-regex", "^x", "--prompt", "hi", "-debug"],
]


def _fields(fp) -> dict:
    return {f.name: getattr(fp, f.name) for f in dataclasses.fields(fp)
            if not f.name.endswith("_callback")}


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_build_full_params_matches_jax(argv):
    got = tcli.build_full_params(tcli.build_parser().parse_args(argv))
    want = jcli.build_full_params(jcli.build_parser().parse_args(argv))
    assert _fields(got) == _fields(want)


def test_parsers_have_the_same_flags():
    def flags(p):
        return sorted((tuple(a.option_strings), a.default) for a in p._actions
                      if a.option_strings and a.dest != "help")
    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


def test_estimate_diarization_speaker_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        st = rng.standard_normal((16000, 2)).astype(np.float32) * rng.uniform(0.1, 2, 2)
        t0, t1 = sorted(rng.integers(0, 120, 2))
        for id_only in (False, True):
            assert tcli.estimate_diarization_speaker(st, t0, t1, id_only) == \
                jcli.estimate_diarization_speaker(st, t0, t1, id_only)


SEGS = [
    {"t0": 0, "t1": 500, "text": " Hello world.", "tokens": [1, 2], "probs": [0.9, 0.8],
     "token_texts": ["He", "llo"], "token_times": [0, 250], "speaker_turn_next": False},
    {"t0": 500, "t1": 6000, "text": ' With "quotes", ü: 50%.', "tokens": [3],
     "probs": [0.7], "speaker_turn_next": False},
    {"t0": 360000, "t1": 360125, "text": " x", "tokens": [7], "speaker_turn_next": True},
]


@pytest.mark.parametrize("fmt", sorted(jfmt.WRITERS))
def test_writers_byte_equal(tmp_path, fmt):
    a, b = str(tmp_path / f"t.{fmt}"), str(tmp_path / f"j.{fmt}")
    tfmt.WRITERS[fmt](a, SEGS)
    jfmt.WRITERS[fmt](b, SEGS)
    assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("argv", [OUTPUTS, ["-ojf"], ["-oj", "-ojf", "-on", "3", "-of", "out"],
                                  ["-osrt", "-on", "2"]], ids=range(4))
def test_write_outputs_byte_equal(tmp_path, argv):
    written = {}
    for name, mod, cli in (("t", tfmt, tcli), ("j", jfmt, jcli)):
        d = tmp_path / name
        d.mkdir()
        args = cli.build_parser().parse_args(["-f", "x.wav", *argv])
        if args.output_file:
            args.output_file = str(d / args.output_file)
        written[name] = [Path(p) for p in mod.write_outputs(str(d / "clip.wav"), SEGS, args)]
    assert [p.name for p in written["t"]] == [p.name for p in written["j"]] and written["t"]
    for a, b in zip(written["t"], written["j"]):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_wts_and_colors_match_jax(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    a, b = str(tmp_path / "t" / "o.wts"), str(tmp_path / "j" / "o.wts")
    tfmt.write_wts(a, SEGS, "in.wav", 6000, font_path="f.ttf")
    jfmt.write_wts(b, SEGS, "in.wav", 6000, font_path="f.ttf")
    assert Path(a).read_text().replace(a, b) == Path(b).read_text()
    for s in SEGS:
        assert tfmt.colorize_segment(s) == jfmt.colorize_segment(s)
    assert tfmt.format_timestamp(6000, comma=True) == jfmt.format_timestamp(6000, comma=True)


def test_bench_cli_memcpy_and_encoder_on_the_cpu(capsys):
    assert bench_cli.main(["-w", "2", "-t", "2"]) == 0
    assert bench_cli.main(["-w", "1", "-ng"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("memcpy: ") and "encoder (tiny): " in out and "ms / 30 s clip" in out


def test_transcribe_example(assets, capsys):
    assert transcribe.main([assets["model"], assets["wav"], "-ng"]) == 0
    fp = _fingerprints(capsys.readouterr().out)
    assert transcribe.main([assets["model"], assets["wav"], assets["hf"], "-ng"]) == 0
    out = capsys.readouterr().out
    assert len(fp) == 1 and out.startswith("[   0.00s ->    2.99s] ")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            transcribe.main([assets["model"], assets["wav"]])
