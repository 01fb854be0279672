"""The port's remote offload (runtime/rpc.py) on the CPU: every case of the
JAX package's tests/test_rpc.py on the port's server and client
(``ContextParams(use_gpu=False)``, the CLI with ``-ng``), the remote run
against a local port context, wire compatibility both ways with the JAX
package (the port's client against the JAX server, the JAX client against
the port's server), native/qa_rpc against the port's server, and the
server as a process of its own.

Tolerances: the port's remote embedding is bit-equal to a local port
context's (the same code on the same host). Across the packages the
fingerprint strings are equal and the embeddings within 1e-4, the bound
tests/test_torch_context.py holds the two packages' whisper_full to."""

import dataclasses
import io
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import WhisperHParams
from qwen2_audio_tpu.io.export import write_encoder_checkpoint
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.runtime import rpc as jrpc
from qwen2_audio_tpu.runtime.context import ContextParams as JContextParams
from qwen2_audio_tpu_torch.audio import read_wav, write_wav
from qwen2_audio_tpu_torch.runtime import (ContextParams, FullParams, RemoteWhisperContext,
                                           RpcServer, WhisperContext, full_default_params)
from qwen2_audio_tpu_torch.runtime import rpc as trpc
from qwen2_audio_tpu_torch.runtime.rpc import RpcError
from test_torch_native_builds import native_build

ROOT = Path(__file__).resolve().parents[1]
CPU = ContextParams(use_gpu=False)
CROSS_ATOL = 1e-4


@pytest.fixture(scope="module")
def model_bytes():
    hp = WhisperHParams(n_vocab=64, n_audio_ctx=128, n_audio_state=64,
                        n_audio_head=2, n_audio_layer=1, n_mels=16)
    params = random_encoder_params(np.random.default_rng(0), hp)
    buf = io.BytesIO()
    write_encoder_checkpoint(buf, params, hp, mel_filterbank(16),
                             [b"tok%d" % i for i in range(60)])
    return buf.getvalue()


@pytest.fixture(scope="module")
def server():
    """The port's server as a user starts it: contexts where the client
    asks (use_gpu=False here)."""
    srv = RpcServer("127.0.0.1", 0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def cpu_server():
    """The port's server started with -ng: every context on the CPU."""
    srv = RpcServer("127.0.0.1", 0, use_gpu=False)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_server():
    srv = jrpc.RpcServer("127.0.0.1", 0)
    srv.start_background()
    yield srv
    srv.shutdown()


@pytest.fixture()
def pcm():
    t = np.arange(16000 * 2) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def _local(model_bytes, pcm):
    ctx = WhisperContext.init_from_buffer_with_params(model_bytes, CPU)
    assert ctx.full(full_default_params(), pcm) == 0
    return ctx


def test_wire_constants_match_jax():
    for name in ("RPC_MAGIC", "RPC_VERSION", "CMD_HELLO", "CMD_LOAD_MODEL", "CMD_FULL",
                 "CMD_ENCODE", "CMD_GET_EMB_ENC", "CMD_GET_SEGMENTS", "CMD_GET_LOGITS",
                 "CMD_FREE", "CMD_SYSTEM_INFO", "CMD_SHUTDOWN", "STATUS_OK", "STATUS_ERR",
                 "_MAX_PAYLOAD", "_SKIP_FIELDS"):
        assert getattr(trpc, name) == getattr(jrpc, name), name


def test_payloads_byte_equal_to_jax():
    meta = {"ctx_id": 3, "fparams": {"offset_ms": 500, "language": "en"}}
    arrays = [np.arange(7, dtype=np.float32), np.frombuffer(b"\x01\x02\x03", np.uint8),
              np.zeros((2, 3), np.int32)]
    got = trpc._pack_json_arrays(meta, arrays)
    assert got == jrpc._pack_json_arrays(meta, arrays)
    m, a = trpc._unpack_json_arrays(got)
    assert m == meta and all(np.array_equal(x, y) for x, y in zip(a, arrays))


def test_sanitize_and_host_copies_of_tensors():
    seg = {"tokens": torch.tensor([3, 4], dtype=torch.int32), "p": torch.tensor(0.5),
           "t0": np.int64(7), "probs": [np.float32(0.25)], "text": "x"}
    assert trpc._sanitize([seg]) == [{"tokens": [3, 4], "p": 0.5, "t0": 7, "probs": [0.25],
                                      "text": "x"}]
    emb = torch.randn(3, 4, dtype=torch.bfloat16)
    host = trpc._host_f32(emb)
    assert host.dtype == np.float32 and np.array_equal(host, emb.float().numpy())
    assert trpc._host_f32(None).shape == (0,)


def test_rpc_hello_reports_backend(server, cpu_server):
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    assert cli.server_backend == ("cuda" if torch.cuda.is_available() else "cpu")
    assert "torch" in cli.system_info()
    cli.close()
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{cpu_server.port}")
    assert cli.server_backend == "cpu" and cli.server_devices == ["cpu"]
    cli.close()


def test_rpc_full_matches_local(server, model_bytes, pcm):
    """Remote whisper_full returns the same fingerprint, embedding (bit for
    bit) and segments as a local port context on the same checkpoint and
    audio."""
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    cli.load_model_bytes(model_bytes, CPU)
    assert cli.full(full_default_params(), pcm) == 0
    remote_fp = cli.print_emb_enc()
    remote_emb = cli.get_emb_enc()
    remote_segs = list(cli.segments)
    assert cli.get_logits().shape == (0,)          # no decoder, no logits
    cli.close()

    ctx = _local(model_bytes, pcm)
    want = ctx.state.embd_enc.numpy()
    assert remote_fp == ctx.print_emb_enc()
    assert remote_emb.dtype == np.float32 and remote_emb.shape == want.shape
    np.testing.assert_array_equal(remote_emb, want)
    assert len(remote_segs) == len(ctx.state.segments)
    for rs, ls in zip(remote_segs, ctx.state.segments):
        assert rs["text"] == ls["text"]
        assert rs["tokens"] == list(map(int, ls["tokens"]))


def test_rpc_encode_and_full_parallel(server, model_bytes, pcm):
    """encode() and full_parallel() (forwarded as full) on the server."""
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    cli.load_model_bytes(model_bytes, CPU)
    assert cli.full_parallel(full_default_params(), pcm, 2) == 0
    first = cli.get_emb_enc()
    assert cli.encode(0) == 0
    np.testing.assert_array_equal(cli.get_emb_enc(), first)
    cli.close()


def test_rpc_full_params_cross_the_wire(server, model_bytes, pcm):
    """Non-default FullParams fields survive serialization (callbacks are
    dropped, like ggml-rpc never forwards abort_callback)."""
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    cli.load_model_bytes(model_bytes, CPU)
    p = FullParams(offset_ms=500, audio_ctx=64, print_progress=False,
                   abort_callback=lambda: False)   # non-serializable, dropped
    assert cli.full(p, pcm) == 0
    ctx = WhisperContext.init_from_buffer_with_params(model_bytes, CPU)
    assert ctx.full(dataclasses.replace(p, abort_callback=None), pcm) == 0
    np.testing.assert_array_equal(cli.get_emb_enc(), ctx.state.embd_enc.numpy())
    cli.close()


def test_rpc_compute_dtype_stays_on_the_client(server, model_bytes, pcm):
    """compute_dtype (a torch.dtype) does not cross the wire: the server
    computes in its float32 default."""
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    cli.load_model_bytes(model_bytes, dataclasses.replace(CPU, compute_dtype=torch.bfloat16))
    assert cli.full(full_default_params(), pcm) == 0
    np.testing.assert_array_equal(cli.get_emb_enc(), _local(model_bytes, pcm).state.embd_enc)
    cli.close()


def test_rpc_errors_are_reported_not_fatal(server, model_bytes):
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    with pytest.raises(RpcError):            # no model loaded
        cli.full(full_default_params(), np.zeros(16000, np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RpcError, match="no CUDA device"):   # the card, refused here
            cli.load_model_bytes(model_bytes)
    # the connection survives an error frame
    cli.load_model_bytes(model_bytes, CPU)
    assert cli._ctx_id is not None
    cli.close()


def test_rpc_cpu_server_overrides_use_gpu(cpu_server, model_bytes, pcm):
    """A -ng server makes a CPU context even for a client that asks for
    the card (the default ContextParams)."""
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{cpu_server.port}")
    cli.load_model_bytes(model_bytes, ContextParams())
    assert cli.full(full_default_params(), pcm) == 0
    np.testing.assert_array_equal(cli.get_emb_enc(), _local(model_bytes, pcm).state.embd_enc)
    cli.close()


def test_rpc_multiple_contexts_isolated(server, model_bytes, pcm):
    a = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    b = RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    a.load_model_bytes(model_bytes, CPU)
    b.load_model_bytes(model_bytes, CPU)
    assert a._ctx_id != b._ctx_id
    assert a.full(full_default_params(), pcm) == 0
    assert a.segments is not None and b.segments == []   # b untouched
    a.close()
    b.close()


def test_rpc_cli_end_to_end(server, model_bytes, pcm, tmp_path, capsys):
    """The port's CLI with -ng --rpc HOST:PORT offloads the whole run to the
    server and prints the same fingerprint lines as a local -ng run."""
    from qwen2_audio_tpu_torch.cli.main import main as cli_main
    model = tmp_path / "model.bin"
    model.write_bytes(model_bytes)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), pcm)
    argv = ["-ng", "-m", str(model), "-f", str(wav), "--bench-iters", "2", "-np"]
    assert cli_main(argv) == 0
    local = capsys.readouterr().out.splitlines()
    assert cli_main(argv + ["--rpc", f"127.0.0.1:{server.port}"]) == 0
    remote = capsys.readouterr().out.splitlines()
    fps = [ln for ln in remote if ln.startswith(" ")]
    assert len(fps) == 2 and fps == [ln for ln in local if ln.startswith(" ")]
    assert any(ln.startswith("Elapsed time is") for ln in remote)


def test_rpc_cli_prints_offload_line(server, model_bytes, pcm, tmp_path, capsys):
    from qwen2_audio_tpu_torch.cli.main import main as cli_main
    model = tmp_path / "model.bin"
    model.write_bytes(model_bytes)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), pcm)
    assert cli_main(["-ng", "-m", str(model), "-f", str(wav), "--bench-iters", "1",
                     "--rpc", f"127.0.0.1:{server.port}"]) == 0
    err = capsys.readouterr().err
    assert f"rpc: offloading to 127.0.0.1:{server.port} (backend cpu)" in err


def test_port_client_against_jax_server(jax_server, model_bytes, pcm):
    """The port's client drives the JAX package's server."""
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{jax_server.port}")
    assert cli.server_backend == "cpu"
    cli.load_model_bytes(model_bytes, CPU)
    assert cli.full(full_default_params(), pcm) == 0
    fp, emb = cli.print_emb_enc(), cli.get_emb_enc()
    cli.close()
    ctx = _local(model_bytes, pcm)
    assert fp == ctx.print_emb_enc()
    np.testing.assert_allclose(emb, ctx.state.embd_enc.numpy(), atol=CROSS_ATOL, rtol=0)


def test_jax_client_against_port_server(server, model_bytes, pcm):
    """The JAX package's client drives the port's server (its ContextParams
    carries fused_mel, which the port's has not: the server drops it)."""
    from qwen2_audio_tpu.runtime import WhisperContext as JWhisperContext
    from qwen2_audio_tpu.runtime import full_default_params as jfull_default_params
    cli = jrpc.RemoteWhisperContext.connect(f"127.0.0.1:{server.port}")
    cli.load_model_bytes(model_bytes, JContextParams(use_gpu=False))
    assert cli.full(jfull_default_params(), pcm) == 0
    fp, emb = cli.print_emb_enc(), cli.get_emb_enc()
    cli.close()
    ref = JWhisperContext.init_from_buffer_with_params(model_bytes, JContextParams())
    assert ref.full(jfull_default_params(), pcm) == 0
    assert fp == ref.print_emb_enc()
    want = np.asarray(ref.state.embd_enc)
    np.testing.assert_allclose(emb.reshape(want.shape), want, atol=CROSS_ATOL, rtol=0)
    np.testing.assert_array_equal(emb, _local(model_bytes, pcm).state.embd_enc)


def test_rpc_native_cpp_client(cpu_server, model_bytes, tmp_path, tmp_path_factory):
    """native/qa_rpc (the C++ client, which sends no context parameters)
    against the port's -ng server: its fingerprint line is the Python
    client's."""
    bin_path = native_build(tmp_path_factory) / "qa_rpc"
    model = tmp_path / "model.bin"
    model.write_bytes(model_bytes)
    wav = tmp_path / "in.wav"
    t = np.arange(16000 * 2) / 16000.0
    write_wav(str(wav), (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    r = subprocess.run([str(bin_path), f"127.0.0.1:{cpu_server.port}", str(model), str(wav)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    native_fp = r.stdout.strip()
    # both sides must see the identical samples: the wav stores int16 PCM
    wav_pcm, _ = read_wav(str(wav))
    cli = RemoteWhisperContext.connect(f"127.0.0.1:{cpu_server.port}")
    cli.load_model_bytes(model_bytes, CPU)
    assert cli.full(full_default_params(), wav_pcm) == 0
    assert native_fp == cli.print_emb_enc().strip() and len(native_fp.split()) == 20
    cli.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_rpc_server_process_and_shutdown(model_bytes, pcm):
    """``python -m qwen2_audio_tpu_torch.runtime.rpc -ng`` as its own
    process: it serves a full() and exits on CMD_SHUTDOWN."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-m", "qwen2_audio_tpu_torch.runtime.rpc",
                             "--host", "127.0.0.1", "--port", str(port), "-ng"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                cli = RemoteWhisperContext.connect(f"127.0.0.1:{port}", timeout_s=5)
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, \
                    proc.stderr.read().decode()[-2000:]
                time.sleep(0.2)
        assert cli.server_backend == "cpu"
        cli.load_model_bytes(model_bytes, ContextParams())
        assert cli.full(full_default_params(), pcm) == 0
        np.testing.assert_array_equal(cli.get_emb_enc(), _local(model_bytes, pcm).state.embd_enc)
        cli.close(shutdown_server=True)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
