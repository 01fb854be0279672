"""Remote offload over TCP — the analog of ggml's RPC backend, on the card.

The reference ships a TCP remote backend (ggml/src/ggml-rpc.cpp): a
client-side proxy backend serializes buffer ops and whole graphs
(`rpc_tensor`, command enum :84-96, length-prefixed frames sent by
send_rpc_cmd :255) to a server that executes them on any local backend
(GRAPH_COMPUTE :627).

Here the unit of remote execution is the model runtime itself: the server
owns `WhisperContext`s (weights resident on the card, CUDA graphs captured
once and replayed across requests) and executes API-level commands; the
client is a same-surface proxy (`RemoteWhisperContext`), as the
reference's client is a same-surface `ggml_backend_t`. The framing mirrors
ggml-rpc: one command byte + u64-length-prefixed payload per request, a
status byte + u64-length-prefixed payload per response. A payload is a
u32-length JSON header (the command's fields and a dtype/shape manifest)
followed by the raw little-endian bytes of its arrays.

The wire protocol is the JAX package's byte for byte (the magic, the
version, the command and status numbers, the frames, the payloads), so
either package's client, and native/qa_rpc_client.cpp, talks to either
package's server.

Contexts follow the client's ContextParams: ``use_gpu`` (the default) puts
a context on ``cuda:{gpu_device}``, ``use_gpu=False`` on the CPU. A server
started with ``-ng`` (``RpcServer(use_gpu=False)``) puts every context on
the CPU whatever the client sends. Fields the port's ContextParams lacks
(the JAX package's ``fused_mel``) are dropped, and so are the callbacks and
``compute_dtype``, which cannot cross the socket: the server computes in
its float32 default. Commands run one at a time under the server's lock,
each under its context's device and that device's default stream (a
connection's thread starts on device 0 and its own current stream).

Limitations mirroring the reference: callbacks (abort/progress/segment)
cannot cross the socket and are ignored remotely; ggml-rpc likewise never
forwards ggml's abort_callback to the server.

Server:  python -m qwen2_audio_tpu_torch.runtime.rpc --host 0.0.0.0 --port 50052 [-ng]
Client:  ctx = RemoteWhisperContext.connect("host:50052")
         ctx.load_model_file("model.bin"); ctx.full(params, pcm)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import socket
import struct
import threading
from typing import Any

import numpy as np

from qwen2_audio_tpu_torch.utils.logging import log_error, log_info

RPC_MAGIC = b"QARP"
RPC_VERSION = 1

# command enum (≙ rpc_cmd, ggml-rpc.cpp:84-96, at the runtime altitude)
CMD_HELLO = 0
CMD_LOAD_MODEL = 1
CMD_FULL = 2
CMD_ENCODE = 3
CMD_GET_EMB_ENC = 4
CMD_GET_SEGMENTS = 5
CMD_GET_LOGITS = 6
CMD_FREE = 7
CMD_SYSTEM_INFO = 8
CMD_SHUTDOWN = 9

STATUS_OK = 0
STATUS_ERR = 1

_MAX_PAYLOAD = 1 << 34          # 16 GiB guard against corrupt frames


# --------------------------------------------------------------------------- #
# framing (≙ send_rpc_cmd / recv_msg, ggml-rpc.cpp:255-306)
# --------------------------------------------------------------------------- #

def _send_frame(sock: socket.socket, tag: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<BQ", tag, len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    tag, ln = struct.unpack("<BQ", _recv_exact(sock, 9))
    if ln > _MAX_PAYLOAD:
        raise ConnectionError(f"oversized frame ({ln} bytes)")
    return tag, _recv_exact(sock, ln)


def _pack_json_arrays(meta: dict, arrays: list[np.ndarray]) -> bytes:
    """One payload = JSON header (with per-array dtype/shape manifest) +
    concatenated raw little-endian array bytes."""
    manifest = [{"dtype": str(a.dtype), "shape": list(a.shape)}
                for a in arrays]
    head = json.dumps({"meta": meta, "arrays": manifest}).encode()
    parts = [struct.pack("<I", len(head)), head]
    parts += [np.ascontiguousarray(a).tobytes() for a in arrays]
    return b"".join(parts)


def _unpack_json_arrays(payload: bytes) -> tuple[dict, list[np.ndarray]]:
    (hlen,) = struct.unpack_from("<I", payload, 0)
    head = json.loads(payload[4:4 + hlen].decode())
    arrays = []
    off = 4 + hlen
    for m in head["arrays"]:
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] else 1
        a = np.frombuffer(payload, dtype=dt, count=count, offset=off)
        arrays.append(a.reshape(m["shape"]))
        off += dt.itemsize * count
    return head["meta"], arrays


_SKIP_FIELDS = {"new_segment_callback", "progress_callback",
                "encoder_begin_callback", "abort_callback",
                "compute_dtype"}


def _sanitize(obj: Any) -> Any:
    """numpy and torch scalars, arrays and tensors (on any device) ->
    JSON-encodable python values."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if type(obj).__module__.startswith("torch") and hasattr(obj, "tolist"):
        return obj.detach().cpu().tolist()
    return obj


def _host_f32(x) -> np.ndarray:
    """A device tensor, a host array or None as a float32 host array (empty
    for None)."""
    if x is None:
        return np.zeros((0,), np.float32)
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _params_to_dict(p: Any) -> dict:
    out = {}
    for f in dataclasses.fields(p):
        if f.name in _SKIP_FIELDS:
            continue
        out[f.name] = getattr(p, f.name)
    return out


def _known_fields(cls, fields: dict) -> dict:
    """``fields`` without the names ``cls`` (a dataclass) lacks."""
    names = {f.name for f in dataclasses.fields(cls)} - _SKIP_FIELDS
    dropped = sorted(set(fields) - names)
    if dropped:
        log_info("rpc: %s fields not in this package dropped: %s\n",
                 cls.__name__, ", ".join(dropped))
    return {k: v for k, v in fields.items() if k in names}


def _device_scope(device):
    """Run under ``device`` and its default stream when it is a CUDA
    device; nothing to set for the CPU."""
    stack = contextlib.ExitStack()
    if device is not None and device.type == "cuda":
        import torch
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(torch.cuda.default_stream(device)))
    return stack


# --------------------------------------------------------------------------- #
# server
# --------------------------------------------------------------------------- #

class RpcServer:
    """Owns WhisperContexts; executes commands serially (one device program
    at a time) under a lock, like the reference server executes graphs on
    its single local backend. ``use_gpu=False`` (the command line's
    ``-ng``) puts every context on the CPU."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 use_gpu: bool = True):
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.5)
        self.host, self.port = self._sock.getsockname()[:2]
        self.use_gpu = use_gpu
        self._contexts: dict[int, Any] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def serve_forever(self) -> None:
        log_info("rpc: serving on %s:%d\n", self.host, self.port)
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn, addr),
                                 daemon=True)
            t.start()
        self._sock.close()

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- per-connection loop --------------------------------------------------
    def _serve_conn(self, conn: socket.socket, addr) -> None:
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        cmd, payload = _recv_frame(conn)
                    except (ConnectionError, OSError):
                        return
                    if cmd == CMD_SHUTDOWN:
                        _send_frame(conn, STATUS_OK, b"")
                        self._stop.set()
                        return
                    try:
                        resp = self._dispatch(cmd, payload)
                        _send_frame(conn, STATUS_OK, resp)
                    except Exception as e:  # noqa: BLE001 — reported to peer
                        log_error("rpc: cmd %d failed: %s\n", cmd, e)
                        _send_frame(conn, STATUS_ERR, str(e).encode())
        except Exception as e:  # noqa: BLE001
            log_error("rpc: connection %s died: %s\n", addr, e)

    def _backend(self) -> tuple[str, list[str]]:
        """Where this server's contexts run by default, and the devices."""
        import torch
        if self.use_gpu and torch.cuda.is_available():
            return "cuda", [torch.cuda.get_device_name(i)
                            for i in range(torch.cuda.device_count())]
        return "cpu", ["cpu"]

    # -- command handlers ------------------------------------------------------
    def _dispatch(self, cmd: int, payload: bytes) -> bytes:
        with self._lock:
            if cmd == CMD_HELLO:
                meta, _ = _unpack_json_arrays(payload)
                if meta.get("magic") != RPC_MAGIC.decode() \
                        or meta.get("version") != RPC_VERSION:
                    raise ValueError("rpc version mismatch")
                backend, devices = self._backend()
                return _pack_json_arrays(
                    {"version": RPC_VERSION, "backend": backend,
                     "devices": devices}, [])
            if cmd == CMD_LOAD_MODEL:
                return self._load_model(payload)
            if cmd == CMD_SYSTEM_INFO:
                from qwen2_audio_tpu_torch.runtime.context import print_system_info
                return _pack_json_arrays({"info": print_system_info()}, [])
            meta, arrays = _unpack_json_arrays(payload)
            if cmd == CMD_FREE:
                ctx = self._contexts.pop(meta["ctx_id"], None)
                if ctx is not None:
                    with _device_scope(ctx.device):
                        ctx.free()
                return _pack_json_arrays({}, [])
            if cmd not in (CMD_FULL, CMD_ENCODE, CMD_GET_EMB_ENC,
                           CMD_GET_SEGMENTS, CMD_GET_LOGITS):
                raise ValueError(f"unknown rpc command {cmd}")
            ctx = self._contexts[meta["ctx_id"]]
            with _device_scope(ctx.device):
                if cmd == CMD_FULL:
                    return self._full(ctx, meta, arrays)
                if cmd == CMD_ENCODE:
                    rc = ctx.encode(meta.get("offset", 0), meta.get("audio_ctx", 0))
                    return _pack_json_arrays({"rc": int(rc)}, [])
                if cmd == CMD_GET_EMB_ENC:
                    from qwen2_audio_tpu_torch.models.encoder import fingerprint
                    emb = ctx.state.embd_enc
                    fp = fingerprint(emb) if emb is not None else ""
                    return _pack_json_arrays({"fingerprint": fp}, [_host_f32(emb)])
                if cmd == CMD_GET_SEGMENTS:
                    return _pack_json_arrays(
                        {"segments": _sanitize(ctx.state.segments)}, [])
                return _pack_json_arrays({}, [_host_f32(ctx.get_logits())])

    def _load_model(self, payload: bytes) -> bytes:
        from qwen2_audio_tpu_torch.runtime.context import (ContextParams,
                                                           WhisperContext)
        meta, arrays = _unpack_json_arrays(payload)
        cp = ContextParams(**_known_fields(ContextParams, meta.get("cparams", {})))
        if not self.use_gpu:
            cp.use_gpu = False
        import torch
        # without a card, WhisperContext refuses use_gpu with its own error
        device = (torch.device("cuda", cp.gpu_device)
                  if cp.use_gpu and torch.cuda.is_available() else None)
        with _device_scope(device):
            ctx = WhisperContext.init_from_buffer_with_params(arrays[0].tobytes(), cp)
        ctx_id = self._next_id
        self._next_id += 1
        self._contexts[ctx_id] = ctx
        return _pack_json_arrays(
            {"ctx_id": ctx_id, "n_vocab": ctx.n_vocab(),
             "n_audio_ctx": ctx.n_audio_ctx()}, [])

    def _full(self, ctx, meta: dict, arrays: list[np.ndarray]) -> bytes:
        from qwen2_audio_tpu_torch.runtime.context import FullParams
        fp = FullParams(**_known_fields(FullParams, meta.get("fparams", {})))
        rc = ctx.full(fp, arrays[0].astype(np.float32))
        return _pack_json_arrays(
            {"rc": int(rc), "segments": _sanitize(ctx.state.segments)}, [])


# --------------------------------------------------------------------------- #
# client
# --------------------------------------------------------------------------- #

class RpcError(RuntimeError):
    pass


class RemoteWhisperContext:
    """Client proxy with the WhisperContext surface used by the CLI —
    ≙ the reference's client-side proxy backend
    (ggml_backend_rpc_init, ggml-rpc.cpp)."""

    class _StateView:
        """Duck-types WhisperState for CLI/output-format consumers."""

        def __init__(self, owner: "RemoteWhisperContext"):
            self._owner = owner

        @property
        def segments(self) -> list[dict]:
            return self._owner.segments

    def __init__(self, sock: socket.socket, server_info: dict):
        self._sock = sock
        self._info = server_info
        self._ctx_id: int | None = None
        self.segments: list[dict] = []   # same dict schema as WhisperState
        self.state = RemoteWhisperContext._StateView(self)
        self.decoder = None              # decoder attach is local-only

    # -- connection ----------------------------------------------------------
    @classmethod
    def connect(cls, endpoint: str, timeout_s: float = 30.0
                ) -> "RemoteWhisperContext":
        host, _, port = endpoint.rpartition(":")
        sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                        timeout=timeout_s)
        sock.settimeout(None)   # a model load / first capture can take minutes
        try:
            _send_frame(sock, CMD_HELLO, _pack_json_arrays(
                {"magic": RPC_MAGIC.decode(), "version": RPC_VERSION}, []))
            info, _ = cls._recv(sock)
        except BaseException:
            sock.close()
            raise
        return cls(sock, info)

    @staticmethod
    def _recv(sock) -> tuple[dict, list[np.ndarray]]:
        status, payload = _recv_frame(sock)
        if status != STATUS_OK:
            raise RpcError(payload.decode(errors="replace"))
        return _unpack_json_arrays(payload)

    def _call(self, cmd: int, meta: dict, arrays: list[np.ndarray] = ()
              ) -> tuple[dict, list[np.ndarray]]:
        _send_frame(self._sock, cmd, _pack_json_arrays(meta, list(arrays)))
        return self._recv(self._sock)

    # -- API surface ----------------------------------------------------------
    @property
    def server_backend(self) -> str:
        """``cuda`` or ``cpu`` from this package's server (the JAX server
        names its JAX backend)."""
        return self._info.get("backend", "?")

    @property
    def server_devices(self) -> list[str]:
        return list(self._info.get("devices", []))

    def load_model_bytes(self, model: bytes, cparams: Any = None) -> None:
        meta = {"cparams": _params_to_dict(cparams) if cparams else {}}
        resp, _ = self._call(CMD_LOAD_MODEL, meta,
                             [np.frombuffer(model, np.uint8)])
        self._ctx_id = resp["ctx_id"]

    def load_model_file(self, path: str, cparams: Any = None) -> None:
        with open(path, "rb") as f:
            self.load_model_bytes(f.read(), cparams)

    def full(self, params: Any, samples: np.ndarray) -> int:
        resp, _ = self._call(
            CMD_FULL,
            {"ctx_id": self._require(), "fparams": _params_to_dict(params)},
            [np.asarray(samples, np.float32)])
        self.segments = resp["segments"]
        return resp["rc"]

    def full_parallel(self, params: Any, samples: np.ndarray,
                      n_processors: int) -> int:
        """The proxy forwards a plain full(): the wire has no chunked
        command."""
        return self.full(params, samples)

    def encode(self, offset: int = 0, audio_ctx: int = 0) -> int:
        resp, _ = self._call(CMD_ENCODE, {"ctx_id": self._require(),
                                          "offset": offset,
                                          "audio_ctx": audio_ctx})
        return resp["rc"]

    def get_emb_enc(self) -> np.ndarray:
        _, arrays = self._call(CMD_GET_EMB_ENC,
                               {"ctx_id": self._require()})
        return arrays[0]

    def print_emb_enc(self) -> str:
        """Prints the server's fingerprint line and returns it, as
        WhisperContext.print_emb_enc does."""
        resp, _ = self._call(CMD_GET_EMB_ENC, {"ctx_id": self._require()})
        print(resp["fingerprint"], flush=True)
        return resp["fingerprint"]

    def get_logits(self) -> np.ndarray:
        _, arrays = self._call(CMD_GET_LOGITS, {"ctx_id": self._require()})
        return arrays[0]

    def full_n_segments(self) -> int:
        return len(self.segments)

    def full_get_segment_text(self, i: int) -> str:
        return self.segments[i]["text"]

    def system_info(self) -> str:
        resp, _ = self._call(CMD_SYSTEM_INFO, {})
        return resp["info"]

    def print_timings(self) -> None:
        """The phase timings stay on the server; the wire has no command
        for them."""
        log_info("rpc: timings are kept by the server\n")

    def free(self) -> None:
        if self._ctx_id is not None:
            self._call(CMD_FREE, {"ctx_id": self._ctx_id})
            self._ctx_id = None

    def close(self, shutdown_server: bool = False) -> None:
        try:
            self.free()
            if shutdown_server:
                _send_frame(self._sock, CMD_SHUTDOWN,
                            _pack_json_arrays({}, []))
                _recv_frame(self._sock)
        finally:
            self._sock.close()

    def _require(self) -> int:
        if self._ctx_id is None:
            raise RpcError("no model loaded (call load_model_* first)")
        return self._ctx_id


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="qwen2-audio-tpu-torch RPC server "
                                             "(≙ ggml-rpc server role)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=50052)
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run every context on the CPU, whatever the client asks")
    args = ap.parse_args(argv)
    srv = RpcServer(args.host, args.port, use_gpu=not args.no_gpu)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
