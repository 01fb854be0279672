"""The whole of the port's capi.py against the JAX package's on the CPU: every
top-level function of the JAX module exists in the port's (an AST check);
the accessors, init forms, tokenizer, state forms and hooks on one tiny
checkpoint, against the JAX context on the same bytes; and the mul_mat
bench's products (utils/bench_utils.py) at N = 64 against the JAX
``quant_linear`` / ``quant_linear_int8`` on the same weight.

Tolerance of the products (bf16 outputs): |port - JAX| <= 2**-7 * |JAX| +
2**-8 * max|JAX| elementwise: both round x and the dequantized weight (or
x's q8_1 form) the same way, the float32 sums run in another order, and the
last rounding to bf16 may fall either way; a wrong group, scale, nibble or
min term moves outputs by O(max)."""

import ast
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu import capi as jcapi
from qwen2_audio_tpu.audio import mel_filterbank
from qwen2_audio_tpu.config import GGMLType as JType
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.io import export as jexport
from qwen2_audio_tpu.models.encoder import random_encoder_params
from qwen2_audio_tpu.ops.quant_matmul import quant_linear as jquant_linear
from qwen2_audio_tpu.ops.quant_matmul_int8 import quant_linear_int8 as jquant_linear_int8
from qwen2_audio_tpu.quant.qparams import quantize_array_for_device as jquantize
from qwen2_audio_tpu_torch import capi as tcapi
from qwen2_audio_tpu_torch.runtime.context import ContextParams
from qwen2_audio_tpu_torch.utils import bench_utils
from qwen2_audio_tpu_torch.utils import logging as tlog

ROOT = Path(__file__).resolve().parents[1]
HP = dict(n_vocab=51865, n_audio_state=64, n_audio_head=4, n_audio_layer=2, n_mels=16)
VOCAB = [b"a", b"b", b"ab", b" the", b"hello", b" world", b"'s", b"!"]
CPU = ContextParams(use_gpu=False)


def _functions(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    return names | {t.id for n in tree.body if isinstance(n, ast.Assign)
                    for t in n.targets if isinstance(t, ast.Name)}


def test_every_jax_capi_function_is_ported():
    jax_fns = [n.name for n in ast.parse((ROOT / "qwen2_audio_tpu" / "capi.py").read_text()).body
               if isinstance(n, ast.FunctionDef)]
    assert len(jax_fns) == 96
    missing = sorted(_functions(ROOT / "qwen2_audio_tpu" / "capi.py")
                     - _functions(ROOT / "qwen2_audio_tpu_torch" / "capi.py"))
    assert missing == []


@pytest.fixture(scope="module")
def buffers():
    buf = io.BytesIO()
    params = random_encoder_params(np.random.default_rng(4), JHP(**HP))
    jexport.write_encoder_checkpoint(buf, params, JHP(**HP), mel_filterbank(16), VOCAB)
    return buf.getvalue()


@pytest.fixture(scope="module")
def contexts(buffers):
    return (jcapi.whisper_init_from_buffer_with_params(buffers),
            tcapi.whisper_init_from_buffer_with_params(buffers, CPU))


ACCESSORS = ["whisper_n_vocab", "whisper_n_text_ctx", "whisper_n_audio_ctx",
             "whisper_is_multilingual", "whisper_model_n_vocab", "whisper_model_n_audio_ctx",
             "whisper_model_n_audio_state", "whisper_model_n_audio_head",
             "whisper_model_n_audio_layer", "whisper_model_n_text_ctx",
             "whisper_model_n_text_state", "whisper_model_n_text_head",
             "whisper_model_n_text_layer", "whisper_model_n_mels", "whisper_model_ftype",
             "whisper_model_type", "whisper_model_type_readable", "whisper_token_eot",
             "whisper_token_sot", "whisper_token_solm", "whisper_token_prev",
             "whisper_token_nosp", "whisper_token_not", "whisper_token_beg",
             "whisper_token_translate", "whisper_token_transcribe"]


@pytest.mark.parametrize("name", ACCESSORS)
def test_accessors_match_jax(contexts, name):
    jctx, tctx = contexts
    assert getattr(tcapi, name)(tctx) == getattr(jcapi, name)(jctx)


def test_token_lookups_match_jax(contexts):
    jctx, tctx = contexts
    for lang in (0, 3, 98):
        assert tcapi.whisper_token_lang(tctx, lang) == jcapi.whisper_token_lang(jctx, lang)
    for tid in (0, 2, 7, 50257, 50258, 51864):
        assert tcapi.whisper_token_to_str(tctx, tid) == jcapi.whisper_token_to_str(jctx, tid)
    for code in ("en", "de", "yue", "klingon"):
        assert tcapi.whisper_lang_id(code) == jcapi.whisper_lang_id(code)
    assert tcapi.whisper_lang_max_id() == jcapi.whisper_lang_max_id()
    assert tcapi.whisper_lang_str_full(2) == jcapi.whisper_lang_str_full(2)


@pytest.mark.parametrize("text", ["hello world", "the world's ab!", "zzz", ""])
def test_tokenize_matches_jax(contexts, text):
    jctx, tctx = contexts
    ids = tcapi.whisper_tokenize(tctx, text)
    assert ids == jcapi.whisper_tokenize(jctx, text)
    assert tcapi.whisper_token_count(tctx, text) == jcapi.whisper_token_count(jctx, text)
    if len(ids) > 1:
        cut = len(ids) - 1
        assert tcapi.whisper_tokenize(tctx, text, n_max_tokens=cut) == -len(ids) == \
            jcapi.whisper_tokenize(jctx, text, n_max_tokens=cut)
        assert tcapi.whisper_tokenize(tctx, text, n_max_tokens=len(ids)) == ids


def test_init_forms(buffers, tmp_path):
    path = str(tmp_path / "m.bin")
    Path(path).write_bytes(buffers)

    class Loader:
        def __init__(self):
            self.pos, self.closed = 0, False

        def read(self, n):
            out = buffers[self.pos:self.pos + n]
            self.pos += len(out)
            return out

        def eof(self):
            return self.pos >= len(buffers)

        def close(self):
            self.closed = True

    ld = Loader()
    ctx = tcapi.whisper_init_with_params_no_state(ld, CPU)
    assert ld.closed and ctx.state is None
    assert tcapi.whisper_n_vocab(ctx) == HP["n_vocab"]
    st = tcapi.whisper_init_state(ctx)
    assert ctx.state is st and tcapi.whisper_n_len_from_state(st) == 0
    tcapi.whisper_free_state(st)
    # the deprecated forms run on the card by default: without one they raise
    if not torch.cuda.is_available():
        for fn, arg in ((tcapi.whisper_init_from_file, path),
                        (tcapi.whisper_init_from_buffer, buffers),
                        (tcapi.whisper_init_from_file_no_state, path),
                        (tcapi.whisper_init_from_buffer_no_state, buffers),
                        (tcapi.whisper_init, Loader()), (tcapi.whisper_init_no_state, Loader())):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(arg)
    p = tcapi.whisper_context_default_params_by_ref()
    assert p == tcapi.whisper_context_default_params() and p.use_gpu
    tcapi.whisper_free_context_params(p)
    tcapi.whisper_free_params(tcapi.whisper_full_default_params())


def test_state_forms_match_jax(contexts, buffers):
    jctx, tctx = contexts
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(32000) / 16000)).astype(np.float32)
    js, ts = jcapi.whisper_init_state(jctx), tcapi.whisper_init_state(tctx)
    mel = np.random.default_rng(7).standard_normal((16, 300)).astype(np.float32)
    assert tcapi.whisper_set_mel_with_state(tctx, ts, mel) == \
        jcapi.whisper_set_mel_with_state(jctx, js, mel) == 0
    assert tcapi.whisper_n_len_from_state(ts) == jcapi.whisper_n_len_from_state(js) == 300
    assert tcapi.whisper_set_mel_with_state(tctx, ts, mel[:8]) == -1
    assert tcapi._pcm_to_mel_from_bytes(tctx, x.tobytes()) == \
        jcapi._pcm_to_mel_from_bytes(jctx, x.tobytes()) == 0
    assert tcapi.whisper_n_len(tctx) == jcapi.whisper_n_len(jctx)
    assert tcapi._full_from_bytes(tctx, x.tobytes()) == jcapi._full_from_bytes(jctx, x.tobytes())
    np.testing.assert_allclose(tctx.state.embd_enc.numpy(), np.asarray(jctx.state.embd_enc),
                               atol=1e-4)


def test_openvino_hooks_and_logging(contexts):
    jctx, tctx = contexts
    seen = []
    tcapi.whisper_log_set(lambda level, text, ud: seen.append((level, text, ud)), "ud")
    try:
        assert tcapi.whisper_ctx_init_openvino_encoder(tctx, "m.xml", "GPU", None) == 1 == \
            jcapi.whisper_ctx_init_openvino_encoder(jctx, "m.xml", "GPU", None)
        assert tcapi.whisper_ctx_init_openvino_encoder_with_state(tctx, None, "m", "CPU", "") == 1
    finally:
        tcapi.whisper_log_set(None)
    assert len(seen) == 2 and seen[0][0] == tlog.LogLevel.ERROR and seen[0][2] == "ud"
    assert "WHISPER_OPENVINO" in seen[0][1]


def test_print_system_info():
    info = tcapi.whisper_print_system_info()
    assert info.startswith(f"torch {torch.__version__} | CUDA ")
    dev = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    assert f"| device {dev} |" in info and "_build" in info


def test_bench_memcpy_str():
    s = tcapi.whisper_bench_memcpy_str(2)
    assert s.startswith("memcpy: ") and s.endswith("GB/s (2 thread(s))\n")
    assert float(s.split()[1]) > 0


def _close_bf16(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.float().numpy()
    assert g.shape == want.shape
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * np.abs(want).max()
    assert (np.abs(g - want) <= tol).all(), np.abs(g - want).max()


@pytest.mark.parametrize("fmt", bench_utils.FORMATS)
def test_mul_mat_products_match_jax(fmt):
    n = 64
    cases = {c["type"]: c for c in bench_utils.mul_mat_cases(n, torch.device("cpu"))}
    assert list(cases) == list(bench_utils.FORMATS)
    case = cases[fmt]
    w, x = bench_utils.bench_arrays(n)
    got = case["fn"](case["x"])
    assert got.shape == (n, n)
    if case["entry"] is not None:   # on the CPU the wrapper is its plain version
        assert torch.equal(case["entry"](case["x"]), case["plain"](case["x"]))
    if fmt == "f32":
        np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)
        return
    jx = jnp.asarray(x, jnp.bfloat16)
    if fmt == "bf16":
        want = jx @ jnp.asarray(w, jnp.bfloat16)
    elif fmt == "q8_0i":
        want = jquant_linear_int8(jx, jquantize(w, JType.Q8_0))
    else:
        want = jquant_linear(jx, jquantize(w, JType[fmt.upper()]), fast=True)
    _close_bf16(got, want)


def test_mul_mat_bench_on_the_cpu():
    seen = []
    rows = bench_utils.mul_mat_bench((32,), device=torch.device("cpu"), chain=2,
                                     check=lambda case, y, p: seen.append(
                                         (case["type"], torch.equal(y, p))))
    assert [r["type"] for r in rows] == list(bench_utils.FORMATS)
    assert all(r["size"] == 32 and r["gflops"] > 0 for r in rows)
    assert seen == [(t, True) for t in bench_utils.FORMATS[2:]]
    s = tcapi.whisper_bench_ggml_mul_mat_str(use_gpu=False, sizes=(32,))
    assert s.count("GFLOPS") == len(bench_utils.FORMATS) and "q8_0i" in s
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="use_gpu=False"):
            tcapi.whisper_bench_ggml_mul_mat_str()
