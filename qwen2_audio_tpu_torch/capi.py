"""Drop-in function-style API mirroring include/qwen2-whisper.h:141-527: every
public symbol of the reference C API has a same-named Python function here
operating on WhisperContext / WhisperState (init from a file, a buffer or a
loader, with and without state; mel, encode, full, full_parallel; the
tokenizer; the model, token and segment accessors; logits; timings, system
info, logging; the benches). Contexts run on the card unless their
ContextParams ask for the CPU (``use_gpu=False``).
"""

from __future__ import annotations

import numpy as np

from qwen2_audio_tpu_torch import lang as _lang
from qwen2_audio_tpu_torch.runtime.context import (
    ContextParams,
    FullParams,
    WhisperContext,
    WhisperState,
    context_default_params,
    full_default_params,
    print_system_info,
)
from qwen2_audio_tpu_torch.utils.logging import log_error
from qwen2_audio_tpu_torch.utils.logging import log_set as _log_set

# ---- init / free (header :141-205) ----


def whisper_init_from_file_with_params(path_model: str,
                                       params: ContextParams | None = None):
    return WhisperContext.init_from_file_with_params(path_model, params)


def whisper_init_from_buffer_with_params(buffer: bytes,
                                         params: ContextParams | None = None):
    return WhisperContext.init_from_buffer_with_params(buffer, params)


def whisper_init_from_file_with_params_no_state(path_model: str,
                                                params: ContextParams | None = None):
    return WhisperContext.init_from_file_with_params_no_state(path_model, params)


def whisper_init_from_buffer_with_params_no_state(buffer: bytes,
                                                  params: ContextParams | None = None):
    return WhisperContext.init_from_buffer_with_params_no_state(buffer, params)


def whisper_init_with_params(loader, params: ContextParams | None = None):
    """loader = whisper_model_loader vtable (header :128-136): an object
    with read(n)/eof()/close()."""
    return WhisperContext.init_with_params(loader, params)


def whisper_init_with_params_no_state(loader, params: ContextParams | None = None):
    return WhisperContext.init_with_params(loader, params, with_state=False)


def whisper_init_state(ctx: WhisperContext) -> WhisperState:
    return ctx.init_state()


def whisper_free(ctx: WhisperContext) -> None:
    ctx.free()


def whisper_free_state(state: WhisperState) -> None:
    pass   # garbage collected


def whisper_free_params(params) -> None:
    pass


def whisper_free_context_params(params) -> None:
    pass


def whisper_context_default_params() -> ContextParams:
    return context_default_params()


def whisper_context_default_params_by_ref() -> ContextParams:
    return context_default_params()


# ---- mel / encode (header :208-258) ----

def whisper_pcm_to_mel(ctx, samples, n_samples=None, n_threads=4) -> int:
    return ctx.pcm_to_mel(np.asarray(samples, np.float32), n_threads)


def whisper_pcm_to_mel_with_state(ctx, state, samples, n_samples=None,
                                  n_threads=4) -> int:
    return ctx.pcm_to_mel_with_state(state, np.asarray(samples, np.float32),
                                     n_threads)


def whisper_set_mel(ctx, data, n_len=None, n_mel=None) -> int:
    return ctx.set_mel(np.asarray(data, np.float32))


def whisper_set_mel_with_state(ctx, state, data, n_len=None, n_mel=None) -> int:
    return ctx.set_mel_with_state(state, np.asarray(data, np.float32))


def whisper_encode(ctx, offset: int = 0, n_threads: int = 4) -> int:
    return ctx.encode(offset)


def whisper_encode_with_state(ctx, state, offset: int = 0,
                              n_threads: int = 4) -> int:
    return ctx.encode_with_state(state, offset)


# ---- tokenization (header :260-279) ----

def whisper_tokenize(ctx, text: str, tokens=None, n_max_tokens=None):
    """The token ids of ``text``; -(their number) when it is past
    ``n_max_tokens``, as the C function reports a short buffer."""
    ids = ctx.tokenize(text)
    if n_max_tokens is not None and len(ids) > n_max_tokens:
        return -len(ids)
    return ids


def whisper_token_count(ctx, text: str) -> int:
    return ctx.token_count(text)


# ---- languages (header :281-295) ----

whisper_lang_max_id = _lang.lang_max_id
whisper_lang_id = _lang.lang_id
whisper_lang_str = _lang.lang_str
whisper_lang_str_full = _lang.lang_str_full


# ---- full (header :359-471) ----

def whisper_full_default_params(strategy: str = "greedy") -> FullParams:
    return full_default_params(strategy)


def whisper_full(ctx, params: FullParams, samples, n_samples=None) -> int:
    return ctx.full(params, np.asarray(samples, np.float32))


def whisper_full_with_state(ctx, state, params, samples, n_samples=None) -> int:
    return ctx.full_with_state(state, params, np.asarray(samples, np.float32))


def whisper_full_parallel(ctx, params, samples, n_samples=None, n_processors: int = 1) -> int:
    return ctx.full_parallel(params, np.asarray(samples, np.float32), n_processors)


# ---- accessors, timings, debug (header :296-357, :517-527) ----

def whisper_get_logits(ctx): return ctx.get_logits()
def whisper_get_logits_from_state(state): return state.logits


def whisper_n_len(ctx) -> int: return ctx.n_len()
def whisper_n_len_from_state(state) -> int:
    return state.mel.n_len_org if state.mel else 0
def whisper_n_vocab(ctx) -> int: return ctx.n_vocab()
def whisper_n_text_ctx(ctx) -> int: return ctx.n_text_ctx()
def whisper_n_audio_ctx(ctx) -> int: return ctx.n_audio_ctx()
def whisper_is_multilingual(ctx) -> int: return int(ctx.is_multilingual())

def whisper_model_n_vocab(ctx) -> int: return ctx.hparams.n_vocab
def whisper_model_n_audio_ctx(ctx) -> int: return ctx.hparams.n_audio_ctx
def whisper_model_n_audio_state(ctx) -> int: return ctx.hparams.n_audio_state
def whisper_model_n_audio_head(ctx) -> int: return ctx.hparams.n_audio_head
def whisper_model_n_audio_layer(ctx) -> int: return ctx.hparams.n_audio_layer
def whisper_model_n_text_ctx(ctx) -> int: return ctx.hparams.n_text_ctx
def whisper_model_n_text_state(ctx) -> int: return ctx.hparams.n_text_state
def whisper_model_n_text_head(ctx) -> int: return ctx.hparams.n_text_head
def whisper_model_n_text_layer(ctx) -> int: return ctx.hparams.n_text_layer
def whisper_model_n_mels(ctx) -> int: return ctx.hparams.n_mels
def whisper_model_ftype(ctx) -> int: return ctx.hparams.ftype
def whisper_model_type(ctx) -> int: return 0
def whisper_model_type_readable(ctx) -> str: return ctx.model_type_readable()

def whisper_token_to_str(ctx, token: int) -> str:
    return ctx.token_to_str(token)

def whisper_token_eot(ctx) -> int: return ctx.token_eot()
def whisper_token_sot(ctx) -> int: return ctx.token_sot()
def whisper_token_solm(ctx) -> int: return ctx.token_solm()
def whisper_token_prev(ctx) -> int: return ctx.token_prev()
def whisper_token_nosp(ctx) -> int: return ctx.token_nosp()
def whisper_token_not(ctx) -> int: return ctx.token_not()
def whisper_token_beg(ctx) -> int: return ctx.token_beg()
def whisper_token_lang(ctx, lang_id: int) -> int: return ctx.token_lang(lang_id)
def whisper_token_translate(ctx) -> int: return ctx.token_translate()
def whisper_token_transcribe(ctx) -> int: return ctx.token_transcribe()


def whisper_print_timings(ctx) -> None: ctx.print_timings()
def whisper_reset_timings(ctx) -> None: ctx.reset_timings()
def whisper_print_system_info() -> str: return print_system_info()


def whisper_print_emb_enc(ctx) -> None:
    ctx.print_emb_enc()


# ---- segment accessors (header :472-515) ----

def whisper_full_n_segments(ctx) -> int: return ctx.full_n_segments()
def whisper_full_n_segments_from_state(state) -> int:
    return len(state.segments)
def whisper_full_lang_id(ctx) -> int: return ctx.full_lang_id()
def whisper_full_lang_id_from_state(state) -> int: return state.lang_id
def whisper_full_get_segment_t0(ctx, i) -> int:
    return ctx.full_get_segment_t0(i)
def whisper_full_get_segment_t1(ctx, i) -> int:
    return ctx.full_get_segment_t1(i)
def whisper_full_get_segment_speaker_turn_next(ctx, i) -> bool:
    return ctx.state.segments[i]["speaker_turn_next"]
def whisper_full_get_segment_text(ctx, i) -> str:
    return ctx.full_get_segment_text(i)
def whisper_full_n_tokens(ctx, i) -> int: return ctx.full_n_tokens(i)
def whisper_full_get_token_text(ctx, i, j) -> str:
    return ctx.full_get_token_text(i, j)
def whisper_full_get_token_id(ctx, i, j) -> int:
    return ctx.full_get_token_id(i, j)
def whisper_full_get_token_p(ctx, i, j) -> float:
    return ctx.full_get_token_p(i, j)


# from-state segment accessors (header :484-515)
def whisper_full_get_segment_t0_from_state(state, i) -> int:
    return state.segments[i]["t0"]
def whisper_full_get_segment_t1_from_state(state, i) -> int:
    return state.segments[i]["t1"]
def whisper_full_get_segment_speaker_turn_next_from_state(state, i) -> bool:
    return state.segments[i]["speaker_turn_next"]
def whisper_full_get_segment_text_from_state(state, i) -> str:
    return state.segments[i]["text"]
def whisper_full_n_tokens_from_state(state, i) -> int:
    return len(state.segments[i]["tokens"])
def whisper_full_get_token_id_from_state(state, i, j) -> int:
    return state.segments[i]["tokens"][j]
def whisper_full_get_token_text_from_state(ctx, state, i, j) -> str:
    return ctx.token_to_str(state.segments[i]["tokens"][j])
def whisper_full_get_token_p_from_state(state, i, j) -> float:
    return state.segments[i]["probs"][j]


# deprecated init aliases (header :151-174), the header's WHISPER_DEPRECATED block
def whisper_init_from_file(path_model: str):
    return whisper_init_from_file_with_params(path_model)


def whisper_init_from_buffer(buf: bytes):
    return whisper_init_from_buffer_with_params(buf)


def whisper_init(loader):
    return whisper_init_with_params(loader)


def whisper_init_from_file_no_state(path_model: str):
    return whisper_init_from_file_with_params_no_state(path_model)


def whisper_init_from_buffer_no_state(buf: bytes):
    return whisper_init_from_buffer_with_params_no_state(buf)


def whisper_init_no_state(loader):
    return whisper_init_with_params_no_state(loader)


# OpenVINO encoder hooks (header :183-199): the reference's external
# Intel-GPU encoder. This build has none, so they answer as the reference
# built without WHISPER_OPENVINO does: log and return failure.
def whisper_ctx_init_openvino_encoder_with_state(ctx, state, model_path,
                                                 device, cache_dir) -> int:
    log_error("whisper_ctx_init_openvino_encoder is not supported on this "
              "build: the encoder runs on the CUDA device or the CPU (as the "
              "reference compiled without WHISPER_OPENVINO)\n")
    return 1


def whisper_ctx_init_openvino_encoder(ctx, model_path, device, cache_dir) -> int:
    return whisper_ctx_init_openvino_encoder_with_state(
        ctx, None, model_path, device, cache_dir)


# for a C shim: samples arrive as a raw little-endian f32 byte buffer (one
# allocation instead of ~480k boxed floats per 30 s clip)
def _full_from_bytes(ctx, data: bytes) -> int:
    samples = np.frombuffer(data, dtype="<f4")
    return ctx.full(full_default_params(), samples)


def _pcm_to_mel_from_bytes(ctx, data: bytes) -> int:
    return ctx.pcm_to_mel(np.frombuffer(data, dtype="<f4"))


# ---- benches / logging (header :517-527) ----

def whisper_bench_memcpy(n_threads: int = 1) -> int:
    print(whisper_bench_memcpy_str(n_threads))
    return 0


def whisper_bench_memcpy_str(n_threads: int = 1) -> str:
    """Host memcpy rate (native.py; its numpy copy where the native library
    is not built)."""
    from qwen2_audio_tpu_torch.native import bench_memcpy_gbps
    gbps = bench_memcpy_gbps(1 << 28, n_threads)
    return f"memcpy: {gbps:7.2f} GB/s ({n_threads} thread(s))\n"


def whisper_bench_ggml_mul_mat(n_threads: int = 1, use_gpu: bool = True) -> int:
    print(whisper_bench_ggml_mul_mat_str(n_threads, use_gpu=use_gpu))
    return 0


def whisper_bench_ggml_mul_mat_str(n_threads: int = 1, use_gpu: bool = True,
                                   sizes=(512, 1024, 2048), check=None) -> str:
    """GFLOPS of N x N x N products per format (utils/bench_utils.py) on the
    card, or with ``use_gpu=False`` through the plain versions on the CPU.
    ``check(case, product, plain_product)`` sees each kernel case's first
    product beside its plain version before the case is timed."""
    from qwen2_audio_tpu_torch.utils.bench_utils import bench_device, mul_mat_bench_str
    return mul_mat_bench_str(sizes, device=bench_device(use_gpu), check=check)


def whisper_log_set(callback, user_data=None) -> None:
    _log_set(callback, user_data)
