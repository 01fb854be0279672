"""Function-style API mirroring include/qwen2-whisper.h: init (file, buffer,
loader; with and without state), mel, encode, full, full_parallel, the
segment and token accessors and logits of a decode, the embedding
fingerprint, timings and free. Tokenization and the rest of the header are not ported yet
(ROADMAP.md, section 1, item 12).
"""

from __future__ import annotations

import numpy as np

from qwen2_audio_tpu_torch.runtime.context import (
    ContextParams,
    FullParams,
    WhisperContext,
    WhisperState,
    context_default_params,
    full_default_params,
)

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


def whisper_init_state(ctx: WhisperContext) -> WhisperState:
    return ctx.init_state()


def whisper_free(ctx: WhisperContext) -> None:
    ctx.free()


def whisper_context_default_params() -> ContextParams:
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


def whisper_encode(ctx, offset: int = 0, n_threads: int = 4) -> int:
    return ctx.encode(offset)


def whisper_encode_with_state(ctx, state, offset: int = 0,
                              n_threads: int = 4) -> int:
    return ctx.encode_with_state(state, offset)


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
def whisper_n_vocab(ctx) -> int: return ctx.n_vocab()
def whisper_n_audio_ctx(ctx) -> int: return ctx.n_audio_ctx()
def whisper_model_n_mels(ctx) -> int: return ctx.hparams.n_mels
def whisper_model_type_readable(ctx) -> str: return ctx.model_type_readable()


def whisper_print_timings(ctx) -> None: ctx.print_timings()
def whisper_reset_timings(ctx) -> None: ctx.reset_timings()


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
