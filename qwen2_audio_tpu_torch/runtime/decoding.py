"""Decoding engine: audio-conditioned Qwen2 generation with greedy (plain
or n-gram speculative) and beam-search strategies, the temperature
fallback, penalties, suppression masks, and DTW token timestamps with the
max_len segment splitting they drive.

Flow (HF Qwen2-Audio semantics):
    encoder output (750, 1280) --projector--> (750, D_text)
    prompt embeds = [pre-audio tokens][audio embeds][post-audio tokens]
    prefill -> greedy / beam decode over a static-shape KV cache.

``run`` is whisper_full()'s decode stage. It refuses detect_language and
translate with a logged error and a code (``_check_unsupported``), as the
JAX package does: the Qwen2 vocabulary has neither whisper token.
"""

from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Any, Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
from qwen2_audio_tpu_torch.models.dtw import token_timestamps_from_attention
from qwen2_audio_tpu_torch.models.qwen2_decoder import (Decoder, create_cache,
                                                        decoder_forward, embed_tokens)
from qwen2_audio_tpu_torch.runtime.generate import (GenerationResult, beam_search_device,
                                                    greedy_decode_device)
from qwen2_audio_tpu_torch.tokenizer import _NON_SPEECH
from qwen2_audio_tpu_torch.utils.logging import log_error, log_info, log_warn

# return codes of run() for the options this decoder refuses
ERR_DETECT_LANGUAGE = -6
ERR_TRANSLATE = -7


@dataclasses.dataclass
class DecoderBundle:
    """Everything the runtime needs to decode text from audio embeddings;
    attached to WhisperContext.decoder."""

    cfg: Qwen2DecoderConfig
    decoder: Decoder                     # the Qwen2 LM and its weights
    proj_w: torch.Tensor                 # (enc_dim, hidden)
    proj_b: torch.Tensor                 # (hidden,)
    eos_token_id: int
    bos_tokens: list[int]                # tokens before the audio embeds
    post_audio_tokens: list[int]         # tokens after the audio embeds
    detokenize: Callable[[list[int]], str] | None = None
    max_ctx: int = 2048
    cache_dtype: Any = torch.bfloat16    # or "q8" for the int8 cache
    # optional id -> surface string map used to build suppression masks
    # (suppress_regex / suppress_non_speech_tokens, header :394-408)
    token_strings: Callable[[int], str] | None = None
    # optional text -> ids encoder (for FullParams.initial_prompt)
    tokenize: Callable[[str], list] | None = None
    # optional id -> raw UTF-8 bytes
    token_bytes: Callable[[int], bytes] | None = None
    # memoized suppression masks, keyed by (suppress_regex, non_speech):
    # building one walks the whole vocab
    _suppress_cache: dict = dataclasses.field(default_factory=dict,
                                              repr=False, compare=False)

    @property
    def params(self) -> dict:
        return self.decoder.params

    @property
    def device(self) -> torch.device:
        return self.decoder.device

    def to(self, device: torch.device | str) -> "DecoderBundle":
        """Move the weights to ``device`` (in place) and return the bundle."""
        self.decoder.to(device)
        self.proj_w = self.proj_w.to(device)
        self.proj_b = self.proj_b.to(device)
        return self

    def project_audio(self, enc_out: torch.Tensor) -> torch.Tensor:
        """multi_modal_projector: Linear(enc_dim -> hidden) (HF
        Qwen2AudioMultiModalProjector), in the promoted type of its inputs."""
        x = torch.as_tensor(enc_out).to(self.proj_w.device)
        dt = torch.promote_types(x.dtype, self.proj_w.dtype)
        return x.to(dt) @ self.proj_w.to(dt) + self.proj_b.to(dt)

    def text(self, ids: list[int]) -> str:
        if self.detokenize is not None:
            return self.detokenize(ids)
        return " ".join(str(i) for i in ids)


def _token_entropy(ids: list[int], window: int = 32) -> float:
    """Shannon entropy (nats) of the trailing token-frequency distribution:
    whisper.cpp's whisper_sequence_score statistic over the last 32 tokens,
    the secondary degenerate-transcript guard (threshold entropy_thold)."""
    tail = ids[-window:]
    if not tail:
        return float("inf")
    _, counts = np.unique(np.asarray(tail), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum())


def _compression_ratio(text: str) -> float:
    """len(utf8) / len(zlib(utf8)) of the decoded text — OpenAI whisper's
    degenerate-output statistic (threshold compression_ratio_thold); short
    texts cannot exceed 2.4 (zlib's overhead)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def _surface_fn(bundle: DecoderBundle) -> Callable[[int], str] | None:
    return bundle.token_strings or (
        (lambda i: bundle.detokenize([i])) if bundle.detokenize else None)


def build_suppress_mask(bundle: DecoderBundle, params) -> np.ndarray | None:
    """(V,) additive logits mask (0 / -inf) from the whisper_full_params
    suppression knobs: suppress_regex (header :399) and the non-speech
    symbol list (:404-405, openai tokenizer.py set)."""
    want_regex = bool(params.suppress_regex)
    want_nonspeech = bool(params.suppress_non_speech_tokens)
    if not (want_regex or want_nonspeech):
        return None
    cache_key = (params.suppress_regex, want_nonspeech)
    if cache_key in bundle._suppress_cache:
        return bundle._suppress_cache[cache_key]
    to_str = _surface_fn(bundle)
    if to_str is None:
        return None
    pat = re.compile(params.suppress_regex) if want_regex else None
    mask = np.zeros(bundle.cfg.vocab_size, np.float32)
    for i in range(bundle.cfg.vocab_size):
        try:
            s = to_str(i)
        except Exception:
            continue
        if pat is not None and pat.search(s):
            mask[i] = -np.inf
        elif want_nonspeech and s.strip() and s.strip() in _NON_SPEECH:
            mask[i] = -np.inf
    bundle._suppress_cache[cache_key] = mask
    return mask


def build_blank_mask(bundle: DecoderBundle, params) -> np.ndarray | None:
    """(V,) additive step-0 mask for FullParams.suppress_blank (header
    :394-396): tokens whose surface is empty or whitespace, plus EOS, are
    -inf for the first generated token only."""
    if not params.suppress_blank:
        return None
    key = ("__blank__",)
    if key in bundle._suppress_cache:
        return bundle._suppress_cache[key]
    mask = np.zeros(bundle.cfg.vocab_size, np.float32)
    fast_done = False
    if bundle.token_bytes is not None:
        # raw byte surfaces need no per-token UTF-8 decode
        tb = bundle.token_bytes
        try:
            for i in range(bundle.cfg.vocab_size):
                b = tb(i)
                if b and not b.strip():
                    mask[i] = -np.inf
            fast_done = True
        except Exception:
            mask[:] = 0.0
    if not fast_done:
        to_str = _surface_fn(bundle)
        if to_str is None:
            return None
        for i in range(bundle.cfg.vocab_size):
            try:
                s = to_str(i)
            except Exception:
                continue
            if s != "" and s.strip() == "":
                mask[i] = -np.inf
    if 0 <= bundle.eos_token_id < mask.shape[0]:
        mask[bundle.eos_token_id] = -np.inf
    bundle._suppress_cache[key] = mask
    return mask


def _prefill_embeds(bundle: DecoderBundle, audio_embeds: torch.Tensor,
                    prompt_tokens: list[int]) -> torch.Tensor:
    """[bos][audio][post-audio + user prompt] -> (1, T, D)."""
    dev = bundle.device
    parts = []
    if bundle.bos_tokens:
        parts.append(embed_tokens(bundle.params, torch.tensor(bundle.bos_tokens, device=dev)))
    parts.append(audio_embeds.to(device=dev, dtype=parts[0].dtype if parts else torch.float32))
    tail = list(bundle.post_audio_tokens) + list(prompt_tokens or [])
    if tail:
        parts.append(embed_tokens(bundle.params, torch.tensor(tail, device=dev)))
    return torch.cat(parts, dim=0)[None]


def greedy_decode(
    bundle: DecoderBundle,
    prefill: torch.Tensor,               # (B, T0, D)
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    seed: int = 0,
    abort_callback: Callable | None = None,
    timings=None,
    suppress_mask: np.ndarray | None = None,
    suppress_first: np.ndarray | None = None,
) -> GenerationResult:
    """The JAX package's host loop, whose ``abort_callback`` can stop it
    between steps: here the one loop of runtime/generate.py."""
    return greedy_decode_device(
        bundle, prefill, max_new_tokens=max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, seed=seed,
        suppress_mask=suppress_mask, suppress_first=suppress_first,
        abort_callback=abort_callback, timings=timings)


def beam_search(
    bundle: DecoderBundle,
    prefill: torch.Tensor,               # (1, T0, D): one stream
    *,
    beam_size: int,
    max_new_tokens: int,
    length_penalty: float = -1.0,
    repetition_penalty: float = 1.0,
    abort_callback: Callable | None = None,
    timings=None,
    suppress_mask: np.ndarray | None = None,
    suppress_first: np.ndarray | None = None,
    capture: bool | None = None,
) -> GenerationResult:
    """The JAX package's host beam loop, whose ``abort_callback`` can stop
    it after every token: here the beam loop of runtime/generate.py with
    the done flags read after every step (eager with ``capture=False``, on
    the card captured by default). ``run`` calls ``beam_search_device``,
    which reads them after every step whenever an abort callback is set."""
    return beam_search_device(
        bundle, prefill, beam_size=beam_size, max_new_tokens=max_new_tokens,
        length_penalty=length_penalty, repetition_penalty=repetition_penalty,
        suppress_mask=suppress_mask, suppress_first=suppress_first,
        abort_callback=abort_callback, timings=timings, check_every=1, capture=capture)


@torch.no_grad()
def compute_token_timestamps(
    bundle: DecoderBundle,
    prefill: torch.Tensor,         # (1, T0, D): the decoded prompt's embeddings
    ids: list[int],                # generated tokens
    aud0: int,                     # first audio-embedding position of the block
    n_aud: int,                    # audio-embedding positions
    n_content: int,                # content positions (the rest is padding)
    n_top: int = -1,               # alignment heads: every head of the top n layers
    t_offset_cs: int = 0,
) -> list[int]:
    """Per-token start times (centiseconds) by DTW over decoder attention.

    One teacher-forced forward over [prompt; generated tokens], into a fresh
    cache of the sequence's length, taps each generated token's
    pre-softmax attention to the audio positions (the self-attention
    analogue of whisper.cpp's cross-attention recording,
    src/qwen2-whisper.cpp:4112-4184), through the plain attention as in
    the JAX package; models/dtw.py aligns. Encoder positions are 40 ms
    apart (stride 4 over 10 ms mel frames): 25 frames a second."""
    if not ids:
        return []
    cfg = bundle.cfg
    T0 = prefill.shape[1]
    gen = embed_tokens(bundle.params, torch.tensor([ids], device=prefill.device))
    x = torch.cat([prefill, gen.to(prefill.dtype)], dim=1)
    cache = create_cache(cfg, 1, x.shape[1], dtype=bundle.cache_dtype, device=x.device)
    _, _, taps = decoder_forward(bundle.params, cfg, x, cache, 0, block_only=True,
                                 logits_last_only=True, use_flash=False,
                                 attn_slice=(T0, len(ids), aud0, n_aud))
    taps = taps[:, 0]                                   # (L, Hq, n, n_aud)
    L = taps.shape[0]
    if n_top <= 0:
        n_top = max(1, L // 2)    # the WHISPER_AHEADS_N_TOP_MOST default
    heads = taps[L - min(n_top, L):].reshape(-1, len(ids), n_aud)
    times_s = token_timestamps_from_attention(heads, n_content, frames_per_second=25.0)
    return [t_offset_cs + int(round(t * 100.0)) for t in times_s]


def _token_surfaces(bundle: DecoderBundle, ids: list[int]) -> list[str]:
    to_str = _surface_fn(bundle)
    if to_str is None:
        return [f"<{i}>" for i in ids]
    out = []
    for i in ids:
        try:
            out.append(to_str(i))
        except Exception:
            out.append("")
    return out


def split_segment_by_length(bundle: DecoderBundle, ids: list[int],
                            lps: list[float], times_cs: list[int],
                            max_len: int, split_on_word: bool,
                            t1_cs: int) -> list[dict]:
    """whisper.cpp's max_len / split_on_word segment wrapping from token
    timestamps: tokens packed greedily until the surface text would pass
    max_len characters, splitting at word starts only with
    split_on_word."""
    surfaces = _token_surfaces(bundle, ids)
    groups: list[list[int]] = []
    cur: list[int] = []
    cur_len = 0
    for i, s in enumerate(surfaces):
        starts_word = s.startswith((" ", "\n")) or i == 0
        if cur and cur_len + len(s) > max_len and (starts_word or not split_on_word):
            groups.append(cur)
            cur, cur_len = [], 0
        cur.append(i)
        cur_len += len(s)
    if cur:
        groups.append(cur)

    segs = []
    for gi, g in enumerate(groups):
        t0 = times_cs[g[0]]
        t1 = times_cs[groups[gi + 1][0]] if gi + 1 < len(groups) else t1_cs
        segs.append({
            "t0": t0, "t1": max(t1, t0),
            "text": "".join(surfaces[i] for i in g),
            "tokens": [ids[i] for i in g],
            "token_texts": [surfaces[i] for i in g],
            "probs": [float(np.exp(min(lps[i], 0.0))) for i in g],
            "token_times": [times_cs[i] for i in g],
            "speaker_turn_next": False,
        })
    return segs


_WARNED_FLAGS: set = set()


def _warn_once(flag: str, message: str) -> None:
    if flag not in _WARNED_FLAGS:
        _WARNED_FLAGS.add(flag)
        log_warn("%s\n", message)


def _check_unsupported(params) -> int:
    """Flags the reference honours but this decoder cannot: an error code for
    the ones that change the output contract, a warning for advisory ones
    (a silently accepted no-op is worse than a refusal)."""
    if params.detect_language:
        # the Qwen2 decoder vocabulary has no whisper language tokens
        log_error("detect_language is not supported: the Qwen2 decoder "
                  "vocabulary has no whisper language tokens; set "
                  "params.language explicitly\n")
        return ERR_DETECT_LANGUAGE
    if params.translate:
        # no whisper task tokens in the Qwen2 text vocabulary: silently
        # transcribing instead of translating would change the contract
        log_error("translate is not supported: the Qwen2 decoder has no "
                  "whisper task tokens; steer the task with "
                  "initial_prompt instead\n")
        return ERR_TRANSLATE
    if params.tdrz_enable:
        _warn_once("tdrz", "tdrz_enable ignored: tinydiarize speaker-turn "
                   "tokens are not in the Qwen2 vocabulary")
    if params.max_initial_ts != 1.0:
        _warn_once("max_initial_ts", "max_initial_ts ignored: the Qwen2 "
                   "decoder emits no whisper timestamp tokens")
    if params.thold_pt != 0.01 or params.thold_ptsum != 0.01:
        _warn_once("thold_pt", "thold_pt/thold_ptsum ignored: they tune the "
                   "non-DTW timestamp heuristic; token_timestamps here uses "
                   "DTW attention alignment (models/dtw.py)")
    return 0


def run(ctx, state, params) -> int:
    """whisper_full()'s decode stage: called after the encoder wrote
    state.embd_enc. Populates state.segments / result_tokens / logits."""
    rc = _check_unsupported(params)
    if rc != 0:
        return rc
    bundle: DecoderBundle = ctx.decoder
    audio = bundle.project_audio(state.embd_enc)

    prompt_tokens = list(params.prompt_tokens or [])
    if params.initial_prompt and bundle.tokenize is not None:
        # initial_prompt (header :412-417): prepended to the text context,
        # capped at n_max_text_ctx/2
        extra = list(bundle.tokenize(params.initial_prompt))
        prompt_tokens = extra[: params.n_max_text_ctx // 2] + prompt_tokens
    prefill = _prefill_embeds(bundle, audio, prompt_tokens)
    suppress_mask = build_suppress_mask(bundle, params)
    suppress_first = build_blank_mask(bundle, params)

    temperatures = [params.temperature]
    if params.temperature_inc > 0:
        t = params.temperature
        while t + params.temperature_inc <= 1.0 + 1e-6:
            t += params.temperature_inc
            temperatures.append(round(t, 6))

    result = None
    for ti, temp in enumerate(temperatures):
        if params.strategy == "beam" and temp == 0.0:
            # an abort callback is checked after every token
            result = beam_search_device(
                bundle, prefill, beam_size=params.beam_size,
                max_new_tokens=params.max_new_tokens,
                length_penalty=params.length_penalty,
                repetition_penalty=params.repetition_penalty,
                abort_callback=params.abort_callback, timings=state.timings,
                suppress_mask=suppress_mask, suppress_first=suppress_first)
        else:
            # speculative_k: -1 ("auto") is plain greedy in the port, which
            # takes no hardware markers; > 0 drafts on the greedy fast path
            spec_k = max(params.speculative_k, 0)
            use_spec = (spec_k > 0 and temp == 0.0 and params.abort_callback is None
                        and params.repetition_penalty == 1.0 and prefill.shape[0] == 1)
            result = greedy_decode_device(
                bundle, prefill, max_new_tokens=params.max_new_tokens,
                temperature=temp,
                top_k=params.best_of if temp > 0 else 0,
                repetition_penalty=params.repetition_penalty,
                abort_callback=params.abort_callback,
                seed=ti,
                timings=state.timings,
                suppress_mask=suppress_mask,
                suppress_first=suppress_first,
                spec_k=spec_k if use_spec else 0)
        state.n_decode_forwards += result.n_decode_forwards
        # temperature fallback (whisper_full_params :413-418 semantics):
        # retry hotter when the decode is low-confidence (avg logprob below
        # logprob_thold) or degenerate: the zlib compression ratio of the
        # text above compression_ratio_thold, or (>= 32 tokens) the
        # trailing-window token entropy below entropy_thold
        avg_lp = result.avg_logprob[0]
        ent = _token_entropy(result.tokens[0])
        ratio = _compression_ratio(bundle.text(result.tokens[0]))
        needs_fallback = (avg_lp < params.logprob_thold
                          or ratio > params.compression_ratio_thold
                          or (len(result.tokens[0]) >= 32
                              and ent < params.entropy_thold))
        if not needs_fallback or ti == len(temperatures) - 1:
            break
        state.timings.n_fail_p += 1

    ids = result.tokens[0]
    state.logits = result.final_logits

    # no-speech gate (≙ whisper.cpp state->no_speech_prob): the probability
    # of EOS at the first decode step, the Qwen2 vocabulary having no
    # <|nosp|> token
    no_speech_prob = 0.0
    if result.first_logits is not None:
        fl = np.asarray(result.first_logits[0], np.float64)
        p = np.exp(fl - fl.max())
        no_speech_prob = float(p[bundle.eos_token_id] / p.sum())
    state.no_speech_prob = no_speech_prob
    if (no_speech_prob > params.no_speech_thold
            and result.avg_logprob[0] < params.logprob_thold):
        # silent window: emit no text (whisper_full skips such segments)
        state.result_tokens = []
        state.segments = []
        return 0

    t0_cs = params.offset_ms // 10
    t1_cs = t0_cs + 3000
    token_times = None
    if params.token_timestamps:
        aud0 = len(bundle.bos_tokens)
        n_aud = int(audio.shape[0])
        n_len = state.mel.n_len_org if state.mel is not None else 4 * n_aud
        # encoder positions cover 4 mel frames (10 ms) each
        n_content = max(1, min(n_aud, -(-n_len // 4)))
        token_times = compute_token_timestamps(
            bundle, prefill, ids, aud0, n_aud, n_content,
            n_top=ctx.params.dtw_n_top, t_offset_cs=t0_cs)

    state.result_tokens = ids
    if token_times is not None and params.max_len > 0 and not params.single_segment:
        # single_segment forces one segment whatever max_len says
        # (whisper_full_params.single_segment, header :384)
        state.segments = split_segment_by_length(
            bundle, ids, result.logprobs[0], token_times,
            params.max_len, params.split_on_word, t1_cs)
    else:
        if params.max_len > 0 and not params.single_segment:
            _warn_once("max_len", "max_len/split_on_word need "
                       "token_timestamps=True here (DTW times drive the "
                       "split); emitting one segment")
        seg = {
            "t0": t0_cs,
            "t1": t1_cs,
            "text": bundle.text(ids),
            "tokens": ids,
            "token_texts": _token_surfaces(bundle, ids),
            "probs": [float(np.exp(l)) for l in result.logprobs[0]],
            "speaker_turn_next": False,
        }
        if token_times is not None:
            seg["token_times"] = token_times
        state.segments = [seg]
    if params.print_realtime:
        for s in state.segments:
            print(s["text"], flush=True)
    if params.new_segment_callback is not None:
        params.new_segment_callback(ctx, state, len(state.segments))
    if params.print_progress:
        log_info("progress = %3d%%\n", 100)
    if params.progress_callback is not None:
        params.progress_callback(ctx, state, 100)
    return 0
