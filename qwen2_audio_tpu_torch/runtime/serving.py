"""Serving: long-form and many-request transcription over 30 s windows.

Long audio is cut into 2 * n_audio_ctx-frame windows (one per 30 s of
content). ``transcribe_long_form`` encodes them and decodes a bucket of
windows as one batched greedy stream (beam search per window).
``transcribe_continuous`` and ``transcribe_many`` run continuous batching:
a fixed pool of decode slots over ONE shared KV cache
(runtime/generate.py: ``prefill_slot``, ``decode_chunk_slots``,
``decode_chunk_slots_spec``), each slot at its own position; a slot that
finishes (EOS or the token budget) is refilled with the next window while
the others keep decoding, and segments are yielded in completion order.

On the card each chunk of the pool is one captured step replayed ``chunk``
times (plain) or in groups of iterations (speculative); the host reads the
pool once a chunk. The encoder runs captured per (batch, mel shape)
(models/encoder.py::Encoder), so ``encode_windows`` returns a device tensor.

With ``mesh`` (parallel/mesh.py, a (dp, tp) mesh; dp is not used here) the
pool decodes tensor-parallel (parallel/tp.py): every rank of the ``tp``
group runs the same call on the same audio, encodes its windows itself,
holds its shard of the decoder and its kv heads of the cache, and the
pool's step runs eagerly. Every rank must take the same host decisions, or
the ranks stop in different collectives: the pool's state is replicated,
so its reads agree, and the choices made from each rank's own clock or
callbacks (the adaptive speculative mode, the abort callback) are rank 0's,
broadcast each chunk.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from qwen2_audio_tpu_torch.audio.mel import LogMelSpectrogram, mel_input_window
from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache
from qwen2_audio_tpu_torch.runtime.context import FullParams, WhisperContext
from qwen2_audio_tpu_torch.runtime.decoding import (_prefill_embeds, _token_surfaces,
                                                    _warn_once, beam_search, build_blank_mask,
                                                    build_suppress_mask)
from qwen2_audio_tpu_torch.runtime.generate import (_sync, decode_chunk_slots,
                                                    decode_chunk_slots_spec, drop_pool_graphs,
                                                    greedy_decode_device, prefill_slot)
from qwen2_audio_tpu_torch.utils.logging import log_info
from qwen2_audio_tpu_torch.utils.timings import time_us


@dataclasses.dataclass
class Segment:
    t0_cs: int            # start, centiseconds (10 ms units)
    t1_cs: int
    text: str
    tokens: list[int]
    avg_logprob: float


# the last _serve_pool run: chunks per mode, refills, each chunk's host ms
# (from its call to its read-back), the speculative chunks' verify
# iterations and the tokens they emitted
LAST_POOL_STATS: dict = {}
_PROBE_MIN = 8         # first re-probe of the losing mode after this many chunks
_PROBE_MAX = 128       # the backoff's cap


def _append_hist(hist: torch.Tensor, hlen: torch.Tensor, toks: torch.Tensor,
                 n_new: torch.Tensor):
    """Append each slot's first n_new[s] tokens of toks (B, C) to its draft
    history hist (B, H) at hlen[s], columns past H dropped, and advance hlen
    (at most H); in place (the speculative pool's captured step holds these
    tensors), returned as the JAX function returns them."""
    H, C = hist.shape[1], toks.shape[1]
    hl, n = hlen.long(), n_new.to(hlen.device).long()
    j = torch.arange(H, device=hist.device)[None, :] - hl[:, None]
    take = (j >= 0) & (j < torch.clamp(n, max=C)[:, None])
    hist.copy_(torch.where(take, toks.to(hist.device).gather(1, j.clamp(0, C - 1))
                           .to(hist.dtype), hist))
    hlen.copy_(torch.clamp(hl + n, max=H).to(hlen.dtype))
    return hist, hlen


def _base_prompt_tokens(bundle, params: FullParams) -> list[int]:
    """prompt_tokens with FullParams.initial_prompt tokenized and prepended
    (capped at n_max_text_ctx / 2), as ``run`` applies it."""
    prompt = list(params.prompt_tokens or [])
    if params.initial_prompt:
        if bundle.tokenize is not None:
            extra = list(bundle.tokenize(params.initial_prompt))
            prompt = extra[: params.n_max_text_ctx // 2] + prompt
        else:
            _warn_once("serving_initial_prompt",
                       "initial_prompt ignored: decoder bundle has no tokenizer")
    return prompt


def _segment_dict(bundle, seg: Segment, lps) -> dict:
    """The state.segments entry every serving path writes (the schema the
    whisper_full accessors read)."""
    return {
        "t0": seg.t0_cs, "t1": seg.t1_cs, "text": seg.text,
        "tokens": seg.tokens,
        "token_texts": _token_surfaces(bundle, seg.tokens),
        "probs": [float(np.exp(min(lp, 0.0))) for lp in lps],
        "speaker_turn_next": False,
    }


def _chunk_offsets(n_len_org: int, n_ctx: int) -> list[int]:
    """Window starts: one 2 * n_ctx-frame window per 30 s of content."""
    if n_len_org <= 0:
        return []
    return list(range(0, n_len_org, 2 * n_ctx))


def encode_windows(ctx: WhisperContext, mel: LogMelSpectrogram, offsets: list[int],
                   batch_size: int = 1) -> torch.Tensor:
    """Encode the mel windows at ``offsets`` in buckets of ``batch_size``
    (the last padded to the bucket with zero windows, so each bucket size
    has one captured encode). Returns (n_windows, n_ctx // 2, n_state) on the
    context's device. Encode time goes to the state's t_encode_us."""
    hp = ctx.hparams
    outs = []
    for i in range(0, len(offsets), batch_size):
        group = offsets[i:i + batch_size]
        wins = torch.stack([mel_input_window(mel, off, hp.n_audio_ctx) for off in group])
        if len(group) < batch_size:
            wins = torch.cat([wins, wins.new_zeros(batch_size - len(group), *wins.shape[1:])])
        t0 = time_us()
        enc = ctx.encoder(wins.to(ctx.device))[: len(group)]
        _sync(ctx.device)
        if ctx.state is not None:
            ctx.state.timings.t_encode_us += time_us() - t0
            ctx.state.timings.n_encode += len(group)
        outs.append(enc)
    if not outs:
        return torch.zeros((0, hp.n_audio_ctx // 2, hp.n_audio_state), device=ctx.device)
    return torch.cat(outs)


def _progress(ctx, state, params: FullParams, done: int) -> None:
    if params.progress_callback is not None:
        params.progress_callback(ctx, state, done)
    if params.print_progress:
        log_info("progress = %3d%%\n", done)


def transcribe_long_form(ctx: WhisperContext, samples: np.ndarray,
                         params: FullParams | None = None,
                         batch_size: int = 8) -> Iterator[Segment]:
    """Segments over the whole audio, one per 30 s window. Requires a
    decoder. A bucket of ``batch_size`` windows decodes as ONE batched
    greedy stream (``greedy_decode_device`` at B = bucket); beam search
    (``strategy="beam"``) runs per window. With ``no_context=False`` each
    window's transcript (EOS dropped, the last n_max_text_ctx / 2 tokens;
    0 carries nothing) prefixes the next window's prompt, so windows decode
    one at a time."""
    if ctx.decoder is None:
        raise RuntimeError("transcribe_long_form requires an attached decoder")
    params = params or FullParams()
    hp = ctx.hparams
    state = ctx.state or ctx.init_state()
    if ctx.pcm_to_mel_with_state(state, samples) != 0:
        raise RuntimeError("mel computation failed")
    mel = state.mel
    state.segments = []       # a fresh transcript per call, as whisper_full
    offsets = _chunk_offsets(mel.n_len_org, hp.n_audio_ctx)
    if not offsets:
        return
    bundle = ctx.decoder
    base_prompt = _base_prompt_tokens(bundle, params)
    window_cs = 2 * hp.n_audio_ctx        # frames are centiseconds (10 ms hop)
    sup = build_suppress_mask(bundle, params)
    blank = build_blank_mask(bundle, params)    # the first token's mask
    carry_context = not params.no_context
    if carry_context:
        batch_size = 1
    carried: list[int] = []

    for i in range(0, len(offsets), batch_size):
        group = offsets[i:i + batch_size]
        enc = encode_windows(ctx, mel, group)
        prompt = carried + base_prompt
        prefill = torch.cat([_prefill_embeds(bundle, bundle.project_audio(enc[b]), prompt)
                             for b in range(len(group))])
        if params.strategy == "beam":
            results = [beam_search(bundle, prefill[b:b + 1], beam_size=params.beam_size,
                                   max_new_tokens=params.max_new_tokens,
                                   length_penalty=params.length_penalty,
                                   repetition_penalty=params.repetition_penalty,
                                   timings=state.timings, suppress_mask=sup,
                                   suppress_first=blank)
                       for b in range(len(group))]
            tokens = [r.tokens[0] for r in results]
            avglp = [r.avg_logprob[0] for r in results]
            lps = [r.logprobs[0] for r in results]
        else:
            t0 = time_us()
            r = greedy_decode_device(bundle, prefill, max_new_tokens=params.max_new_tokens,
                                     temperature=params.temperature,
                                     repetition_penalty=params.repetition_penalty,
                                     suppress_mask=sup, suppress_first=blank)
            state.timings.t_decode_us += time_us() - t0
            state.timings.n_decode += sum(len(t) for t in r.tokens)
            tokens, avglp, lps = r.tokens, r.avg_logprob, r.logprobs
        if carry_context:
            new = [t for t in tokens[-1] if t != bundle.eos_token_id]
            keep = params.n_max_text_ctx // 2
            carried = (carried + new)[-keep:] if keep > 0 else []
        for b, off in enumerate(group):
            seg = Segment(t0_cs=off, t1_cs=min(off + window_cs, mel.n_len_org),
                          text=bundle.text(tokens[b]), tokens=tokens[b], avg_logprob=avglp[b])
            state.segments.append(_segment_dict(bundle, seg, lps[b]))
            if params.new_segment_callback is not None:
                params.new_segment_callback(ctx, state, 1)
            if params.progress_callback is not None or params.print_progress:
                _progress(ctx, state, params, min(100, 100 * (i + b + 1) // len(offsets)))
            yield seg


class _Job:
    """One decode stream of the slot pool: an encoded window and the
    metadata of its Segment."""

    __slots__ = ("tag", "enc", "t0_cs", "t1_cs")

    def __init__(self, tag, enc, t0_cs, t1_cs):
        self.tag, self.enc = tag, enc
        self.t0_cs, self.t1_cs = t0_cs, t1_cs


def _rank0_says(group, flags: list[bool], device) -> list[bool]:
    """``flags`` as tensor-parallel rank 0 holds them, on every rank of the
    group (one broadcast); the flags themselves without a group."""
    if group is None:
        return flags
    t = torch.tensor([int(f) for f in flags], dtype=torch.int32, device=device)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return [bool(v) for v in t.tolist()]


def _serve_pool(ctx, params: FullParams, jobs, n_slots: int, chunk_tokens: int, mesh):
    """Continuous batching: ``n_slots`` decode slots over one shared KV
    cache; a finished slot is refilled from ``jobs`` (pulled lazily) while
    the others go on. Yields (job, Segment) in completion order.

    The pool is greedy-only (beam, temperature and repetition penalty are
    warned about and ignored). ``FullParams.speculative_k`` > 0 runs the
    speculative chunks (``decode_chunk_slots_spec``), 0 the plain ones;
    < 0 ("auto") is 7 and adaptive on the CPU, and 0 on the card: the
    adaptive pool times each mode's chunks (discarding each mode's first,
    which carries its capture) and keeps the faster, probing the other
    after ``_PROBE_MIN`` chunks, backing off to ``_PROBE_MAX``. With
    ``mesh`` the decode is tensor-parallel (the module docstring)."""
    state = ctx.state or ctx.init_state()
    bundle = ctx.decoder
    if params.strategy == "beam":
        _warn_once("pool_beam", "slot-pool serving is greedy-only: strategy='beam' ignored "
                   "(use transcribe_long_form / whisper_full for beam search)")
    if params.temperature:
        _warn_once("pool_temperature", "slot-pool serving is greedy-only: temperature ignored")
    if params.repetition_penalty not in (None, 0.0, 1.0):
        _warn_once("pool_rep_penalty",
                   "slot-pool serving is greedy-only: repetition_penalty ignored")

    dev = bundle.device
    base_prompt = _base_prompt_tokens(bundle, params)
    sup_np = build_suppress_mask(bundle, params)
    sup = None if sup_np is None else torch.as_tensor(sup_np, device=dev)
    # suppress_blank: each slot's first token samples from the logits its
    # refill installed, so the step-0 mask is added to that row
    blank_np = build_blank_mask(bundle, params)
    blank = None if blank_np is None else torch.as_tensor(blank_np, device=dev)
    params_dec, cfg = bundle.params, bundle.cfg
    group = None
    if mesh is not None:
        from qwen2_audio_tpu_torch.parallel.mesh import mesh_shape, tp_group
        from qwen2_audio_tpu_torch.parallel.tp import shard_decoder_for_tp, tp_local_cfg
        params_dec = shard_decoder_for_tp(params_dec, mesh)
        cfg, group = tp_local_cfg(cfg, mesh_shape(mesh)["tp"]), tp_group(mesh)

    queue = iter(jobs)
    B = n_slots
    cache = create_cache(cfg, B, bundle.max_ctx, dtype=bundle.cache_dtype, device=dev)
    slot_pos = torch.zeros(B, dtype=torch.int32, device=dev)
    slot_logits = torch.zeros(B, cfg.vocab_size, dtype=torch.float32, device=dev)
    slot_active = torch.zeros(B, dtype=torch.bool, device=dev)
    slot_job: list = [None] * B
    emitted: dict[int, tuple[list[int], list[float]]] = {}
    budget = params.max_new_tokens

    spec_k = params.speculative_k
    adaptive = spec_k < 0
    if spec_k < 0:
        spec_k = 7 if dev.type == "cpu" else 0
    adaptive = adaptive and spec_k > 0
    slot_hist = slot_hlen = None
    if spec_k > 0:
        # a slot may emit up to chunk_tokens - 1 past the budget before the
        # host sees it: the history holds the whole device-side stream
        hbuf = budget + chunk_tokens + spec_k + 8
        slot_hist = torch.zeros(B, hbuf, dtype=torch.int32, device=dev)
        slot_hlen = torch.zeros(B, dtype=torch.int32, device=dev)

    def refill(free_slots) -> int:
        """Install the next jobs in ``free_slots``; returns how many."""
        n = 0
        for s in free_slots:
            job = next(queue, None)
            if job is None:
                break
            n += 1
            pre = _prefill_embeds(bundle, bundle.project_audio(job.enc), base_prompt)
            prefill_slot(params_dec, cfg, cache, slot_pos, slot_logits, slot_active, s, pre,
                         tp_group=group)
            if blank is not None:
                slot_logits[s] += blank
            if spec_k > 0:          # a fresh draft history for the new stream
                slot_hist[s] = 0
                slot_hlen[s] = 0
            slot_job[s] = job
            emitted[s] = ([], [])
        return n

    LAST_POOL_STATS.clear()
    LAST_POOL_STATS.update({"spec_chunks": 0, "plain_chunks": 0, "refills": 0, "chunk_ms": [],
                            "spec_iters": 0, "spec_tokens": 0})
    stats = LAST_POOL_STATS
    rates = {True: [], False: []}          # mode -> recent tokens/s
    warmed = {True: False, False: False}   # each mode's first chunk is set-up
    probe = {"interval": _PROBE_MIN, "next": _PROBE_MIN, "winner": None}
    chunk_i = 0

    def pick_spec() -> bool:
        if not adaptive:
            return spec_k > 0
        if not rates[True]:
            return True
        if not rates[False]:
            return False
        spec_wins = np.mean(rates[True][-3:]) >= np.mean(rates[False][-3:])
        if probe["winner"] is None:
            probe["winner"] = spec_wins
        elif probe["winner"] != spec_wins:      # the regime changed: probe eagerly again
            probe.update(interval=_PROBE_MIN, next=chunk_i + _PROBE_MIN, winner=spec_wins)
        if chunk_i >= probe["next"]:
            probe["interval"] = min(probe["interval"] * 2, _PROBE_MAX)
            probe["next"] = chunk_i + probe["interval"]
            return not spec_wins
        return spec_wins

    try:
        refill(range(B))
        t0 = time_us()
        t_refill_us = 0     # lazy encodes inside the decode span, booked as encode time
        n_decoded = 0
        while any(j is not None for j in slot_job):
            abort, use_spec = _rank0_says(group, [
                params.abort_callback is not None and params.abort_callback(),
                spec_k > 0 and pick_spec()], dev)
            if abort:
                break
            t_chunk = time.perf_counter()
            if use_spec:
                out = decode_chunk_slots_spec(
                    params_dec, cfg, cache, slot_pos, slot_logits, slot_active, slot_hist,
                    slot_hlen, sup, chunk=chunk_tokens, eos_token_id=bundle.eos_token_id,
                    spec_k=spec_k, tp_group=group)
                toks, lps, n_new = out[6], out[7], out[8].cpu().numpy()
                stats["spec_iters"] += int(out[9])
                stats["spec_tokens"] += int(n_new.sum())
            else:
                pos_before = slot_pos.cpu().numpy().copy()
                toks, lps = decode_chunk_slots(
                    params_dec, cfg, cache, slot_pos, slot_logits, slot_active, sup,
                    chunk=chunk_tokens, eos_token_id=bundle.eos_token_id,
                    tp_group=group)[4:]
                # one token per position advance: a capacity freeze pads
                # with EOS that the model never emitted
                n_new = slot_pos.cpu().numpy() - pos_before   # a new array
                if spec_k > 0:
                    _append_hist(slot_hist, slot_hlen, toks, torch.as_tensor(n_new))
            dt = max(time.perf_counter() - t_chunk, 1e-6)    # n_new is on the host
            stats["chunk_ms"].append(dt * 1e3)
            stats["spec_chunks" if use_spec else "plain_chunks"] += 1
            if spec_k > 0:
                if warmed[use_spec]:
                    rates[use_spec].append(float(n_new.sum()) / dt)
                    del rates[use_spec][:-8]
                else:
                    warmed[use_spec] = True
                chunk_i += 1
            toks, lps = toks.cpu().numpy(), lps.cpu().numpy()
            active = slot_active.cpu().numpy().copy()
            finished = []
            for s in range(B):
                if slot_job[s] is None:
                    continue
                row, lrow = emitted[s]
                for j in range(int(n_new[s])):
                    if len(row) >= budget:
                        break
                    row.append(int(toks[s, j]))
                    lrow.append(float(lps[s, j]))
                    n_decoded += 1
                    if row[-1] == bundle.eos_token_id:
                        break
                if not active[s] or len(row) >= budget:
                    finished.append(s)
            for s in finished:
                job = slot_job[s]
                slot_job[s] = None
                slot_active[s] = False
                row, lrow = emitted.pop(s)
                seg = Segment(t0_cs=job.t0_cs, t1_cs=job.t1_cs, text=bundle.text(row),
                              tokens=row, avg_logprob=float(np.mean(lrow)) if lrow else 0.0)
                state.segments.append(_segment_dict(bundle, seg, lrow))
                if params.new_segment_callback is not None:
                    params.new_segment_callback(ctx, state, 1)
                yield job, seg
            if finished:
                tr = time_us()
                stats["refills"] += refill(finished)
                t_refill_us += time_us() - tr
        state.timings.t_decode_us += time_us() - t0 - t_refill_us
        state.timings.n_decode += n_decoded
    finally:
        drop_pool_graphs(slot_pos)     # the captured steps hold the pool's cache


def transcribe_continuous(ctx: WhisperContext, samples: np.ndarray,
                          params: FullParams | None = None, max_streams: int = 8,
                          chunk_tokens: int = 16, mesh=None) -> Iterator[Segment]:
    """Continuous batching over one audio's 30 s windows: a pool of
    ``max_streams`` decode slots shares one KV cache, and a finished window's
    slot is refilled with the next window while the others keep decoding.
    Windows are encoded lazily, a bucket of ``max_streams`` ahead of the
    pool. Segments are yielded in completion order. ``mesh``: the decode is
    tensor-parallel over its ``tp`` axis, every rank calling with the same
    audio (the module docstring)."""
    if ctx.decoder is None:
        raise RuntimeError("transcribe_continuous requires an attached decoder")
    params = params or FullParams()
    hp = ctx.hparams
    state = ctx.state or ctx.init_state()
    if ctx.pcm_to_mel_with_state(state, samples) != 0:
        raise RuntimeError("mel computation failed")
    mel = state.mel
    state.segments = []
    offsets = _chunk_offsets(mel.n_len_org, hp.n_audio_ctx)
    if not offsets:
        return
    window_cs = 2 * hp.n_audio_ctx
    bucket = min(max_streams, len(offsets))

    def jobs():
        for i in range(0, len(offsets), bucket):
            group = offsets[i:i + bucket]
            enc = encode_windows(ctx, mel, group)
            for w, off in enumerate(group):
                yield _Job(i + w, enc[w], off, min(off + window_cs, mel.n_len_org))

    for _job, seg in _serve_pool(ctx, params, jobs(), bucket, chunk_tokens, mesh):
        yield seg


def transcribe_many(ctx: WhisperContext, audios: list, params: FullParams | None = None,
                    max_streams: int = 8, chunk_tokens: int = 16,
                    mesh=None) -> Iterator[tuple[int, Segment]]:
    """Continuous batching ACROSS requests: the windows of many audios share
    one slot pool, so a short clip's slot refills with the next request's
    window while long clips keep decoding. Each audio's mel and encode run
    when the pool first pulls one of its windows. Yields (audio index,
    Segment) in completion order. ``mesh`` as in
    ``transcribe_continuous``."""
    if ctx.decoder is None:
        raise RuntimeError("transcribe_many requires an attached decoder")
    params = params or FullParams()
    hp = ctx.hparams
    state = ctx.state or ctx.init_state()
    state.segments = []
    window_cs = 2 * hp.n_audio_ctx

    def jobs():
        for a, samples in enumerate(audios):
            if ctx.pcm_to_mel_with_state(state, samples) != 0:
                raise RuntimeError(f"mel computation failed (audio {a})")
            mel = state.mel
            offsets = _chunk_offsets(mel.n_len_org, hp.n_audio_ctx)
            if not offsets:
                continue
            enc = encode_windows(ctx, mel, offsets)
            for w, off in enumerate(offsets):
                yield _Job(a, enc[w], off, min(off + window_cs, mel.n_len_org))

    for job, seg in _serve_pool(ctx, params, jobs(), max_streams, chunk_tokens, mesh):
        yield job.tag, seg
