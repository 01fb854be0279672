"""Autoregressive generation: the JAX package's device-resident decode loop.

The JAX package decodes under one ``lax.while_loop``: sample -> embed ->
decoder step -> stop test, its state (``GenState``: the cache, the last and
previous logits, tokens, log-probabilities, seen and done flags, a traced
count, the PRNG key) on the device and the positions traced values
(``T0 + count``). Here ``GenState`` holds the same as device tensors, with
(B,) per-stream positions and a ``torch.Generator``, and ``step`` advances
it by one token with no read back to the host.

The loop is the JAX loop turned by half a step: ``emit`` samples token
``count`` from the last logits, and ``step`` is one decoder forward of the
token emitted last followed by the next ``emit``; the first token is
emitted from the prefill's logits alone. So the loop runs one forward
fewer than the JAX loop, whose last forward's output nothing reads: when
the host looks after every step, ``count - 1`` forwards.

Once every stream has stopped, a step changes nothing the caller reads
(count, tokens, log-probabilities, the previous logits, the positions), so
the host may run ``check_every`` steps between two reads of the done flags
and still return what the JAX loop returns. No step runs past the budget
or the capacity (``T0 + count < cache_max_ctx``): the host counts the
steps, and count advances at each of them until every stream has stopped.
``check_every`` is 1 on the CPU, ``CARD_CHECK_EVERY`` on the card and 1
with an ``abort_callback``, which then runs after every step as in the JAX
package's host loop.

On the card the step is captured as a CUDA graph and replayed: the graph
is warmed up once on a side stream and captured (ops/graphs.py); a request
runs its prefill eagerly into the graph's static cache, copies its inputs
into the static state, replays the graph in chunks of ``check_every`` steps
reading ``done.all()`` once a chunk, and copies its outputs out. A graph
freezes the weights' addresses and forms, B, the budget, the cache's
capacity and type, the sampling settings, whether there are suppression
masks and the process switches (``_step_key``); ``MAX_GRAPHS`` of them are
kept, the least recently used dropped first, and ``clear_graphs`` drops
them all (``WhisperContext`` does when a decoder is attached or freed).
At temperature > 0 the step draws from a ``torch.Generator`` registered
with its graph, the temperature itself a device value of the state, so one
graph serves every temperature of a fallback.

Two more loops take the same shape. ``generate_speculative`` (B = 1
greedy, n-gram prompt-lookup drafts verified by one (K + 1)-position
forward) advances ``count`` by 1 to K + 1 tokens an iteration, so the host
cannot count iterations to the budget: each iteration does nothing once
``done`` or ``count >= max_new_tokens`` (every state write a
``torch.where`` on that flag), and the host replays chunks between reads of
the flag. ``beam_search_on_device`` prefills once at B = 1, tiles the cache
across the K beams and advances all K hypotheses a step: top-K of the K x V
candidate scores (ties to the lower index, as ``jax.lax.top_k``), the
cache reordered in place, finished hypotheses snapshotted. A graph cannot
skip the reorder when it is the identity, as the JAX ``lax.cond`` does, so
the captured step gathers the cache every step.

The continuous-batching slot pool (``prefill_slot``, ``decode_chunk_slots``,
``decode_chunk_slots_spec``; runtime/serving.py drives it) keeps B streams
in one cache, each at its own position. Its tensors are the caller's and
are updated in place; on the card one step is captured per pool (the
tensors' addresses are part of its key) and replayed ``chunk`` times, or,
speculative, in groups until the loop's condition, a device value that
gates every write, fails.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.models.qwen2_decoder import (KVCache, QuantKVCache,
                                                        create_cache, decoder_forward,
                                                        tile_cache)
from qwen2_audio_tpu_torch.ops.graphs import Graph, GraphCache, switches, tree_key
from qwen2_audio_tpu_torch.runtime.sampling import (apply_repetition_penalty,
                                                    length_penalty_score, sample_token)
from qwen2_audio_tpu_torch.utils.timings import time_us

# steps replayed between two reads of the done flags on the card. On an H100
# a 32-token request of the 28-layer bf16 decoder took 8.03 ms a token read
# every step, 7.80 every 4, 7.72 every 8 and 7.69 every 16 (PERF.md); a
# request that stops at EOS replays up to check_every - 1 steps more, about
# 8 ms each, so 4 costs least once a request stops within its budget
CARD_CHECK_EVERY = 4
MAX_GRAPHS = 4   # captured decode steps kept


@dataclasses.dataclass
class GenerationResult:
    tokens: list[list[int]]              # per batch element
    logprobs: list[list[float]]
    avg_logprob: list[float]
    # raw logits of the last decoded position (B, V) — whisper_get_logits
    final_logits: np.ndarray | None = None
    # raw logits of the first decode step (B, V) — the no-speech probability
    first_logits: np.ndarray | None = None
    # decoder forwards the loop ran, the prefill excluded: one per step (a
    # speculative step's forward has K + 1 positions), those replayed after
    # every stream stopped included
    n_decode_forwards: int = 0
    # speculative decoding: the iterations that emitted tokens (the JAX
    # ``iters``; tokens per forward = len(tokens) / spec_iters)
    spec_iters: int | None = None


@dataclasses.dataclass(frozen=True)
class Sampling:
    """What ``emit`` reads on the host (a captured step froze it)."""
    eos_token_id: int
    repetition_penalty: float = 1.0
    top_k: int = 0
    top_p: float = 1.0


@dataclasses.dataclass
class GenState:
    """The JAX ``GenState`` as device tensors, updated in place."""
    cache: KVCache | QuantKVCache
    last_logits: torch.Tensor           # (B, V) float32, raw, after the last forward
    prev_logits: torch.Tensor           # (B, V) raw logits the last token came from
    tokens: torch.Tensor                # (B, max_new) int32, EOS past each stop
    logprobs: torch.Tensor              # (B, max_new) float32
    seen: torch.Tensor | None           # (B, V) bool, with a repetition penalty
    done: torch.Tensor                  # (B,) bool
    count: torch.Tensor                 # () int64: tokens emitted
    pos: torch.Tensor                   # (B,) int32: the next forward's positions
    tok: torch.Tensor                   # (B,) int64: the tokens emitted last
    suppress: torch.Tensor | None       # (V,) additive logits mask
    suppress_first: torch.Tensor | None  # (V,) mask for the first token only
    temperature: torch.Tensor | None    # () float32, where the step samples
    generator: torch.Generator | None


def new_state(cfg, B: int, max_new_tokens: int, cache_max_ctx: int, cache_dtype,
              device: torch.device, *, seen: bool, suppress: bool,
              suppress_first: bool, sampled: bool) -> GenState:
    """A state of zeros at position 0, every buffer allocated once."""
    V = cfg.vocab_size

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GenState(
        cache=create_cache(cfg, B, cache_max_ctx, dtype=cache_dtype, device=device),
        last_logits=zeros(B, V), prev_logits=zeros(B, V),
        tokens=zeros(B, max_new_tokens, dtype=torch.int32),
        logprobs=zeros(B, max_new_tokens), seen=zeros(B, V, dtype=torch.bool) if seen else None,
        done=zeros(B, dtype=torch.bool), count=zeros(dtype=torch.int64),
        pos=zeros(B, dtype=torch.int32), tok=zeros(B, dtype=torch.int64),
        suppress=zeros(V) if suppress else None,
        suppress_first=zeros(V) if suppress_first else None,
        temperature=zeros() if sampled else None,
        generator=torch.Generator(device=device) if sampled else None)


def load(s: GenState, first_logits: torch.Tensor, T0: int, eos_token_id: int, seed: int,
         suppress_mask: torch.Tensor | None, suppress_first: torch.Tensor | None,
         temperature: float = 0.0) -> None:
    """Start a request in ``s`` (its cache holds the prefill's T0 rows):
    nothing emitted, the first forward at T0 (``emit`` moves pos there)."""
    s.last_logits.copy_(first_logits)
    s.prev_logits.copy_(first_logits)
    s.tokens.fill_(eos_token_id)
    s.logprobs.zero_()
    if s.seen is not None:
        s.seen.zero_()
    s.done.zero_()
    s.count.zero_()
    s.pos.fill_(T0 - 1)
    if s.suppress is not None:
        s.suppress.copy_(suppress_mask)
    if s.suppress_first is not None:
        s.suppress_first.copy_(suppress_first)
    if s.temperature is not None:
        s.temperature.fill_(temperature)
    if s.generator is not None:
        s.generator.manual_seed(seed)


def emit(s: GenState, smp: Sampling) -> None:
    """Sample token ``count`` from the last logits (``suppress_first`` where
    count is 0) and write it, its log-probability and the seen and done
    flags; then count, the positions and the previous logits advance, unless
    every stream had stopped."""
    B = s.done.shape[0]
    running = ~s.done.all()
    lg = s.last_logits
    if s.suppress is not None:
        lg = lg + s.suppress[None, :]
    if s.suppress_first is not None:
        # FullParams.suppress_blank: a mask for the first token only
        lg = torch.where(s.count == 0, lg + s.suppress_first[None, :], lg)
    tok, lp = sample_token(lg, s.seen, s.generator,
                           0.0 if s.temperature is None else s.temperature,
                           smp.repetition_penalty, smp.top_k, smp.top_p)
    tok = torch.where(s.done, smp.eos_token_id, tok)
    col = s.count.expand(B)[:, None]
    s.tokens.scatter_(1, col, tok.to(torch.int32)[:, None])
    s.logprobs.scatter_(1, col, lp.masked_fill(s.done, 0.0)[:, None])
    if s.seen is not None:   # a device tensor of Trues (a Python one would be copied in)
        s.seen.index_put_((torch.arange(B, device=tok.device), tok), torch.ones_like(s.done))
    s.done |= tok == smp.eos_token_id
    s.prev_logits.copy_(torch.where(running, s.last_logits, s.prev_logits))
    s.tok.copy_(tok)
    s.count += running
    s.pos += running


def step(params, cfg, s: GenState, smp: Sampling) -> None:
    """One decoder forward of the tokens emitted last at the device
    positions, then the next ``emit``; nothing is read back to the host."""
    x = params["embed"][s.tok][:, None, :]
    logits, _ = decoder_forward(params, cfg, x, s.cache, s.pos)
    s.last_logits.copy_(logits[:, -1])
    emit(s, smp)


_GRAPHS = GraphCache(MAX_GRAPHS)


def clear_graphs() -> None:
    """Drop every captured decode step."""
    _GRAPHS.clear()


def captured_steps() -> list[Graph]:
    """The captured decode steps, least recently used first (each with its
    capture_ms, replays and per-replay launches)."""
    return _GRAPHS.values()


def _step_key(params, cfg, layout: tuple, flags: dict, settings, device) -> tuple:
    """Everything a captured step froze: the weights' addresses and forms,
    the config, (B or beams, budget, capacity, cache type), which optional
    buffers the state has, its settings (sampling, beam or speculative),
    the process switches, the device."""
    return (tree_key(params), cfg, layout, tuple(flags.items()), settings, switches(), device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _generate(params, cfg, prefill: torch.Tensor, suppress_mask, suppress_first, *,
              max_new_tokens: int, eos_token_id: int, cache_max_ctx: int, cache_dtype,
              temperature: float, repetition_penalty: float, top_k: int, top_p: float,
              seed: int, abort_callback: Callable | None, timings,
              check_every: int | None, capture: bool | None) -> tuple:
    """``generate_on_device``'s work; also returns the forwards it ran."""
    B, T0, _ = prefill.shape
    dev = prefill.device
    check_every = _check_every(dev, check_every, abort_callback, "generate_on_device")
    smp = Sampling(eos_token_id, float(repetition_penalty), int(top_k), float(top_p))
    layout = (B, max_new_tokens, cache_max_ctx, cache_dtype)
    flags = dict(seen=repetition_penalty != 1.0, suppress=suppress_mask is not None,
                 suppress_first=suppress_first is not None, sampled=temperature > 0)
    s, graph = _state_and_graph("greedy", params, cfg, layout, flags, smp, dev,
                                lambda: new_state(cfg, *layout, dev, **flags), step, capture,
                                "generate_on_device")

    first_logits = _prefill(params, cfg, prefill, s.cache, timings)
    t1 = time_us()
    load(s, first_logits, T0, eos_token_id, seed, suppress_mask, suppress_first, temperature)
    budget = min(max_new_tokens, cache_max_ctx - T0)   # tokens the loop may emit
    steps = 0
    if budget > 0:
        emit(s, smp)
        steps = _run_chunks(graph, lambda: step(params, cfg, s, smp),
                            lambda: bool(s.done.all()), 1, budget, check_every,
                            abort_callback)
    out = (s.tokens.clone(), s.logprobs.clone(), int(s.count), s.prev_logits.clone(),
           first_logits.clone())
    if timings is not None:
        _sync(dev)
        timings.t_decode_us += time_us() - t1
    return out + (max(steps - 1, 0),)


def generate_on_device(params, cfg, prefill: torch.Tensor,
                       suppress_mask: torch.Tensor | None = None,
                       suppress_first: torch.Tensor | None = None, *,
                       max_new_tokens: int, eos_token_id: int,
                       cache_max_ctx: int, cache_dtype=torch.bfloat16,
                       temperature: float = 0.0, repetition_penalty: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                       abort_callback: Callable | None = None, timings=None,
                       check_every: int | None = None, capture: bool | None = None):
    """prefill (B, T0, D) embeddings on the decoder's device. Returns
    (tokens (B, max_new) int32, logprobs (B, max_new) float32, count,
    final_logits (B, V), first_logits (B, V)), tensors on the device, as
    the JAX function does.

    ``abort_callback`` (optional) is called after every step that did not
    stop every stream; a true result ends the loop there. ``timings``
    (optional) receives the prefill time (t_prompt_us, n_prompt) and the
    decode loop's (t_decode_us), each ended by a device synchronisation.
    ``check_every``: steps between two reads of the done flags (default:
    1 on the CPU, ``CARD_CHECK_EVERY`` on the card). ``capture`` (default:
    on the card) replays the step as a CUDA graph; off, it runs eagerly."""
    return _generate(params, cfg, prefill, suppress_mask, suppress_first,
                     max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                     cache_max_ctx=cache_max_ctx, cache_dtype=cache_dtype,
                     temperature=temperature, repetition_penalty=repetition_penalty,
                     top_k=top_k, top_p=top_p, seed=seed, abort_callback=abort_callback,
                     timings=timings, check_every=check_every, capture=capture)[:5]


def greedy_decode_device(bundle, prefill: torch.Tensor, *, max_new_tokens: int,
                         temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                         repetition_penalty: float = 1.0, seed: int = 0,
                         suppress_mask=None, cache_ctx: int | None = None,
                         spec_k: int = 0, ngram: int = 2,
                         suppress_first=None, abort_callback: Callable | None = None,
                         timings=None, check_every: int | None = None,
                         capture: bool | None = None) -> GenerationResult:
    """DecoderBundle entry over ``generate_on_device``: tokens cut after each
    stream's first EOS, suppression masks given as (V,) arrays.

    ``cache_ctx`` overrides the cache's capacity (default: this call's, the
    prefill plus the budget, at most ``bundle.max_ctx``). ``spec_k > 0``
    routes B = 1 greedy decoding through ``generate_speculative`` (n-gram
    drafts, ``spec_k`` verified a forward: the same tokens, fewer weight
    passes), with the budget clipped to the capacity as the plain loop
    clips it and the cache grown by the draft's ``spec_k`` rows."""
    B, T0, _ = prefill.shape
    if T0 >= bundle.max_ctx:
        raise ValueError(
            f"prefill length {T0} exceeds DecoderBundle.max_ctx "
            f"{bundle.max_ctx}; raise max_ctx when attaching the decoder")
    max_ctx = cache_ctx or min(bundle.max_ctx, T0 + max_new_tokens)
    dev = prefill.device
    sup, sup0 = _on_dev(suppress_mask, dev), _on_dev(suppress_first, dev)
    iters = None
    if spec_k > 0:
        if temperature > 0 or repetition_penalty != 1.0 or top_k > 0:
            raise ValueError("speculative path is exact for plain greedy "
                             "only (temperature=0, no penalties)")
        eff_new = min(max_new_tokens, max(max_ctx - T0, 0))
        tokens, logprobs, count, last_logits, first_logits, iters, forwards = _speculative(
            bundle.params, bundle.cfg, prefill, sup, sup0, max_new_tokens=eff_new,
            eos_token_id=bundle.eos_token_id,
            cache_max_ctx=max(max_ctx, T0 + eff_new + spec_k),
            cache_dtype=bundle.cache_dtype, spec_k=spec_k, ngram=ngram,
            abort_callback=abort_callback, timings=timings, check_every=check_every,
            capture=capture)
    else:
        tokens, logprobs, count, last_logits, first_logits, forwards = _generate(
            bundle.params, bundle.cfg, prefill, sup, sup0, max_new_tokens=max_new_tokens,
            eos_token_id=bundle.eos_token_id, cache_max_ctx=max_ctx,
            cache_dtype=bundle.cache_dtype, temperature=temperature,
            repetition_penalty=repetition_penalty, top_k=top_k, top_p=top_p,
            seed=seed, abort_callback=abort_callback, timings=timings,
            check_every=check_every, capture=capture)
    tokens = tokens.cpu().numpy()
    logprobs = logprobs.cpu().numpy()
    out_t, out_l = [], []
    for b in range(B):
        row = tokens[b, :count].tolist()   # past count: EOS padding
        n = row.index(bundle.eos_token_id) + 1 if bundle.eos_token_id in row else len(row)
        out_t.append(row[:n])
        out_l.append(logprobs[b, :n].tolist())
    if timings is not None:
        timings.n_decode += sum(len(t) for t in out_t)
    # raw (pre-suppression) logits: whisper_get_logits returns model logits
    return GenerationResult(
        tokens=out_t, logprobs=out_l,
        avg_logprob=[float(np.mean(l)) if l else 0.0 for l in out_l],
        final_logits=last_logits.cpu().numpy(),
        first_logits=first_logits.cpu().numpy(), n_decode_forwards=forwards,
        spec_iters=iters)


def _on_dev(mask, dev: torch.device) -> torch.Tensor | None:
    return None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=dev)


def _prefill(params, cfg, prefill: torch.Tensor, cache, timings) -> torch.Tensor:
    """The prompt through the decoder into ``cache`` (a fresh block, the
    causal prefill kernel on the card); the last position's logits (B, V).
    ``timings`` receives t_prompt_us (ended by a synchronisation) and
    n_prompt."""
    t0 = time_us()
    logits, _ = decoder_forward(params, cfg, prefill, cache, 0,
                                block_only=True, logits_last_only=True)
    if timings is not None:
        _sync(prefill.device)
        timings.t_prompt_us += time_us() - t0
        timings.n_prompt += prefill.shape[1]
    return logits[:, -1]


def _check_every(dev: torch.device, check_every: int | None,
                 abort_callback: Callable | None, what: str) -> int:
    if abort_callback is not None:
        return 1
    if check_every is None:
        return CARD_CHECK_EVERY if dev.type == "cuda" else 1
    if check_every < 1:
        raise ValueError(f"{what}: check_every must be >= 1, got {check_every}")
    return check_every


def _state_and_graph(kind: str, params, cfg, layout: tuple, flags: dict, settings,
                     device, make_state: Callable, step_fn: Callable,
                     capture: bool | None, what: str):
    """(state, graph or None): on the card (or with ``capture``) the
    ``kind`` of step captured for this key (``_step_key``) with its static
    state in ``.state`` and its generator registered; otherwise a fresh
    state for the eager loop."""
    capture = device.type == "cuda" if capture is None else capture
    if capture and device.type != "cuda":
        raise ValueError(f"{what}: capture needs a CUDA device, got {device}")
    if not capture:
        return make_state(), None

    def make() -> Graph:
        st = make_state()
        gen = getattr(st, "generator", None)
        graph = Graph(lambda: step_fn(params, cfg, st, settings), device,
                      () if gen is None else (gen,))
        graph.state = st
        return graph

    key = (kind,) + _step_key(params, cfg, layout, flags, settings, device)
    graph = _GRAPHS.get(key, make)
    return graph.state, graph


def _run_chunks(graph: Graph | None, step: Callable, stopped: Callable[[], bool],
                steps: int, limit: int, check_every: int,
                abort_callback: Callable | None) -> int:
    """From ``steps`` steps run, replay the graph (or run ``step``) in chunks
    of ``check_every`` steps until ``stopped()``, the abort callback or
    ``limit`` steps; returns the steps run. ``stopped`` is read once a
    chunk; the callback after every step (and first where a token was
    emitted before the loop, ``steps`` > 0)."""
    while not stopped() \
            and not (steps > 0 and abort_callback is not None and abort_callback()) \
            and steps < limit:
        n = min(check_every, limit - steps)
        if graph is not None:
            graph.replay(n)
        else:
            for _ in range(n):
                step()
        steps += n
    return steps


# --------------------------------------------------------------------------- #
# speculative decoding: n-gram prompt-lookup self-drafting at B = 1
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SpecSettings:
    """What a captured speculative step froze."""
    eos_token_id: int
    max_new_tokens: int
    spec_k: int
    ngram: int


@dataclasses.dataclass
class SpecState:
    """The JAX ``SpecState`` as device tensors, updated in place."""
    cache: KVCache | QuantKVCache
    last_logits: torch.Tensor           # (1, V) raw logits after the last emitted token
    prev_logits: torch.Tensor           # (1, V) raw logits the last token came from
    tokens: torch.Tensor                # (1, max_new + K + 1) int32
    logprobs: torch.Tensor              # (1, max_new + K + 1) float32
    done: torch.Tensor                  # () bool
    count: torch.Tensor                 # () int64: tokens emitted
    iters: torch.Tensor                 # () int64: iterations that emitted
    base: torch.Tensor                  # () int32: the prefill's length T0
    suppress: torch.Tensor              # (V,) additive mask (zeros without one)
    suppress_first: torch.Tensor | None  # (V,) mask for the first token only


def new_spec_state(cfg, max_new_tokens: int, spec_k: int, cache_max_ctx: int, cache_dtype,
                   device: torch.device, *, suppress_first: bool) -> SpecState:
    V, width = cfg.vocab_size, max_new_tokens + spec_k + 1

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SpecState(
        cache=create_cache(cfg, 1, cache_max_ctx, dtype=cache_dtype, device=device),
        last_logits=zeros(1, V), prev_logits=zeros(1, V),
        tokens=zeros(1, width, dtype=torch.int32), logprobs=zeros(1, width),
        done=zeros(dtype=torch.bool), count=zeros(dtype=torch.int64),
        iters=zeros(dtype=torch.int64), base=zeros(dtype=torch.int32), suppress=zeros(V),
        suppress_first=zeros(V) if suppress_first else None)


def spec_step(params, cfg, s: SpecState, st: SpecSettings) -> None:
    """One JAX ``generate_speculative`` iteration on the device: d0, the
    argmax of the last logits; a draft of K tokens, those that followed the
    most recent earlier match of the trailing n-gram [last ngram - 1
    emitted, d0] in the history (d0 repeated where there is none); one
    (K + 1)-position forward at T0 + count; the drafts accepted while they
    equal the forward's argmax, so that n_acc + 1 tokens land, cut at an
    EOS and at the budget. Nothing changes once ``done`` or ``count`` has
    reached the budget; nothing is read back to the host."""
    K, n = st.spec_k, st.ngram
    width = s.tokens.shape[1]
    dev = s.tokens.device
    c = s.count
    active = ~s.done & (c < st.max_new_tokens)
    lg_prev = s.last_logits[0] + s.suppress
    if s.suppress_first is not None:
        lg_prev = torch.where(c == 0, lg_prev + s.suppress_first, lg_prev)
    d0 = torch.argmax(lg_prev)

    # draft: the most recent match of [last ngram - 1 emitted, d0]
    h = s.tokens[0].long()
    idx = torch.arange(width, device=dev)
    tail = d0[None]
    if n > 1:
        at = (c - (n - 1)).clamp(0, width - (n - 1)) + torch.arange(n - 1, device=dev)
        tail = torch.cat([h[at], tail])
    wins = torch.stack([h.roll(-j) for j in range(n)], dim=1)            # (width, n)
    match = (wins == tail[None, :]).all(dim=1) & (idx <= c - n)
    best = torch.where(match, idx, -1).max()
    found = best >= 0
    start = torch.where(found, best + n, 0)
    kk = torch.arange(K, device=dev)
    draft = h[start.clamp(max=width - K) + kk]
    draft = torch.where(found & (start + kk < c), draft, d0)

    # one (K + 1)-position forward verifies the whole draft; past the stop
    # it runs at a position whose rows fit the cache and changes nothing read
    seq = torch.cat([d0[None], draft])                                    # (K + 1,)
    S = s.cache.max_ctx
    pos = (s.base + c).clamp(max=S - (K + 1)).to(torch.int32).view(1)
    out, _ = decoder_forward(params, cfg, params["embed"][seq][None], s.cache, pos)
    out = out[0]                                                          # (K + 1, V)
    rows = out + s.suppress[None, :]
    tgt = torch.argmax(rows, dim=-1)
    n_emit = (draft == tgt[:K]).long().cumprod(0).sum() + 1               # d0 always lands
    epos = torch.arange(K + 1, device=dev)
    eos_here = (seq == st.eos_token_id) & (epos < n_emit)
    eos_in = eos_here.any()
    idx_eos = torch.argmax(eos_here.long())                               # the first
    n_emit = torch.where(eos_in, torch.minimum(n_emit, idx_eos + 1), n_emit)
    n_emit = torch.minimum(n_emit, st.max_new_tokens - c)

    logp_prev = torch.log_softmax(lg_prev, dim=-1)
    logp_rows = torch.log_softmax(rows, dim=-1)
    lp = torch.cat([logp_prev[d0[None]], logp_rows[:K].gather(-1, draft[:, None])[:, 0]])
    cols = c.clamp(max=width - (K + 1)) + epos
    s.tokens[0, cols] = torch.where(active, seq.to(torch.int32), s.tokens[0, cols])
    s.logprobs[0, cols] = torch.where(active, lp, s.logprobs[0, cols])
    # the distribution the last emitted token came from: row n_emit - 2 of
    # this forward, or the carried-in logits where d0 alone landed (rows
    # picked by one-element index tensors: a 0-dim one would be read by the
    # host)
    last = out[(n_emit - 1).clamp(0, K)[None]][0]
    prev = torch.where(n_emit >= 2, out[(n_emit - 2).clamp(0, K)[None]][0], s.last_logits[0])
    s.prev_logits.copy_(torch.where(active, prev, s.prev_logits[0])[None])
    s.last_logits.copy_(torch.where(active, last, s.last_logits[0])[None])
    s.done |= active & eos_in
    s.count += torch.where(active, n_emit, 0)
    s.iters += active


@torch.no_grad()
def _speculative(params, cfg, prefill: torch.Tensor, suppress_mask, suppress_first, *,
                 max_new_tokens: int, eos_token_id: int, cache_max_ctx: int, cache_dtype,
                 spec_k: int, ngram: int, abort_callback: Callable | None = None,
                 timings=None, check_every: int | None = None,
                 capture: bool | None = None) -> tuple:
    """``generate_speculative``'s work; also returns the forwards it ran."""
    B, T0, _ = prefill.shape
    if B != 1:
        raise ValueError("speculative decoding is a B=1 latency path; "
                         "batch throughput comes from plain batching")
    if spec_k < 1 or ngram < 1:
        raise ValueError(f"generate_speculative: spec_k {spec_k} and ngram {ngram} must be >= 1")
    K = spec_k
    if cache_max_ctx < T0 + max_new_tokens + K:
        raise ValueError(
            f"cache_max_ctx {cache_max_ctx} < prefill {T0} + max_new "
            f"{max_new_tokens} + spec_k {K}: the draft block needs "
            "headroom past the last emitted token")
    dev = prefill.device
    check_every = _check_every(dev, check_every, abort_callback, "generate_speculative")
    st = SpecSettings(eos_token_id, max_new_tokens, K, ngram)
    s, graph = _state_and_graph(
        "speculative", params, cfg, (max_new_tokens, cache_max_ctx, cache_dtype),
        dict(suppress_first=suppress_first is not None), st, dev,
        lambda: new_spec_state(cfg, max_new_tokens, K, cache_max_ctx, cache_dtype, dev,
                               suppress_first=suppress_first is not None),
        spec_step, capture, "generate_speculative")

    first_logits = _prefill(params, cfg, prefill, s.cache, timings)
    t1 = time_us()
    s.last_logits.copy_(first_logits)
    s.prev_logits.copy_(first_logits)
    s.tokens.fill_(eos_token_id)
    s.logprobs.zero_()
    s.done.zero_()
    s.count.zero_()
    s.iters.zero_()
    s.base.fill_(T0)
    if suppress_mask is not None:
        s.suppress.copy_(suppress_mask)
    else:
        s.suppress.zero_()
    if s.suppress_first is not None:
        s.suppress_first.copy_(suppress_first)
    # every iteration emits at least one token until the stop
    forwards = _run_chunks(graph, lambda: spec_step(params, cfg, s, st),
                           lambda: bool(s.done | (s.count >= max_new_tokens)),
                           0, max_new_tokens, check_every, abort_callback)
    count = int(s.count)
    # past count: the speculative overhang, EOS padding
    live = torch.arange(s.tokens.shape[1], device=dev)[None, :] < count
    tokens = torch.where(live, s.tokens, eos_token_id)[:, :max_new_tokens]
    logprobs = torch.where(live, s.logprobs, 0.0)[:, :max_new_tokens]
    out = (tokens, logprobs, count, s.prev_logits.clone(), first_logits.clone(),
           int(s.iters), forwards)
    if timings is not None:
        _sync(dev)
        timings.t_decode_us += time_us() - t1
    return out


def generate_speculative(params, cfg, prefill: torch.Tensor,
                         suppress_mask: torch.Tensor | None = None,
                         suppress_first: torch.Tensor | None = None, *,
                         max_new_tokens: int, eos_token_id: int, cache_max_ctx: int,
                         cache_dtype=torch.bfloat16, spec_k: int = 8, ngram: int = 2,
                         abort_callback: Callable | None = None, timings=None,
                         check_every: int | None = None, capture: bool | None = None):
    """Greedy decoding with n-gram (prompt-lookup) self-drafting, prefill
    (1, T0, D) on the decoder's device. A forward over K + 1 positions
    reads the weight bytes of one, so verifying ``spec_k`` drafted tokens
    in one forward multiplies tokens per forward by the mean accepted
    length. Every emitted token is the argmax the plain loop takes given
    the same logits; at bf16 a (K + 1)-wide forward can round differently
    from a one-position forward, so a near-tie argmax may flip (exact in
    float32). The cache must hold T0 + max_new_tokens + spec_k rows.

    Returns (tokens (1, max_new), logprobs (1, max_new), count,
    final_logits (1, V), first_logits (1, V), iters) as the JAX function
    does: past count, EOS and 0. ``abort_callback``, ``timings``,
    ``check_every`` (iterations between two reads of the stop flag) and
    ``capture`` as in ``generate_on_device``."""
    return _speculative(params, cfg, prefill, suppress_mask, suppress_first,
                        max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                        cache_max_ctx=cache_max_ctx, cache_dtype=cache_dtype, spec_k=spec_k,
                        ngram=ngram, abort_callback=abort_callback, timings=timings,
                        check_every=check_every, capture=capture)[:6]


# --------------------------------------------------------------------------- #
# beam search
# --------------------------------------------------------------------------- #

def topk_lower_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a 1-D float32 tensor, equal values taken lower index first,
    as ``jax.lax.top_k`` takes them (``torch.topk`` promises no order among
    ties): one ``topk`` over int64 keys, each value's order-preserving bits
    above its reversed index. Returns (values, indices)."""
    bits = x.float().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long() * 2 ** 32
    n = x.numel()
    key += n - 1 - torch.arange(n, device=x.device)
    idx = torch.topk(key, k).indices
    return x[idx], idx


@dataclasses.dataclass(frozen=True)
class BeamSettings:
    """What a captured beam step froze."""
    eos_token_id: int
    max_new_tokens: int
    length_penalty: float
    repetition_penalty: float


@dataclasses.dataclass
class BeamState:
    """The JAX ``BeamState`` as device tensors, updated in place, with the
    B = 1 cache the prefill fills before it is tiled across the beams."""
    cache1: KVCache | QuantKVCache
    cache: KVCache | QuantKVCache
    scores: torch.Tensor                # (K,) float32 cumulative log-probability
    tokens: torch.Tensor                # (K, max_new) int32
    logprobs: torch.Tensor              # (K, max_new) float32
    seen: torch.Tensor | None           # (K, V) bool, with a repetition penalty
    done: torch.Tensor                  # (K,) bool: the beam's last token is EOS
    count: torch.Tensor                 # () int64: tokens emitted per beam
    best_score: torch.Tensor            # () float32: best length-penalised finished
    best_tokens: torch.Tensor           # (max_new,) int32
    best_lps: torch.Tensor              # (max_new,) float32
    best_len: torch.Tensor              # () int64
    base: torch.Tensor                  # () int32: the prefill's length T0
    suppress: torch.Tensor | None       # (V,) additive mask


def new_beam_state(cfg, beam_size: int, max_new_tokens: int, cache_max_ctx: int,
                   cache_dtype, device: torch.device, *, seen: bool,
                   suppress: bool) -> BeamState:
    K, V = beam_size, cfg.vocab_size

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    s = BeamState(
        cache1=create_cache(cfg, 1, cache_max_ctx, dtype=cache_dtype, device=device),
        cache=create_cache(cfg, K, cache_max_ctx, dtype=cache_dtype, device=device),
        scores=zeros(K), tokens=zeros(K, max_new_tokens, dtype=torch.int32),
        logprobs=zeros(K, max_new_tokens), seen=zeros(K, V, dtype=torch.bool) if seen else None,
        done=zeros(K, dtype=torch.bool), count=zeros(dtype=torch.int64), best_score=zeros(),
        best_tokens=zeros(max_new_tokens, dtype=torch.int32), best_lps=zeros(max_new_tokens),
        best_len=zeros(dtype=torch.int64), base=zeros(dtype=torch.int32),
        suppress=zeros(V) if suppress else None)
    s.cache.reorder(torch.arange(K, device=device))    # its scratch, made once
    return s


def _record_finished(s: BeamState, scores, tokens, logprobs, newly_done, count,
                     length_penalty: float, when) -> None:
    """Snapshot the best newly finished hypothesis into the running best
    where ``when`` holds and it scores above it (its score includes the EOS
    token's log-probability, as in the host loop)."""
    fin = torch.where(newly_done, length_penalty_score(scores, count, length_penalty),
                      -torch.inf)
    i = torch.argmax(fin)[None]
    better = when & (fin[i][0] > s.best_score)
    s.best_score.copy_(torch.where(better, fin[i][0], s.best_score))
    s.best_tokens.copy_(torch.where(better, tokens[i][0], s.best_tokens))
    s.best_lps.copy_(torch.where(better, logprobs[i][0], s.best_lps))
    s.best_len.copy_(torch.where(better, count, s.best_len))


def beam_load(s: BeamState, first_logits: torch.Tensor, T0: int, bs: BeamSettings,
              suppress_mask: torch.Tensor | None,
              suppress_first: torch.Tensor | None) -> None:
    """Start a request in ``s`` (its B = 1 cache holds the prefill): tile
    the cache across the beams and take the first expansion, top-K of one
    row of log-probabilities (with the suppression masks, the first-token
    mask included)."""
    K = s.scores.shape[0]
    tile_cache(s.cache1, K, out=s.cache)
    lp0 = torch.log_softmax(first_logits, dim=-1)[0]
    if suppress_mask is not None:
        lp0 = lp0 + suppress_mask
    if suppress_first is not None:
        lp0 = lp0 + suppress_first
    first_lp, first_tok = topk_lower_first(lp0, K)
    s.tokens.fill_(bs.eos_token_id)
    s.tokens[:, 0] = first_tok.to(torch.int32)
    s.logprobs.zero_()
    s.logprobs[:, 0] = first_lp
    if s.seen is not None:
        s.seen.zero_()
        s.seen.index_put_((torch.arange(K, device=s.seen.device), first_tok),
                          torch.ones_like(s.done))
    if s.suppress is not None:
        s.suppress.copy_(suppress_mask)
    s.done.copy_(first_tok == bs.eos_token_id)
    s.count.fill_(1)
    s.scores.copy_(first_lp)
    s.base.fill_(T0)
    s.best_score.fill_(-torch.inf)
    s.best_tokens.copy_(s.tokens[0])
    s.best_lps.copy_(s.logprobs[0])
    s.best_len.zero_()
    _record_finished(s, s.scores, s.tokens, s.logprobs, s.done, s.count,
                     bs.length_penalty, True)


def beam_step(params, cfg, s: BeamState, bs: BeamSettings) -> None:
    """One JAX ``beam_search_on_device`` iteration on the device: the K
    beams' last tokens through the decoder at T0 + count - 1, the
    repetition penalty over each beam's seen tokens, top-K of the K x V
    candidate scores (finished beams at -inf), the hypotheses reordered
    (the cache in place, every step), finished ones snapshotted. Nothing
    changes once every beam is done or count has reached the budget or the
    capacity; nothing is read back to the host."""
    K, V = s.scores.shape[0], cfg.vocab_size
    dev = s.scores.device
    c = s.count
    S = s.cache.max_ctx
    active = (c < bs.max_new_tokens) & ~s.done.all() & (s.base + c < S)
    beams = torch.arange(K, device=dev)
    tok = s.tokens[:, (c - 1).clamp(min=0)[None]][:, 0].long()
    pos = (s.base + c - 1).clamp(max=S - 1).to(torch.int32).expand(K)
    logits, _ = decoder_forward(params, cfg, params["embed"][tok][:, None, :], s.cache, pos)
    pen = apply_repetition_penalty(logits[:, -1], s.seen, bs.repetition_penalty)
    lp = torch.log_softmax(pen, dim=-1)
    if s.suppress is not None:
        lp = lp + s.suppress[None, :]
    cand = torch.where(s.done[:, None], -torch.inf, s.scores[:, None] + lp)
    top_scores, best = topk_lower_first(cand.reshape(-1), K)
    src = torch.where(active, best // V, beams)
    nxt = best % V
    s.cache.reorder(src)

    col = c.clamp(max=bs.max_new_tokens - 1).expand(K, 1)
    tokens = s.tokens[src].scatter(1, col, nxt.to(torch.int32)[:, None])
    logprobs = s.logprobs[src].scatter(1, col, lp[src, nxt][:, None])
    done = nxt == bs.eos_token_id
    count = c + 1
    _record_finished(s, top_scores, tokens, logprobs, done, count, bs.length_penalty, active)
    if s.seen is not None:
        seen = s.seen[src].index_put_((beams, nxt), torch.ones_like(s.done))
        s.seen.copy_(torch.where(active, seen, s.seen))
    s.tokens.copy_(torch.where(active, tokens, s.tokens))
    s.logprobs.copy_(torch.where(active, logprobs, s.logprobs))
    s.scores.copy_(torch.where(active, top_scores, s.scores))
    s.done.copy_(torch.where(active, done, s.done))
    s.count += active


def beam_result(s: BeamState, bs: BeamSettings) -> tuple:
    """The JAX final selection: every surviving beam competes with the
    finished snapshots (re-scoring a finished beam changes nothing).
    Returns (tokens (max_new,), logprobs (max_new,), n) on the device and n
    as an int."""
    K = s.scores.shape[0]
    final = length_penalty_score(s.scores, s.count, bs.length_penalty)
    i = torch.argmax(torch.cat([final, s.best_score[None]]))
    from_beam = i < K
    ib = i.clamp(max=K - 1)[None]
    return (torch.where(from_beam, s.tokens[ib][0], s.best_tokens),
            torch.where(from_beam, s.logprobs[ib][0], s.best_lps),
            int(torch.where(from_beam, s.count, s.best_len)))


@torch.no_grad()
def _beam(params, cfg, prefill: torch.Tensor, suppress_mask, suppress_first, *,
          beam_size: int, max_new_tokens: int, eos_token_id: int, cache_max_ctx: int,
          cache_dtype, length_penalty: float, repetition_penalty: float,
          abort_callback: Callable | None, timings, check_every: int | None,
          capture: bool | None) -> tuple:
    """``beam_search_on_device``'s work; also returns the steps it ran."""
    B, T0, _ = prefill.shape
    if B != 1:
        raise ValueError(f"beam search decodes one stream, got a batch of {B}")
    if not 1 <= beam_size <= cfg.vocab_size:
        raise ValueError(f"beam search: beam_size {beam_size} outside 1..{cfg.vocab_size}")
    if max_new_tokens < 1 or T0 >= cache_max_ctx:
        raise ValueError(f"beam search: max_new_tokens {max_new_tokens} and a prefill of "
                         f"{T0} in a cache of {cache_max_ctx} leave no token to emit")
    dev = prefill.device
    check_every = _check_every(dev, check_every, abort_callback, "beam search")
    bs = BeamSettings(eos_token_id, max_new_tokens, float(length_penalty),
                      float(repetition_penalty))
    flags = dict(seen=repetition_penalty != 1.0, suppress=suppress_mask is not None)
    s, graph = _state_and_graph(
        "beam", params, cfg, (beam_size, max_new_tokens, cache_max_ctx, cache_dtype), flags,
        bs, dev, lambda: new_beam_state(cfg, beam_size, max_new_tokens, cache_max_ctx,
                                        cache_dtype, dev, **flags),
        beam_step, capture, "beam search")

    first_logits = _prefill(params, cfg, prefill, s.cache1, timings)
    t1 = time_us()
    beam_load(s, first_logits, T0, bs, suppress_mask, suppress_first)
    # count starts at 1 (the first expansion) and stops at the budget or the
    # capacity
    steps = _run_chunks(graph, lambda: beam_step(params, cfg, s, bs),
                        lambda: bool(s.done.all()), 1,
                        min(max_new_tokens, cache_max_ctx - T0), check_every,
                        abort_callback) - 1
    tokens, logprobs, n = beam_result(s, bs)
    out = (tokens[:n].cpu(), logprobs[:n].cpu(), n, first_logits.clone())
    if timings is not None:
        _sync(dev)
        timings.t_decode_us += time_us() - t1
    return out + (steps,)


def beam_search_on_device(params, cfg, prefill: torch.Tensor,
                          suppress_mask: torch.Tensor | None = None,
                          suppress_first: torch.Tensor | None = None, *,
                          beam_size: int, max_new_tokens: int, eos_token_id: int,
                          cache_max_ctx: int, cache_dtype=torch.bfloat16,
                          length_penalty: float = -1.0, repetition_penalty: float = 1.0,
                          abort_callback: Callable | None = None, timings=None,
                          check_every: int | None = None, capture: bool | None = None):
    """Beam search of one stream, prefill (1, T0, D) on the decoder's device,
    with the JAX function's semantics: finished hypotheses are snapshotted
    the step they emit EOS (their slot then recycled by live expansions),
    and the winner is the best length-penalised score over the snapshots
    and the final beams. Returns (tokens (n,), logprobs (n,), n,
    first_logits (1, V)), the first two on the host.

    ``abort_callback`` (optional) is called after every step; a true result
    ends the search there with what it has. ``timings``, ``check_every``
    (steps between two reads of the done flags) and ``capture`` as in
    ``generate_on_device``."""
    return _beam(params, cfg, prefill, suppress_mask, suppress_first, beam_size=beam_size,
                 max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                 cache_max_ctx=cache_max_ctx, cache_dtype=cache_dtype,
                 length_penalty=length_penalty, repetition_penalty=repetition_penalty,
                 abort_callback=abort_callback, timings=timings, check_every=check_every,
                 capture=capture)[:4]


def beam_search_device(bundle, prefill: torch.Tensor, *, beam_size: int,
                       max_new_tokens: int, length_penalty: float = -1.0,
                       repetition_penalty: float = 1.0, suppress_mask=None,
                       suppress_first=None, abort_callback: Callable | None = None,
                       timings=None, check_every: int | None = None,
                       capture: bool | None = None) -> GenerationResult:
    """DecoderBundle entry over ``beam_search_on_device``: the cache sized to
    this call (the prefill plus the budget, at most ``bundle.max_ctx``),
    suppression masks given as (V,) arrays."""
    _, T0, _ = prefill.shape
    if T0 >= bundle.max_ctx:
        raise ValueError(
            f"prefill length {T0} exceeds DecoderBundle.max_ctx "
            f"{bundle.max_ctx}; raise max_ctx when attaching the decoder")
    dev = prefill.device
    tokens, lps, n, first_logits, steps = _beam(
        bundle.params, bundle.cfg, prefill, _on_dev(suppress_mask, dev),
        _on_dev(suppress_first, dev), beam_size=beam_size, max_new_tokens=max_new_tokens,
        eos_token_id=bundle.eos_token_id,
        cache_max_ctx=min(bundle.max_ctx, T0 + max_new_tokens),
        cache_dtype=bundle.cache_dtype, length_penalty=length_penalty,
        repetition_penalty=repetition_penalty, abort_callback=abort_callback,
        timings=timings, check_every=check_every, capture=capture)
    toks, lps = tokens.tolist(), lps.tolist()
    if timings is not None:
        timings.n_decode += len(toks)
    return GenerationResult(tokens=[toks], logprobs=[lps],
                            avg_logprob=[float(np.mean(lps)) if lps else 0.0],
                            first_logits=first_logits.cpu().numpy(),
                            n_decode_forwards=steps)


# --------------------------------------------------------------------------- #
# continuous batching: a pool of decode slots over one shared cache
# --------------------------------------------------------------------------- #

def _cache_kind(cache) -> str:
    return "q8" if isinstance(cache, QuantKVCache) else str(cache.k.dtype)


@torch.no_grad()
def prefill_slot(params, cfg, cache, slot_pos: torch.Tensor, slot_logits: torch.Tensor,
                 slot_active: torch.Tensor, slot, prefill: torch.Tensor, tp_group=None):
    """Prefill ONE stream (1, T0, D) and install it in slot ``slot`` of the
    pool: its K/V block at cache[:, slot, :T0] (bf16 / float32 or the int8
    cache with its scales), its next-token logits at slot_logits[slot],
    slot_pos[slot] = T0, slot_active[slot] = True; in place, and returned as
    the JAX function returns them. The prompt runs as a fresh block (the
    causal prefill kernel on the card) into a cache of its own T0 rows,
    which is then copied in: the JAX package's order. With ``tp_group``
    ``params`` is this rank's shard, ``cfg`` its per-shard config and the
    cache its kv heads (parallel/tp.py); the logits come back whole."""
    slot = int(slot)
    _, T0, _ = prefill.shape
    if not 0 <= slot < slot_pos.shape[0] or T0 > cache.max_ctx:
        raise ValueError(f"prefill_slot: slot {slot} of {slot_pos.shape[0]}, prefill of "
                         f"{T0} into a cache of {cache.max_ctx}")
    mini = create_cache(cfg, 1, T0, dtype=torch.int8 if isinstance(cache, QuantKVCache)
                        else cache.k.dtype, device=prefill.device)
    logits, _ = decoder_forward(params, cfg, prefill, mini, 0, block_only=True,
                                logits_last_only=True, tp_group=tp_group)
    for buf, block in zip(cache.parts(), mini.parts()):
        buf[:, slot, :T0].copy_(block[:, 0])
    slot_pos[slot] = T0
    slot_logits[slot].copy_(logits[0, -1])
    slot_active[slot] = True
    return cache, slot_pos, slot_logits, slot_active


@dataclasses.dataclass(frozen=True)
class SlotSettings:
    """What a captured pool step froze."""
    eos_token_id: int
    chunk: int
    spec_k: int = 0
    ngram: int = 2
    tp_group: Any = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass
class SlotState:
    """A pool's step state: the caller's pool tensors (updated in place)
    and this call's outputs, a device step counter included."""
    cache: KVCache | QuantKVCache
    pos: torch.Tensor                   # (B,) int32
    logits: torch.Tensor                # (B, V) float32, raw
    active: torch.Tensor                # (B,) bool
    suppress: torch.Tensor | None       # (V,) additive mask
    toks: torch.Tensor                  # (B, width) int32
    lps: torch.Tensor                   # (B, width) float32
    i: torch.Tensor                     # () int64: steps (verify iterations) run
    hist: torch.Tensor | None = None    # (B, HBUF) int32 (speculative)
    hlen: torch.Tensor | None = None    # (B,) int32
    emitted: torch.Tensor | None = None  # (B,) int64: tokens emitted this chunk


def slot_step(params, cfg, s: SlotState, st: SlotSettings) -> None:
    """One JAX ``decode_chunk_slots`` step on the device: every ACTIVE slot
    takes the argmax of its logits (plus the suppression mask), writes it
    and its log-probability at column ``i``, and runs one decoder forward
    at its own position; an inactive slot yields EOS with log-probability
    0, keeps its logits and position, and parks its cache write on row
    S - 1 (no stream reads that row before it writes it itself). A slot
    stops at EOS or when pos + 1 reaches the capacity. Nothing is read
    back to the host."""
    B = s.pos.shape[0]
    S = s.cache.max_ctx
    eos = st.eos_token_id
    lg = s.logits if s.suppress is None else s.logits + s.suppress[None, :]
    logp = torch.log_softmax(lg, dim=-1)
    am = torch.argmax(lg, dim=-1)
    tok = torch.where(s.active, am, eos)
    lp = torch.where(s.active, logp.gather(-1, am[:, None])[:, 0], 0.0)
    # a replay past the chunk (a timing loop's) rewrites the last column
    col = s.i.clamp(max=s.toks.shape[1] - 1).expand(B)[:, None]
    s.toks.scatter_(1, col, tok.to(torch.int32)[:, None])
    s.lps.scatter_(1, col, lp[:, None])
    new_active = s.active & (tok != eos) & (s.pos + 1 < S)
    write_pos = torch.where(s.active, s.pos, S - 1)
    out, _ = decoder_forward(params, cfg, params["embed"][am][:, None, :], s.cache, write_pos,
                             tp_group=st.tp_group)
    s.logits.copy_(torch.where(s.active[:, None], out[:, -1], s.logits))
    s.pos.copy_(torch.where(s.active, s.pos + 1, s.pos))
    s.active.copy_(new_active)
    s.i += 1


def spec_slot_step(params, cfg, s: SlotState, st: SlotSettings) -> None:
    """One JAX ``decode_chunk_slots_spec`` iteration on the device, which
    changes nothing once no active slot has emitted fewer than ``chunk``
    tokens or ``chunk`` iterations ran (the JAX loop's condition, ``go``):
    each active slot drafts K tokens from its own history (those that
    followed the most recent earlier match of [last ngram - 1 emitted, d0],
    d0 repeated where there is none), one (B, K + 1) forward at each slot's
    position verifies them, and the accepted prefix plus d0 lands, cut at
    an EOS, at the chunk and at the capacity. Frozen slots ride the forward;
    their rows land at or above their live ones (rewritten before they are
    read) or past the capacity (dropped). Nothing is read back to the host."""
    B, V = s.logits.shape
    S = s.cache.max_ctx
    K, n, chunk, eos = st.spec_k, st.ngram, st.chunk, st.eos_token_id
    HBUF, OUT = s.hist.shape[1], s.toks.shape[1]
    dev = s.pos.device
    go = (s.active & (s.emitted < chunk)).any() & (s.i < chunk)
    live = go & s.active
    lg = s.logits + s.suppress[None, :]
    d0 = torch.argmax(lg, dim=-1)                                         # (B,)
    hist, hlen = s.hist.long(), s.hlen.long()

    # the draft: the most recent match of [last ngram - 1 emitted, d0]
    tail = d0[:, None]
    if n > 1:
        at = (hlen - (n - 1)).clamp(min=0)[:, None] + torch.arange(n - 1, device=dev)
        tail = torch.cat([hist.gather(1, at.clamp(max=HBUF - 1)), tail], dim=1)
    wins = torch.stack([hist.roll(-j, dims=1) for j in range(n)], dim=2)  # (B, HBUF, n)
    idx = torch.arange(HBUF, device=dev)[None, :]
    match = (wins == tail[:, None, :]).all(dim=2) & (idx <= (hlen - n)[:, None])
    best = torch.where(match, idx, -1).amax(dim=1)
    found = best >= 0
    start = torch.where(found, best + n, 0)
    didx = start[:, None] + torch.arange(K, device=dev)[None, :]         # (B, K)
    draft = hist.gather(1, didx.clamp(max=HBUF - 1))
    draft = torch.where(found[:, None] & (didx < hlen[:, None]), draft, d0[:, None])

    # one (B, K + 1) verify forward at every slot's position
    seq = torch.cat([d0[:, None], draft], dim=1)                          # (B, K + 1)
    out, _ = decoder_forward(params, cfg, params["embed"][seq], s.cache, s.pos,
                             tp_group=st.tp_group)
    rows = out + s.suppress[None, None, :]
    tgt = torch.argmax(rows, dim=-1)
    n_emit = (draft == tgt[:, :K]).long().cumprod(1).sum(1) + 1          # d0 always lands
    epos = torch.arange(K + 1, device=dev)[None, :]
    eos_here = (seq == eos) & (epos < n_emit[:, None])
    eos_in = eos_here.any(dim=1)
    idx_eos = torch.argmax(eos_here.long(), dim=1)                        # the first
    n_emit = torch.where(eos_in, torch.minimum(n_emit, idx_eos + 1), n_emit)
    n_emit = torch.minimum(n_emit, chunk - s.emitted)
    # capacity: the last token may write row S - 1, as in the plain pool
    n_emit = torch.minimum(n_emit, (S - s.pos.long()).clamp(min=0))
    n_emit = torch.where(live, n_emit, 0)
    eos_emitted = eos_in & (idx_eos < n_emit)

    logp_prev = torch.log_softmax(lg, dim=-1)
    logp_rows = torch.log_softmax(rows, dim=-1)
    lp = torch.cat([logp_prev.gather(1, d0[:, None]),
                    logp_rows[:, :K].gather(2, draft[:, :, None])[:, :, 0]], dim=1)

    # this iteration's block at each slot's emitted offset and history
    # length (columns past the buffer dropped), as gathers: no two writes
    # meet one column
    def put(buf, base, vals):
        j = torch.arange(buf.shape[1], device=dev)[None, :] - base[:, None]
        take = live[:, None] & (j >= 0) & (j <= K)
        buf.copy_(torch.where(take, vals.gather(1, j.clamp(0, K)).to(buf.dtype), buf))

    put(s.toks, s.emitted, seq)
    put(s.lps, s.emitted, lp)
    put(s.hist, hlen, seq)
    s.hlen.copy_(torch.minimum(hlen + n_emit, torch.full_like(hlen, HBUF)).to(s.hlen.dtype))

    # the next distribution: the raw logits at the last emitted position
    last = out.gather(1, (n_emit - 1).clamp(min=0)[:, None, None].expand(B, 1, V))[:, 0]
    s.logits.copy_(torch.where((n_emit > 0)[:, None], last, s.logits))
    pos = s.pos + n_emit.to(s.pos.dtype)
    s.pos.copy_(pos)
    s.active.copy_(torch.where(go, s.active & ~eos_emitted & (pos < S), s.active))
    s.emitted += n_emit
    s.i += go


def _pool_state(cache, slot_pos, slot_logits, slot_active, suppress: bool, width: int,
                hist=None, hlen=None) -> SlotState:
    """A step state over the caller's pool tensors, with this call's own
    output buffers."""
    B, V = slot_logits.shape
    dev = slot_logits.device

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    spec = hist is not None
    return SlotState(cache=cache, pos=slot_pos, logits=slot_logits, active=slot_active,
                     suppress=zeros(V) if suppress else None,
                     toks=zeros(B, width, dtype=torch.int32), lps=zeros(B, width),
                     i=zeros(dtype=torch.int64), hist=hist, hlen=hlen,
                     emitted=zeros(B, dtype=torch.int64) if spec else None)


def _pool_graph(kind: str, params, cfg, pool: tuple, settings: SlotSettings, width: int,
                suppress_mask, capture: bool | None, what: str, step_fn):
    """(state, graph or None) of a pool step. On the card the step is
    captured once per pool (its tensors' addresses are part of the key);
    the capture's warm-up call runs one real step, so the pool's positions,
    logits, flags and history are put back after it (its cache rows land
    where a step writes before it reads)."""
    cache, slot_pos, slot_logits, slot_active = pool[:4]
    dev = slot_pos.device
    B = slot_pos.shape[0]
    layout = (B, width, cache.max_ctx, _cache_kind(cache), tree_key(list(cache.parts()) +
                                                                    list(pool[1:])))
    flags = dict(suppress=suppress_mask is not None or kind == "spec_slots")
    saved = []

    def make_state() -> SlotState:
        saved.extend(t.clone() for t in pool[1:])
        return _pool_state(cache, slot_pos, slot_logits, slot_active, flags["suppress"],
                           width, *pool[4:])

    s, graph = _state_and_graph(kind, params, cfg, layout, flags, settings, dev, make_state,
                                step_fn, capture, what)
    if graph is not None:       # a capture just ran its warm-up step: undo it
        for t, v in zip(pool[1:], saved):
            t.copy_(v)
    s.toks.fill_(settings.eos_token_id)
    s.lps.zero_()
    s.i.zero_()
    if s.suppress is not None:
        if suppress_mask is None:
            s.suppress.zero_()
        else:
            s.suppress.copy_(torch.as_tensor(suppress_mask, dtype=torch.float32))
    return s, graph


@torch.no_grad()
def decode_chunk_slots(params, cfg, cache, slot_pos: torch.Tensor, slot_logits: torch.Tensor,
                       slot_active: torch.Tensor, suppress_mask=None, *, chunk: int,
                       eos_token_id: int, capture: bool | None = None, tp_group=None):
    """Advance every ACTIVE slot of the pool by up to ``chunk`` greedy tokens,
    each slot at its own position (inactive slots frozen: no position
    advance, their writes parked on row S - 1). Returns (cache, slot_pos,
    slot_logits, slot_active, tokens (B, chunk) int32, logprobs (B, chunk)
    float32) as the JAX function does, the pool tensors updated in place;
    tokens of frozen or finished steps read ``eos_token_id``.

    On the card (or with ``capture``) one step is captured as a CUDA graph
    per pool and replayed ``chunk`` times, the step index a device counter;
    the host reads nothing until the chunk has run. ``capture=False`` runs
    the same step eagerly, as it always runs under a tensor-parallel
    ``tp_group`` (parallel/tp.py)."""
    if chunk < 1:
        raise ValueError(f"decode_chunk_slots: chunk {chunk} < 1")
    st = SlotSettings(int(eos_token_id), int(chunk), tp_group=tp_group)
    capture = False if tp_group is not None else capture
    s, graph = _pool_graph("slots", params, cfg, (cache, slot_pos, slot_logits, slot_active),
                           st, chunk, suppress_mask, capture, "decode_chunk_slots", slot_step)
    _run_chunks(graph, lambda: slot_step(params, cfg, s, st), lambda: False, 0, chunk, chunk,
                None)
    return cache, slot_pos, slot_logits, slot_active, s.toks.clone(), s.lps.clone()


@torch.no_grad()
def decode_chunk_slots_spec(params, cfg, cache, slot_pos: torch.Tensor,
                            slot_logits: torch.Tensor, slot_active: torch.Tensor,
                            slot_hist: torch.Tensor, slot_hlen: torch.Tensor,
                            suppress_mask=None, *, chunk: int, eos_token_id: int,
                            spec_k: int = 7, ngram: int = 2, check_every: int | None = None,
                            capture: bool | None = None, tp_group=None):
    """The batched speculative pool: every ACTIVE slot self-drafts
    ``spec_k`` tokens from its own n-gram history (``slot_hist`` (B, HBUF)
    int32, ``slot_hlen`` (B,) int32; reset a row on refill) and verifies
    them in one (B, spec_k + 1) forward, iterations running while an active
    slot has emitted fewer than ``chunk`` tokens, at most ``chunk`` of them.
    Every slot emits exactly the plain pool's tokens (exact at float32),
    the capacity boundary included.

    Returns (cache, slot_pos, slot_logits, slot_active, slot_hist,
    slot_hlen, tokens (B, chunk + spec_k + 1), logprobs, n_new (B,), iters)
    as the JAX function does: the first n_new[b] entries of row b are the
    new tokens (EOS and 0 past them), ``iters`` the verify forwards.

    A graph cannot branch, so on the card (or with ``capture``) one
    iteration is captured (every write a ``torch.where`` on the loop's
    condition) and replayed in groups of ``check_every`` (default:
    ``CARD_CHECK_EVERY`` on the card, 1 on the CPU), the condition read
    once a group, at most ``chunk`` iterations; ``capture=False`` runs it
    eagerly. Iterations replayed after the condition fails change nothing
    the caller reads. Under a tensor-parallel ``tp_group`` the iterations
    run eagerly, the condition read from replicated state, the same on
    every rank."""
    if chunk < 1 or spec_k < 1 or ngram < 1:
        raise ValueError(f"decode_chunk_slots_spec: chunk {chunk}, spec_k {spec_k} and "
                         f"ngram {ngram} must be >= 1")
    st = SlotSettings(int(eos_token_id), int(chunk), int(spec_k), int(ngram), tp_group)
    capture = False if tp_group is not None else capture
    check_every = _check_every(slot_pos.device, check_every, None, "decode_chunk_slots_spec")
    pool = (cache, slot_pos, slot_logits, slot_active, slot_hist, slot_hlen)
    s, graph = _pool_graph("spec_slots", params, cfg, pool, st, chunk + spec_k + 1,
                           suppress_mask, capture, "decode_chunk_slots_spec", spec_slot_step)
    s.emitted.zero_()
    _run_chunks(graph, lambda: spec_slot_step(params, cfg, s, st),
                lambda: not bool((s.active & (s.emitted < chunk)).any() & (s.i < chunk)),
                0, chunk, check_every, None)
    live = torch.arange(s.toks.shape[1], device=slot_pos.device)[None, :] < s.emitted[:, None]
    toks = torch.where(live, s.toks, eos_token_id)
    lps = torch.where(live, s.lps, 0.0)
    return (cache, slot_pos, slot_logits, slot_active, slot_hist, slot_hlen, toks, lps,
            s.emitted.clone(), s.i.clone())


def drop_pool_graphs(slot_pos: torch.Tensor) -> None:
    """Drop the captured steps of the pool whose position vector is
    ``slot_pos`` (they hold its tensors, the shared cache included)."""
    _GRAPHS.drop(lambda g: getattr(g.state, "pos", None) is slot_pos)
