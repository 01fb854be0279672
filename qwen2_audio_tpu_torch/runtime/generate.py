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
graph serves every temperature of a fallback. Speculative decoding
(``spec_k > 0``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from qwen2_audio_tpu_torch.models.qwen2_decoder import (KVCache, QuantKVCache,
                                                        create_cache, decoder_forward)
from qwen2_audio_tpu_torch.ops.graphs import Graph, GraphCache, switches, tree_key
from qwen2_audio_tpu_torch.runtime.sampling import sample_token
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
    # single-position decoder forwards the loop ran, the prefill excluded: one
    # per step, those replayed after every stream stopped included
    n_decode_forwards: int = 0


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
    if s.seen is not None:
        s.seen[torch.arange(B, device=tok.device), tok] = True
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


def _step_key(params, cfg, layout: tuple, flags: dict, smp: Sampling, device) -> tuple:
    """Everything a captured step froze: the weights' addresses and forms,
    the config, (B, budget, capacity, cache type), which optional buffers
    the state has, the sampling settings, the process switches, the device."""
    return (tree_key(params), cfg, layout, tuple(flags.items()), smp, switches(), device)


def _captured(params, cfg, layout: tuple, flags: dict, smp: Sampling, device) -> Graph:
    """The step captured for this key, with its static state in ``.state``."""
    def make() -> Graph:
        s = new_state(cfg, *layout, device, **flags)
        graph = Graph(lambda: step(params, cfg, s, smp), device,
                      (s.generator,) if s.generator is not None else ())
        graph.state = s
        return graph

    return _GRAPHS.get(_step_key(params, cfg, layout, flags, smp, device), make)


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
    capture = dev.type == "cuda" if capture is None else capture
    if capture and dev.type != "cuda":
        raise ValueError(f"generate_on_device: capture needs a CUDA device, got {dev}")
    if abort_callback is not None:
        check_every = 1
    elif check_every is None:
        check_every = CARD_CHECK_EVERY if dev.type == "cuda" else 1
    if check_every < 1:
        raise ValueError(f"generate_on_device: check_every must be >= 1, got {check_every}")
    smp = Sampling(eos_token_id, float(repetition_penalty), int(top_k), float(top_p))
    layout = (B, max_new_tokens, cache_max_ctx, cache_dtype)
    flags = dict(seen=repetition_penalty != 1.0, suppress=suppress_mask is not None,
                 suppress_first=suppress_first is not None, sampled=temperature > 0)
    graph = None
    if capture:
        graph = _captured(params, cfg, layout, flags, smp, dev)
        s = graph.state
    else:
        s = new_state(cfg, *layout, dev, **flags)

    t0 = time_us()
    logits, _ = decoder_forward(params, cfg, prefill, s.cache, 0,
                                block_only=True, logits_last_only=True)
    first_logits = logits[:, -1]
    if timings is not None:
        _sync(dev)
        timings.t_prompt_us += time_us() - t0
        timings.n_prompt += T0

    t1 = time_us()
    load(s, first_logits, T0, eos_token_id, seed, suppress_mask, suppress_first, temperature)
    budget = min(max_new_tokens, cache_max_ctx - T0)   # tokens the loop may emit
    steps = 0
    if budget > 0:
        emit(s, smp)
        steps = 1
        while not bool(s.done.all()) \
                and not (abort_callback is not None and abort_callback()) \
                and steps < budget:
            n = min(check_every, budget - steps)
            if graph is not None:
                graph.replay(n)
            else:
                for _ in range(n):
                    step(params, cfg, s, smp)
            steps += n
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
                         suppress_mask=None, spec_k: int = 0,
                         suppress_first=None, abort_callback: Callable | None = None,
                         timings=None, check_every: int | None = None,
                         capture: bool | None = None) -> GenerationResult:
    """DecoderBundle entry over ``generate_on_device``: tokens cut after each
    stream's first EOS, suppression masks given as (V,) arrays."""
    if spec_k > 0:
        raise NotImplementedError("speculative decoding is not ported yet "
                                  "(ROADMAP.md, section 1, item 8)")
    B, T0, _ = prefill.shape
    if T0 >= bundle.max_ctx:
        raise ValueError(
            f"prefill length {T0} exceeds DecoderBundle.max_ctx "
            f"{bundle.max_ctx}; raise max_ctx when attaching the decoder")
    max_ctx = min(bundle.max_ctx, T0 + max_new_tokens)
    dev = prefill.device

    def on_dev(m):
        return None if m is None else torch.as_tensor(m, dtype=torch.float32, device=dev)

    tokens, logprobs, count, last_logits, first_logits, forwards = _generate(
        bundle.params, bundle.cfg, prefill, on_dev(suppress_mask),
        on_dev(suppress_first), max_new_tokens=max_new_tokens,
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
        first_logits=first_logits.cpu().numpy(), n_decode_forwards=forwards)
