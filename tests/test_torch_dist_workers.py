"""Rank workers of the port's multi-process tests (no tests here).

tests/test_torch_parallel.py, tests/test_torch_tp_decode.py and
tests/test_torch_training.py start worlds of gloo ranks on the CPU through
``parallel.launch.spawn_world``; each spawned rank imports this module to
find its function, so it imports only torch, numpy and the port, never
JAX. The configurations, seeds and inputs are defined here, and the tests
build the JAX package's single-device references from the same ones.
Each worker returns numpy arrays and numbers, and whether JAX was imported.
"""

import sys

import numpy as np
import torch

from qwen2_audio_tpu_torch.config import (GGMLType, Qwen2AudioConfig, Qwen2DecoderConfig,
                                          WhisperHParams)

WORLD_TIMEOUT = 240.0    # seconds: a world's start, its collectives and its run

AUDIO = dict(n_vocab=64, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
             n_audio_layer=2, n_mels=16)
TEXT = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            tie_word_embeddings=False)
# tests/test_tp_decode.py's configurations: tp = 2, and tp = 4 (kv heads % 4)
CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=32,
           tie_word_embeddings=False)
CFG4 = dict(CFG, num_attention_heads=8, num_key_value_heads=4, head_dim=16)
QUANTS = (None, "q8_0", "q4_0", "fast")
POOL_PREFILLS = (4, 6)
POOL = dict(B=2, S=128, HB=64, chunk=10, spec_k=5, chunks=2)
SERVE_HP = dict(n_vocab=64, n_audio_ctx=64, n_audio_state=64, n_audio_head=4,
                n_audio_layer=2, n_mels=16)
TRAIN_BATCH = 4


def tp_cfg(tp: int) -> dict:
    return CFG if tp == 2 else CFG4


def pool_cfg(tp: int) -> dict:
    return dict(vocab_size=64, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4 if tp == 2 else 8,
                num_key_value_heads=2 if tp == 2 else 4,
                head_dim=32 if tp == 2 else 16, tie_word_embeddings=False)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _jax_free() -> bool:
    return not any(m.split(".")[0] in ("jax", "qwen2_audio_tpu") for m in sys.modules)


# --------------------------------------------------------------------------- #
# inputs, shared with the tests
# --------------------------------------------------------------------------- #

def decoder_params(seed: int, cfg: dict, quant=None):
    """The port's decoder tree of a seed, quantized as the JAX tests do."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import random_decoder_params
    from qwen2_audio_tpu_torch.quant.qparams import quantize_decoder_params
    p = random_decoder_params(np.random.default_rng(seed), Qwen2DecoderConfig(**cfg))
    if quant == "fast":
        return quantize_decoder_params(p, GGMLType.Q8_0, mode="fast")
    if quant is not None:
        return quantize_decoder_params(p, GGMLType[quant.upper()])
    return p


def tokens(seed: int, shape, vocab: int = 128) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def pool_prefills() -> list[np.ndarray]:
    return [(np.random.default_rng(80 + i).standard_normal((1, t0, 128)) * 0.1
             ).astype(np.float32) for i, t0 in enumerate(POOL_PREFILLS)]


def train_batch():
    r = np.random.default_rng(5)
    mel = r.standard_normal((TRAIN_BATCH, 16, 64)).astype(np.float32)
    toks = r.integers(0, 128, (TRAIN_BATCH, 8)).astype(np.int64)
    mask = np.ones((TRAIN_BATCH, 8), np.float32)
    mask[1, 5:] = 0.0
    mask[3, 2:] = 0.0
    return mel, toks, mask


def train_cfg() -> Qwen2AudioConfig:
    return Qwen2AudioConfig(audio=WhisperHParams(**AUDIO), text=Qwen2DecoderConfig(**TEXT))


def flat(tree, path: str = "") -> dict:
    """{"a/b/0/c": leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{path}/{key}" if path else str(key)).items()}
    if type(tree) in (list, tuple):         # a spec's Split is a leaf
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def serve_audio() -> np.ndarray:
    return (0.1 * np.random.default_rng(8).standard_normal(16000 * 5)).astype(np.float32)


# --------------------------------------------------------------------------- #
# worlds
# --------------------------------------------------------------------------- #

def parallel_world(rank: int, world: int) -> dict:
    """A 2 x 2 (dp, tp) world: the distributed helpers, the sharded decoder
    (dense, then the int8 cache) and encoder forwards (q/k/v and fused)."""
    from qwen2_audio_tpu_torch.models.encoder import (encoder_forward, fuse_encoder_qkv,
                                                      random_encoder_params)
    from qwen2_audio_tpu_torch.models.qwen2_decoder import embed_tokens
    from qwen2_audio_tpu_torch.parallel import distributed as dist_
    from qwen2_audio_tpu_torch.parallel.mesh import (coords, encoder_param_spec, local_batch,
                                                     local_cache, make_mesh, mesh_shape,
                                                     shard_params, tp_group)
    from qwen2_audio_tpu_torch.parallel.tp import shard_decoder_for_tp, tp_decoder_forward

    out = {"initialize_again": dist_.initialize(), "is_distributed": dist_.is_distributed()}
    mesh = make_mesh(2, 2)
    out["coords"] = (coords(mesh, "dp")[0], coords(mesh, "tp")[0])
    out["mesh_shape"] = mesh_shape(mesh)
    out["global_mesh_shape"] = mesh_shape(dist_.global_mesh(tp=2))
    for what, fn in (("global_mesh_tp3", lambda: dist_.global_mesh(tp=3)),
                     ("make_mesh_4x4", lambda: make_mesh(4, 4))):
        try:
            fn()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    dp_rank = coords(mesh, "dp")[0]
    batch = (np.arange(6, dtype=np.float32).reshape(2, 3) + 100 * dp_rank)
    out["global_batch"] = _np(dist_.host_local_batch_to_global(batch, mesh).full_tensor())
    out["allgather"] = dist_.process_allgather(np.array([1.5 * rank], np.float32))

    cfg = Qwen2DecoderConfig(**TEXT)
    params = decoder_params(11, TEXT)
    x = embed_tokens(params, torch.as_tensor(tokens(12, (4, 6))))
    sp = shard_decoder_for_tp(params, mesh)
    for name, dtype, T in (("decoder", torch.float32, 6), ("decoder_q8_cache", "q8", 5)):
        cache = local_cache(cfg, 4, 8, mesh, dtype=dtype)
        logits, cache = tp_decoder_forward(sp, cfg, mesh, local_batch(x[:, :T], mesh), cache, 0)
        out[name], out[name + "_pos"] = _np(logits), cache.pos

    hp = WhisperHParams(**AUDIO)
    enc = random_encoder_params(np.random.default_rng(13), hp)
    mel = torch.from_numpy(np.random.default_rng(14).standard_normal((4, 16, 64))
                           .astype(np.float32))
    for name, tree in (("encoder", enc), ("encoder_fused", fuse_encoder_qkv(enc))):
        local = shard_params(tree, encoder_param_spec(tree), mesh)
        out[name] = _np(encoder_forward(local, local_batch(mel, mesh), hp,
                                        tp_group=tp_group(mesh)))
    out["jax_free"] = _jax_free()
    return out


def _pool_run(params, cfg, tp: int, mesh, spec: bool) -> list[list[int]]:
    """The slot pool of tests/test_tp_decode.py: two prefills, two chunks,
    through the TP functions (or single-device with ``mesh`` None)."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import create_cache
    from qwen2_audio_tpu_torch.parallel import tp as tpm
    from qwen2_audio_tpu_torch.runtime import generate as g
    B, S, HB = POOL["B"], POOL["S"], POOL["HB"]
    lcfg = cfg if mesh is None else tpm.tp_local_cfg(cfg, tp)
    cache = create_cache(lcfg, B, S, dtype=torch.float32)
    pos = torch.zeros(B, dtype=torch.int32)
    logits = torch.zeros(B, cfg.vocab_size)
    active = torch.zeros(B, dtype=torch.bool)
    for s, pre in enumerate(pool_prefills()):
        pre = torch.from_numpy(pre)
        if mesh is None:
            g.prefill_slot(params, cfg, cache, pos, logits, active, s, pre)
        else:
            tpm.tp_prefill_slot(params, cfg, mesh, cache, pos, logits, active, s, pre)
    hist = torch.zeros(B, HB, dtype=torch.int32)
    hlen = torch.zeros(B, dtype=torch.int32)
    streams = [[] for _ in range(B)]
    kw = dict(chunk=POOL["chunk"], eos_token_id=-1)
    for _ in range(POOL["chunks"]):
        if spec:
            args = (cache, pos, logits, active, hist, hlen)
            out = (g.decode_chunk_slots_spec(params, cfg, *args, spec_k=POOL["spec_k"], **kw)
                   if mesh is None else
                   tpm.tp_decode_chunk_slots_spec(params, cfg, mesh, *args,
                                                  spec_k=POOL["spec_k"], **kw))
            toks, n_new = out[6].numpy(), out[8].numpy()
        else:
            before = pos.clone()
            args = (cache, pos, logits, active)
            out = (g.decode_chunk_slots(params, cfg, *args, **kw) if mesh is None else
                   tpm.tp_decode_chunk_slots(params, cfg, mesh, *args, **kw))
            toks, n_new = out[4].numpy(), (pos - before).numpy()
        for b in range(B):
            streams[b].extend(int(t) for t in toks[b, :n_new[b]])
    return streams


def pool_streams(tp: int, spec: bool, mesh=None) -> list[list[int]]:
    """The pool's streams over the q8_0 weights of seed 71."""
    cfg = Qwen2DecoderConfig(**pool_cfg(tp))
    params = decoder_params(71, pool_cfg(tp), "q8_0")
    if mesh is not None:
        from qwen2_audio_tpu_torch.parallel.tp import shard_decoder_for_tp
        params = shard_decoder_for_tp(params, mesh)
    return _pool_run(params, cfg, tp, mesh, spec)


def serve_segments(ckpt: bytes, mesh=None) -> list:
    """transcribe_continuous over ``serve_audio`` with a random unfused
    bundle (seed 3, ``CFG``): sorted (t0, tokens) of its segments."""
    from qwen2_audio_tpu_torch.models.qwen2_audio import random_bundle
    from qwen2_audio_tpu_torch.runtime.context import (ContextParams, FullParams,
                                                       WhisperContext)
    from qwen2_audio_tpu_torch.runtime.serving import transcribe_continuous
    ctx = WhisperContext.init_from_buffer_with_params(ckpt, ContextParams(use_gpu=False))
    ctx.decoder = random_bundle(np.random.default_rng(3), Qwen2DecoderConfig(**CFG),
                                enc_state=64, max_ctx=512, fuse=False)
    p = FullParams(max_new_tokens=6, temperature_inc=0.0, speculative_k=5)
    return sorted((s.t0_cs, tuple(s.tokens)) for s in transcribe_continuous(
        ctx, serve_audio(), p, max_streams=2, chunk_tokens=3, mesh=mesh))


def tp_world(rank: int, world: int, ckpt: bytes) -> dict:
    """tp = world: the forward of every weight form, the int8 cache, per-
    stream positions (tp = 2), the slot pools, serving (tp = 2); ggml
    blocks in the exact dequantizing mode, the JAX package's on the CPU."""
    from qwen2_audio_tpu_torch.models.qwen2_decoder import embed_tokens
    from qwen2_audio_tpu_torch.ops.linear import set_group_matmul_mode
    set_group_matmul_mode("dequant")
    from qwen2_audio_tpu_torch.parallel.mesh import local_cache, make_mesh
    from qwen2_audio_tpu_torch.parallel.tp import shard_decoder_for_tp, tp_decoder_forward
    tp = world
    mesh = make_mesh(1, tp)
    cfgd = tp_cfg(tp)
    cfg = Qwen2DecoderConfig(**cfgd)
    out = {}
    x = embed_tokens(decoder_params(31, cfgd), torch.as_tensor(tokens(32, (2, 5))))
    for quant in QUANTS:
        sp = shard_decoder_for_tp(decoder_params(31, cfgd, quant), mesh)
        got, cache = tp_decoder_forward(sp, cfg, mesh, x, local_cache(cfg, 2, 16, mesh,
                                                                      torch.float32),
                                        0, block_only=True)
        out[f"forward {quant}"] = (_np(got), _np(cache.k))

    sp = shard_decoder_for_tp(decoder_params(51, cfgd, "q8_0"), mesh)
    x51 = embed_tokens(decoder_params(51, cfgd), torch.as_tensor(tokens(52, (2, 5))))
    got, _ = tp_decoder_forward(sp, cfg, mesh, x51, local_cache(cfg, 2, 16, mesh, "q8"), 0,
                                block_only=True)
    out["q8 cache"] = _np(got)

    if tp == 2:
        dense = decoder_params(41, cfgd)
        sp = shard_decoder_for_tp(decoder_params(41, cfgd, "q8_0"), mesh)
        xp = embed_tokens(dense, torch.as_tensor(tokens(42, (2, 6))))
        x1 = embed_tokens(dense, torch.as_tensor(tokens(43, (2, 1))))
        cache = local_cache(cfg, 2, 16, mesh, torch.float32)
        _, cache = tp_decoder_forward(sp, cfg, mesh, xp, cache, 0, block_only=True)
        got, _ = tp_decoder_forward(sp, cfg, mesh, x1, cache,
                                    torch.tensor([6, 3], dtype=torch.int32))
        out["vec pos"] = _np(got)
        out["serve"] = serve_segments(ckpt, mesh)
    for spec in (False, True):
        out[f"pool spec={spec}"] = pool_streams(tp, spec, mesh)
    out["jax_free"] = _jax_free()
    return out


def train_world(rank: int, world: int) -> dict:
    """A 2 x 2 (dp, tp) train step: two steps' losses, the first step's
    gradients of this rank's shard, by path."""
    from qwen2_audio_tpu_torch.parallel.mesh import coords, local_batch, make_mesh
    from qwen2_audio_tpu_torch.training.step import adamw, init_train_state, make_train_step
    mesh = make_mesh(2, 2)
    cfg = train_cfg()
    state = init_train_state(np.random.default_rng(0), cfg, adamw(1e-3), mesh=mesh)
    step = make_train_step(cfg, adamw(1e-3), mesh=mesh)
    batch = [local_batch(torch.from_numpy(a), mesh) for a in train_batch()]
    state, loss1 = step(state, *batch)
    grads = {k: _np(v.grad) for k, v in flat(state.params).items()}
    state, loss2 = step(state, *batch)
    return {"losses": [loss1, loss2], "grads": grads, "tp_rank": coords(mesh, "tp")[0],
            "dp_rank": coords(mesh, "dp")[0], "jax_free": _jax_free()}


def fail_on_rank1(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("planted failure")
    return rank


def sleep_forever(rank: int, world: int) -> None:
    import time
    time.sleep(3600)
