"""The port's mesh, sharding rules and distributed helpers
(qwen2_audio_tpu_torch/parallel) against the JAX package's, after
tests/test_parallel.py: the spec of every leaf, dense and quantized, equal
to the JAX rules' split axis; the dp x tp = 2 x 2 sharded decoder (float32
and int8 caches) and encoder forwards against JAX's single-device ones;
the distributed helpers in a 4-rank gloo world.

The world's ranks run tests/test_torch_dist_workers.py::parallel_world
(spawned, so they import no JAX), through parallel.launch.spawn_world with
a deadline. Tolerances are tests/test_parallel.py's: decoder logits 1e-4
(atol and rtol), the int8-cache decode atol 1e-4 rtol 1e-3, the encoder
atol 2e-4 rtol 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import test_torch_dist_workers as W
from qwen2_audio_tpu.config import GGMLType as JGGMLType
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.models import encoder as jenc
from qwen2_audio_tpu.models import qwen2_decoder as jdec
from qwen2_audio_tpu.parallel import mesh as jmesh
from qwen2_audio_tpu.quant.qparams import quantize_decoder_params as j_quantize
from qwen2_audio_tpu_torch.models.encoder import fuse_encoder_qkv, random_encoder_params
from qwen2_audio_tpu_torch.parallel import distributed as tdist
from qwen2_audio_tpu_torch.parallel import mesh as tmesh
from qwen2_audio_tpu_torch.parallel.launch import spawn_world


@pytest.fixture(scope="module")
def world():
    return spawn_world(W.parallel_world, 4, timeout=W.WORLD_TIMEOUT)


def _jax_axis(spec, ndim: int):
    """The JAX spec's "tp" axis counted from the last (negative), or None."""
    full = [None] * (ndim - len(spec)) + list(spec)
    return full.index("tp") - ndim if "tp" in full else None


def _flat_jax(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_jax(sub, f"{path}/{key}" if path else str(key)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat_jax(sub, f"{path}/{i}").items()}
    return {path: tree}


def _same_split_axes(jparams, jspec, tspec, fused_parts=()):
    """Every leaf's split axis equal between the two packages' rules."""
    leaves = _flat_jax(jparams)
    js = _flat_jax(jspec)
    ts = W.flat(tspec)
    assert set(ts) == set(leaves) == set(js)
    for path, leaf in leaves.items():
        want = _jax_axis(js[path], np.ndim(leaf))
        got = ts[path]
        assert (got.axis if got is not None else None) == want, path
        if got is not None:
            assert got.parts == (3 if any(f in path for f in fused_parts) else 1), path


def test_mesh_creation(world):
    assert all(r["mesh_shape"] == {"dp": 2, "tp": 2} for r in world)
    assert [r["coords"] for r in world] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all("mesh 4x4 needs 16 devices, have 4" in r["make_mesh_4x4"] for r in world)
    with pytest.raises(ValueError, match="needs 16 devices, have 1"):
        tmesh.make_mesh(dp=4, tp=4)
    with pytest.raises(ValueError, match="initialized world"):
        tmesh.make_mesh(dp=1, tp=1)


def test_decoder_spec_covers_all_leaves():
    jp = jdec.random_decoder_params(np.random.default_rng(0), JCfg(**W.TEXT))
    tp = W.decoder_params(0, W.TEXT)
    spec = tmesh.decoder_param_spec(tp)
    _same_split_axes(jp, jmesh.decoder_param_spec(jp), spec)
    assert spec["layers"]["q"]["w"] == tmesh.COL and spec["layers"]["o"]["w"] == tmesh.ROW
    assert spec["layers"]["ln1"]["w"] is None and spec["lm_head"]["w"] == tmesh.COL


@pytest.mark.parametrize("quant", ["q8_0", "q4_0", "fast"])
def test_quantized_decoder_spec(quant):
    dense = jdec.random_decoder_params(np.random.default_rng(0), JCfg(**W.TEXT))
    jp = (j_quantize(dense, JGGMLType.Q8_0, mode="fast") if quant == "fast"
          else j_quantize(dense, JGGMLType[quant.upper()]))
    tp = W.decoder_params(0, W.TEXT, quant)
    _same_split_axes(jp, jmesh.decoder_param_spec(jp), tmesh.decoder_param_spec(tp))


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_spec_covers_all_leaves(fused):
    hp = W.AUDIO
    jp = jenc.random_encoder_params(np.random.default_rng(0), JHP(**hp))
    tp = random_encoder_params(np.random.default_rng(0), W.train_cfg().audio)
    if fused:
        jp, tp = jenc.fuse_encoder_qkv(jp), fuse_encoder_qkv(tp)
    _same_split_axes(jp, jmesh.encoder_param_spec(jp), tmesh.encoder_param_spec(tp),
                     fused_parts=("qkv",))


def test_local_shard_layouts():
    """Rank 1 of 2: column leaves keep the second half of N, row leaves the
    second half of K, replicated leaves the whole; a fused encoder qkv the
    second half of each third; w8a8 weights stay K-major."""
    p = W.decoder_params(0, W.TEXT)
    sh = tmesh.local_shard(p, tmesh.decoder_param_spec(p), 1, 2)
    torch.testing.assert_close(sh["layers"]["q"]["w"], p["layers"]["q"]["w"][..., 32:])
    torch.testing.assert_close(sh["layers"]["q"]["b"], p["layers"]["q"]["b"][..., 32:])
    torch.testing.assert_close(sh["layers"]["o"]["w"], p["layers"]["o"]["w"][:, 32:])
    torch.testing.assert_close(sh["lm_head"]["w"], p["lm_head"]["w"][:, 64:])
    assert sh["embed"] is p["embed"] and sh["layers"]["q"]["w"].is_contiguous()
    w8 = tmesh.local_shard(W.decoder_params(0, W.TEXT, "fast"),
                           tmesh.decoder_param_spec(W.decoder_params(0, W.TEXT, "fast")), 0, 2)
    assert w8["layers"]["gate"]["qs8"].stride(-2) == 1          # K-major
    assert w8["layers"]["down"]["scale_n"].shape[-1] == 64      # replicated
    enc = fuse_encoder_qkv(random_encoder_params(np.random.default_rng(0),
                                                 W.train_cfg().audio))
    e = tmesh.local_shard(enc, tmesh.encoder_param_spec(enc), 1, 2)
    w = enc["layers"][0]["qkv"]["w"]
    torch.testing.assert_close(e["layers"][0]["qkv"]["w"],
                               torch.cat([w[:, 32:64], w[:, 96:128], w[:, 160:192]], 1))
    torch.testing.assert_close(e["layers"][0]["o"]["b"], enc["layers"][0]["o"]["b"])


def test_row_split_falls_on_block_boundaries():
    """A row split of ggml blocks must keep whole 32-row groups: o's K = 64
    splits in two, not in four; the word-packed q4_0 form has no rule."""
    p = W.decoder_params(0, W.TEXT, "q8_0")
    spec = tmesh.decoder_param_spec(p)
    tmesh.local_shard(p, spec, 0, 2)
    with pytest.raises(ValueError, match="32-row block boundaries"):
        tmesh.local_shard(p, spec, 0, 4)
    from qwen2_audio_tpu_torch.quant.qparams import Q4Form, quantize_decoder_params
    from qwen2_audio_tpu_torch.config import GGMLType
    b32 = quantize_decoder_params(W.decoder_params(0, W.TEXT), GGMLType.Q4_0,
                                  form=Q4Form(b32=True))
    with pytest.raises(ValueError, match="qs4b"):
        tmesh.decoder_param_spec(b32)


def test_cache_specs_match_jax():
    assert tmesh.kv_cache_spec()["k"] == (None, "dp", None, "tp", None)
    assert tmesh.quant_kv_cache_spec()["k_s"] == (None, "dp", None, "tp")
    j = jmesh.kv_cache_spec()
    assert tuple(j.k) == tmesh.kv_cache_spec()["k"]
    jq = jmesh.quant_kv_cache_spec()
    assert tuple(jq.v_s) == tmesh.quant_kv_cache_spec()["v_s"]


def test_sharded_decoder_forward_matches_single(world):
    """dp x tp = 2 x 2: each dp group's two tp ranks give the same logits,
    and the dp slices together equal JAX's unsharded forward."""
    jp = jdec.random_decoder_params(np.random.default_rng(11), JCfg(**W.TEXT))
    x = jdec.embed_tokens(jp, jnp.asarray(W.tokens(12, (4, 6))))
    want, _ = jdec.decoder_forward(jp, JCfg(**W.TEXT), x,
                                   jdec.KVCache.create(JCfg(**W.TEXT), 4, 8,
                                                       dtype=jnp.float32), 0)
    np.testing.assert_array_equal(world[0]["decoder"], world[1]["decoder"])
    np.testing.assert_array_equal(world[2]["decoder"], world[3]["decoder"])
    got = np.concatenate([world[0]["decoder"], world[2]["decoder"]])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    assert all(r["decoder_pos"] == 6 for r in world)


def test_sharded_quant_cache_decode(world):
    """dp x tp decode over the int8 cache (kv heads split over tp) matches
    JAX's unsharded result."""
    jp = jdec.random_decoder_params(np.random.default_rng(11), JCfg(**W.TEXT))
    x = jdec.embed_tokens(jp, jnp.asarray(W.tokens(12, (4, 6))))[:, :5]
    want, _ = jdec.decoder_forward(jp, JCfg(**W.TEXT), x,
                                   jdec.create_cache(JCfg(**W.TEXT), 4, 8, dtype="q8"), 0)
    got = np.concatenate([world[0]["decoder_q8_cache"], world[2]["decoder_q8_cache"]])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("name", ["encoder", "encoder_fused"])
def test_sharded_encoder_forward_matches_single(world, name):
    jp = jenc.random_encoder_params(np.random.default_rng(13), JHP(**W.AUDIO))
    mel = np.random.default_rng(14).standard_normal((4, 16, 64)).astype(np.float32)
    want = np.asarray(jenc.encoder_forward(jp, jnp.asarray(mel), JHP(**W.AUDIO)))
    got = np.concatenate([world[0][name], world[2][name]])
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_array_equal(world[0][name], world[1][name])


def test_distributed_single_process(monkeypatch):
    """Nothing configured: initialize is a no-op; one process is P = 1."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize() is False
    assert not tdist.is_distributed() and tdist.world_size() == 1
    g = tdist.process_allgather(np.array([3.0]))
    assert g.shape == (1, 1) and g[0, 0] == 3.0
    with pytest.raises(ValueError, match="does not divide 1 global devices"):
        tdist.global_mesh(tp=2)
    with pytest.raises(ValueError, match="must all be given"):
        tdist.initialize(world_size=2)


def test_distributed_world(world):
    """initialize is idempotent, global_mesh keeps the JAX divisibility
    error, the host-local batches make one global batch, process_allgather
    stacks every rank's array; no rank imported JAX."""
    assert all(r["initialize_again"] and r["is_distributed"] for r in world)
    assert all(r["global_mesh_shape"] == {"dp": 2, "tp": 2} for r in world)
    assert all("tp=3 does not divide 4 global devices" in r["global_mesh_tp3"] for r in world)
    want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 100 * d
                           for d in (0, 1)])
    for r in world:
        np.testing.assert_array_equal(r["global_batch"], want)
        np.testing.assert_array_equal(r["allgather"], [[0.0], [1.5], [3.0], [4.5]])
    assert all(r["jax_free"] for r in world)


def test_spawn_world_deadline_and_errors():
    """A rank that raises fails the world with its traceback; a world past
    its deadline is killed and raises."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*planted failure"):
        spawn_world(W.fail_on_rank1, 2, timeout=60)
    with pytest.raises(TimeoutError, match="did not finish within 15 s"):
        spawn_world(W.sleep_forever, 2, timeout=15)
