"""The port's training subsystem (qwen2_audio_tpu_torch/training) against
the JAX package's (qwen2_audio_tpu/training), after tests/test_parallel.py
and tests/test_data_pipeline.py, on the CPU in float32:

- the first step's gradients against ``jax.grad`` of JAX's ``loss_fn``
  (atol 1e-5, rtol 1e-4) and three steps' losses against JAX's
  ``train_step`` (rtol 1e-4);
- ``torch.optim.AdamW`` (``step.adamw``) against ``optax.adamw(1e-3)`` fed
  the same gradients (1e-6): compared on the same gradients, because
  Adam's first step is about lr * sign(g), so roundoff in a tiny gradient
  would flip an update by 2 lr;
- the dp x tp = 2 x 2 step (tests/test_torch_dist_workers.py::train_world,
  4 spawned gloo ranks) against the single-process step: losses (rtol
  1e-5) and every gradient gathered from its shards (atol 1e-6, rtol
  1e-4; the dp sum and the all-reduces add in their own order);
- the data loader's pairs, batch order, mels (the port's numpy mel against
  JAX's, 1e-3 after normalisation), error surfacing and early break;
- a checkpoint round trip and the exported encoder read back;
- the fine-tune example's ``main`` on the CPU.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_dist_workers as W
from qwen2_audio_tpu.audio import mel_filterbank as j_filterbank
from qwen2_audio_tpu.audio import write_wav
from qwen2_audio_tpu.config import Qwen2AudioConfig as JAC
from qwen2_audio_tpu.config import Qwen2DecoderConfig as JCfg
from qwen2_audio_tpu.config import WhisperHParams as JHP
from qwen2_audio_tpu.training import data as jdata
from qwen2_audio_tpu.training import step as jstep
from qwen2_audio_tpu_torch.audio import mel_filterbank
from qwen2_audio_tpu_torch.parallel.launch import spawn_world
from qwen2_audio_tpu_torch.parallel.mesh import decoder_param_spec, encoder_param_spec
from qwen2_audio_tpu_torch.training import checkpoint as tck
from qwen2_audio_tpu_torch.training import data as tdata
from qwen2_audio_tpu_torch.training import step as tstep

JCFG = JAC(audio=JHP(**W.AUDIO), text=JCfg(**W.TEXT))
LR = 1e-3


def _batch_t():
    mel, toks, mask = W.train_batch()
    return torch.from_numpy(mel), torch.from_numpy(toks), torch.from_numpy(mask)


def _batch_j():
    mel, toks, mask = W.train_batch()
    return jnp.asarray(mel), jnp.asarray(toks.astype(np.int32)), jnp.asarray(mask)


def _jax_flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = leaf
    return out


def test_first_step_gradients_match_jax():
    jst = jstep.init_train_state(np.random.default_rng(0), JCFG, optax.adamw(LR))
    jloss, jgrads = jax.value_and_grad(jstep.loss_fn)(jst.params, JCFG, *_batch_j())
    st = tstep.init_train_state(np.random.default_rng(0), W.train_cfg(), tstep.adamw(LR))
    loss = tstep.loss_fn(st.params, W.train_cfg(), *_batch_t())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    got = {k: v.grad.numpy() for k, v in W.flat(st.params).items()}
    want = _jax_flat(jgrads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def test_three_step_losses_match_jax():
    opt = optax.adamw(LR)
    jst = jstep.init_train_state(np.random.default_rng(0), JCFG, opt)
    jtrain = jstep.make_train_step(JCFG, opt)
    st = tstep.init_train_state(np.random.default_rng(0), W.train_cfg(), tstep.adamw(LR))
    train = tstep.make_train_step(W.train_cfg(), tstep.adamw(LR))
    want, got = [], []
    for _ in range(3):
        jst, jl = jtrain(jst, *_batch_j())
        st, tl = train(st, *_batch_t())
        want.append(float(jl))
        got.append(tl)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and st.step == 3


def test_adamw_matches_optax():
    """The same gradients through both optimizers, three steps, the
    updated parameters within 1e-6 (weight decay 1e-4 on every leaf)."""
    r = np.random.default_rng(9)
    p0 = [r.standard_normal(s).astype(np.float32) for s in ((7, 5), (11,))]
    grads = [[r.standard_normal(p.shape).astype(np.float32) for p in p0] for _ in range(3)]
    opt = optax.adamw(LR)
    jp = [jnp.asarray(p) for p in p0]
    js = opt.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    topt = tstep.adamw(LR)(tp)
    for g in grads:
        upd, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        topt.step()
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)
    assert topt.defaults["weight_decay"] == 1e-4


@pytest.fixture(scope="module")
def train_world():
    return spawn_world(W.train_world, 4, timeout=W.WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def single_step():
    st = tstep.init_train_state(np.random.default_rng(0), W.train_cfg(), tstep.adamw(LR))
    train = tstep.make_train_step(W.train_cfg(), tstep.adamw(LR))
    st, l1 = train(st, *_batch_t())
    grads = {k: v.grad.numpy().copy() for k, v in W.flat(st.params).items()}
    st, l2 = train(st, *_batch_t())
    return [l1, l2], grads


def test_dp_tp_step_losses_match_single_process(train_world, single_step):
    losses, _ = single_step
    for r in train_world:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    jst = jstep.init_train_state(np.random.default_rng(0), JCFG, optax.adamw(LR))
    _, jl = jstep.make_train_step(JCFG, optax.adamw(LR))(jst, *_batch_j())
    np.testing.assert_allclose(train_world[0]["losses"][0], float(jl), rtol=1e-4)
    assert all(r["jax_free"] for r in train_world)


def test_dp_tp_step_gradients_match_single_process(train_world, single_step):
    """Each leaf's gradient, its tp shards put together, equals the
    single-process gradient over the global batch; both dp groups hold the
    same (summed) gradients."""
    _, grads = single_step
    params = tstep.random_params(np.random.default_rng(0), W.train_cfg())
    spec = W.flat({"encoder": encoder_param_spec(params["encoder"]), "proj_w": None,
                   "proj_b": None, "decoder": decoder_param_spec(params["decoder"])})
    by = {(r["dp_rank"], r["tp_rank"]): r["grads"] for r in train_world}
    for path, want in grads.items():
        for dp in (0, 1):
            parts = [by[dp, t][path] for t in (0, 1)]
            s = spec[path]
            got = parts[0] if s is None else np.concatenate(parts, axis=s.axis)
            if s is None:
                np.testing.assert_array_equal(parts[0], parts[1], err_msg=path)
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=path)


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #

HP = dict(n_vocab=64, n_audio_ctx=64, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
          n_mels=16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for i in range(5):
        t = np.arange(16000) / 16000
        sig = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        write_wav(str(d / f"clip{i}.wav"), sig.astype(np.float32))
        (d / f"clip{i}.txt").write_text(f"transcript {i}")
    (d / "orphan.wav").write_bytes((d / "clip0.wav").read_bytes())
    return d


def _tok(s):
    return [ord(c) % 60 for c in s][:8]


def _loaders(corpus, **kw):
    jds = jdata.AudioTextDataset(jdata.discover_pairs(corpus), JHP(**HP), j_filterbank(16),
                                 tokenize=_tok, use_native=False)
    tds = tdata.AudioTextDataset(tdata.discover_pairs(corpus), W.WhisperHParams(**HP),
                                 mel_filterbank(16), tokenize=_tok)
    return jdata.PrefetchLoader(jds, **kw), tdata.PrefetchLoader(tds, **kw)


def test_discover_pairs_match_jax(corpus):
    want = [(e.audio_path, e.text) for e in jdata.discover_pairs(corpus)]
    assert [(e.audio_path, e.text) for e in tdata.discover_pairs(corpus)] == want
    assert len(want) == 5


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_jax(corpus, drop_last):
    """The same deterministic batch order, tokens and masks as JAX's loader
    (seeded permutation, any number of workers), the mels within 1e-3."""
    jl, tl = _loaders(corpus, batch_size=2, num_workers=3, seed=1, drop_last=drop_last)
    want, got = list(jl), list(tl)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for (jm, jt, jk), (m, t, k) in zip(want, got):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(k, jk)
        assert m.shape == jm.shape == (len(t), 16, 128)
        np.testing.assert_allclose(m, jm, atol=1e-3, rtol=0)


def test_loader_surfaces_errors_and_stops_on_break(corpus):
    class Broken(tdata.AudioTextDataset):
        def load(self, idx):
            if idx == 3:
                raise OSError("unreadable clip")
            return super().load(idx)

    ds = Broken(tdata.discover_pairs(corpus), W.WhisperHParams(**HP), mel_filterbank(16),
                tokenize=_tok)
    with pytest.raises(RuntimeError, match="worker failed") as e:
        list(tdata.PrefetchLoader(ds, batch_size=1, num_workers=2, seed=0))
    assert isinstance(e.value.__cause__, OSError)
    before = threading.active_count()
    ok = tdata.AudioTextDataset(tdata.discover_pairs(corpus), W.WhisperHParams(**HP),
                                mel_filterbank(16), tokenize=_tok)
    for _ in tdata.PrefetchLoader(ok, batch_size=1, num_workers=2, prefetch=1):
        break
    assert threading.active_count() == before
    # the native wav reader and mel (or their host fallbacks) give the same
    # example as the default host path
    native = tdata.AudioTextDataset(tdata.discover_pairs(corpus), W.WhisperHParams(**HP),
                                    mel_filterbank(16), _tok, use_native=True)
    (nm, nt), (pm, pt) = native.load(0), ok.load(0)
    assert nt == pt
    np.testing.assert_allclose(nm, pm, atol=1e-3, rtol=0)


# --------------------------------------------------------------------------- #
# checkpoints and export
# --------------------------------------------------------------------------- #

def test_checkpoint_round_trip(tmp_path):
    cfg = W.train_cfg()
    st = tstep.init_train_state(np.random.default_rng(0), cfg, tstep.adamw(LR))
    train = tstep.make_train_step(cfg, tstep.adamw(LR))
    st, _ = train(st, *_batch_t())
    tck.save_train_state(tmp_path, st, step=1)
    st, _ = train(st, *_batch_t())
    path = tck.save_train_state(tmp_path, st)
    assert path.name == "step_00000002"
    want = {k: v.detach().clone() for k, v in W.flat(st.params).items()}
    moments = {k: v["exp_avg"].clone() for k, v in st.opt_state.state_dict()["state"].items()}

    fresh = tstep.init_train_state(np.random.default_rng(1), cfg, tstep.adamw(LR))
    back = tck.restore_train_state(tmp_path, fresh)          # the newest step
    assert back.step == 2
    for k, v in W.flat(back.params).items():
        torch.testing.assert_close(v.detach(), want[k], atol=0, rtol=0)
    for k, v in back.opt_state.state_dict()["state"].items():
        torch.testing.assert_close(v["exp_avg"], moments[k], atol=0, rtol=0)
    # training goes on from the restored state as from the saved one
    _, l_back = train(back, *_batch_t())
    _, l_saved = train(st, *_batch_t())
    assert l_back == l_saved
    assert tck.restore_train_state(tmp_path, fresh, step=1).step == 1
    with pytest.raises(FileNotFoundError):
        tck.restore_train_state(tmp_path / "empty", fresh)


def test_export_encoder_reads_back(tmp_path):
    from qwen2_audio_tpu_torch.io.ggml_format import read_ggml_file
    from qwen2_audio_tpu_torch.models.encoder import encoder_params_from_ggml
    cfg = W.train_cfg()
    st = tstep.init_train_state(np.random.default_rng(0), cfg, tstep.adamw(LR))
    out = tmp_path / "tuned.bin"
    tck.export_encoder_to_ggml(str(out), st, cfg.audio, mel_filterbank(16), [b"x"] * 60)
    back = encoder_params_from_ggml(read_ggml_file(str(out)))
    want = W.flat(st.params["encoder"])
    got = W.flat(back)
    assert set(got) <= set(want) and "layers/1/fc2/w" in got
    for k, v in got.items():
        torch.testing.assert_close(v.float(), want[k].detach().float(), atol=1e-4, rtol=1e-3)


def test_finetune_main_on_cpu(corpus, tmp_path, capsys):
    from qwen2_audio_tpu_torch.training.finetune import main
    out = tmp_path / "ft.bin"
    assert main([str(corpus), str(out), "2", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "epoch 1: loss" in text and out.stat().st_size > 0
