"""The port's HF checkpoint loader (io/hf.py), parameter disk cache
(io/param_cache.py) and cache location (utils/cache.py) against the JAX
package's and against transformers' own model (CPU). The tiny Qwen2-Audio
is written by transformers' ``save_pretrained`` into a temporary directory,
as safetensors and as a torch ``.bin``; nothing is downloaded.

Tolerances: loaded parameters equal the JAX loader's after the dtype cast
(bit for bit), quantized leaves too; the encoder output against the HF
audio tower at the JAX test's atol 2e-4 / rtol 1e-3 (two frameworks'
float32 sums); greedy tokens equal HF's ``generate``; float32 logits of the
quantized decoders against JAX's at 1e-4."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.io import hf as jhf
from qwen2_audio_tpu.io import param_cache as jpc
from qwen2_audio_tpu.models import qwen2_decoder as jd
from qwen2_audio_tpu.ops import linear as jl
from qwen2_audio_tpu_torch.config import GGMLType
from qwen2_audio_tpu_torch.convert import quant_params_from_jax
from qwen2_audio_tpu_torch.io import hf as thf
from qwen2_audio_tpu_torch.io import param_cache as tpc
from qwen2_audio_tpu_torch.models import qwen2_decoder as td
from qwen2_audio_tpu_torch.models.encoder import encoder_forward
from qwen2_audio_tpu_torch.ops import linear as tl
from qwen2_audio_tpu_torch.utils import cache as tcache

CPU = torch.device("cpu")
F32 = dict(dtype=torch.float32, cache_dtype=torch.float32, device="cpu")
J32 = dict(dtype=jnp.float32, cache_dtype=jnp.float32)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def hf_dir(request, tmp_path_factory):
    from transformers import (Qwen2AudioConfig, Qwen2AudioEncoderConfig,
                              Qwen2AudioForConditionalGeneration)
    from transformers.models.qwen2.configuration_qwen2 import Qwen2Config

    audio = Qwen2AudioEncoderConfig(d_model=64, encoder_attention_heads=4, encoder_layers=2,
                                    num_mel_bins=16, max_source_positions=1500,
                                    encoder_ffn_dim=256)
    text = Qwen2Config(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       rope_theta=1_000_000.0, tie_word_embeddings=False)
    cfg = Qwen2AudioConfig(audio_config=audio.to_dict(), text_config=text.to_dict(),
                           audio_token_index=120)
    torch.manual_seed(11)
    model = Qwen2AudioForConditionalGeneration(cfg).eval()
    d = tmp_path_factory.mktemp(f"hf_qwen2audio_{request.param}")
    model.save_pretrained(str(d), safe_serialization=request.param == "safetensors")
    names = os.listdir(d)
    assert any(n.endswith(".bin" if request.param == "bin" else ".safetensors")
               for n in names), names
    return str(d), model


def _same_tree(jtree, ttree, what):
    want = quant_params_from_jax(jax.tree.map(np.asarray, jtree))
    jl_ = jax.tree_util.tree_leaves_with_path(want)
    tl_ = jax.tree_util.tree_leaves_with_path(ttree)
    assert [p for p, _ in jl_] == [p for p, _ in tl_], what
    for (path, a), (_, b) in zip(jl_, tl_):
        assert a.dtype == b.dtype, (what, path)
        assert torch.equal(a, b.cpu()), (what, path)


def test_load_matches_jax_and_hf_tower(hf_dir, rng):
    path, hf_model = hf_dir
    want = jhf.load_qwen2_audio(path, **J32)
    got = thf.load_qwen2_audio(path, **F32)
    assert dataclasses.asdict(got["hparams"]) == dataclasses.asdict(want["hparams"])
    assert dataclasses.asdict(got["decoder_config"]) == dataclasses.asdict(
        want["decoder_config"])
    assert got["hparams"].n_audio_state == 64 and got["hparams"].n_audio_layer == 2
    _same_tree(want["encoder_params"], got["encoder_params"], "encoder")
    jb, tb = want["bundle"], got["bundle"]
    _same_tree(jb.params, tb.params, "decoder")
    assert "qkv" in tb.params["layers"]
    assert np.array_equal(tb.proj_w.numpy(), np.asarray(jb.proj_w))
    assert np.array_equal(tb.proj_b.numpy(), np.asarray(jb.proj_b))
    assert (tb.eos_token_id, tb.max_ctx) == (jb.eos_token_id, jb.max_ctx)
    assert got["tokenizer"] is None and tb.device == CPU

    mel = rng.standard_normal((1, 16, 3000)).astype(np.float32)
    with torch.no_grad():
        ref = hf_model.audio_tower(torch.from_numpy(mel)).last_hidden_state.numpy()
    out = encoder_forward(got["encoder_params"], torch.from_numpy(mel), got["hparams"])
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-3)

    # bf16 on request: the same values, cast
    b16 = thf.load_qwen2_audio(path, dtype=torch.bfloat16, device="cpu")
    assert b16["bundle"].params["embed"].dtype == torch.bfloat16
    assert torch.equal(b16["encoder_params"]["pos"],
                       got["encoder_params"]["pos"].to(torch.bfloat16))


def test_generation_matches_hf(hf_dir, rng):
    from qwen2_audio_tpu_torch.runtime.decoding import greedy_decode
    path, hf_model = hf_dir
    loaded = thf.load_qwen2_audio(path, **F32)
    bundle = loaded["bundle"]
    mel = rng.standard_normal((1, 16, 3000)).astype(np.float32)
    enc = encoder_forward(loaded["encoder_params"], torch.from_numpy(mel), loaded["hparams"])
    audio = bundle.project_audio(enc[0])
    prompt = np.asarray([[5, 9, 17]])
    with torch.no_grad():
        hf_audio = hf_model.multi_modal_projector(
            hf_model.audio_tower(torch.from_numpy(mel)).last_hidden_state)
        emb = hf_model.get_input_embeddings()(torch.from_numpy(prompt))
        want = hf_model.language_model.generate(
            inputs_embeds=torch.cat([hf_audio, emb], dim=1), max_new_tokens=8,
            do_sample=False, eos_token_id=None, pad_token_id=0)[0].numpy()
    prefill = torch.cat([audio[None], td.embed_tokens(bundle.params, torch.from_numpy(prompt))],
                        dim=1)
    got = greedy_decode(bundle, prefill, max_new_tokens=8)
    assert got.tokens[0] == want[:8].tolist()


@pytest.mark.parametrize("quant,fuse", [("q8_0", True), ("q8_0", False), ("w8a8", True),
                                        ("q4_0", True)])
def test_load_with_decoder_quant_matches_jax(hf_dir, quant, fuse):
    """Each ``decoder_quant`` gives JAX's leaves (q8_0, w8a8; fused and not)
    or, for q4_0 (whose JAX payload form follows process defaults), JAX's
    logits; q4_0 is panelized by default; q8_0's greedy first token is the
    dense decoder's."""
    path, _ = hf_dir
    got = thf.load_qwen2_audio(path, decoder_quant=quant, fuse=fuse, **F32)
    want = jhf.load_qwen2_audio(path, decoder_quant=quant, fuse=fuse, **J32)
    layers = got["bundle"].params["layers"]
    key = {"q8_0": "qs", "w8a8": "qs8", "q4_0": "qs4_p"}[quant]
    assert key in layers["qkv" if fuse else "q"]
    if quant != "q4_0":
        _same_tree(want["bundle"].params, got["bundle"].params, quant)
    cfg = got["decoder_config"]
    x = np.random.default_rng(1).standard_normal((1, 5, 64)).astype(np.float32)
    jl.set_group_matmul_mode("dequant")
    tl.set_group_matmul_mode("dequant")
    try:
        jc = jd.create_cache(want["decoder_config"], 1, 8, dtype=jnp.float32)
        wl, _ = jd.decoder_forward(want["bundle"].params, want["decoder_config"],
                                   jnp.asarray(x), jc, 0)
        tc = td.create_cache(cfg, 1, 8, dtype=torch.float32)
        gl, _ = td.decoder_forward(got["bundle"].params, cfg, torch.from_numpy(x), tc, 0)
    finally:
        jl.set_group_matmul_mode(None)
        tl.set_group_matmul_mode(None)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=LOGIT_ATOL, rtol=0)
    if quant == "q8_0":
        from qwen2_audio_tpu_torch.runtime.decoding import greedy_decode
        fp = thf.load_qwen2_audio(path, **F32)["bundle"]
        a = greedy_decode(fp, torch.from_numpy(x), max_new_tokens=4)
        b = greedy_decode(got["bundle"], torch.from_numpy(x), max_new_tokens=4)
        assert a.tokens[0][0] == b.tokens[0][0]


def test_load_defaults_to_the_card_and_checks_args(hf_dir, tmp_path):
    path, _ = hf_dir
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            thf.load_qwen2_audio(path)
    with pytest.raises(ValueError, match="decoder_quant"):
        thf.load_qwen2_audio(path, decoder_quant="q5_0", device="cpu")
    with pytest.raises(FileNotFoundError):
        thf._load_state_dict(tmp_path)
    hp, dec = thf.hparams_from_hf_config({})
    jhp, jdec = jhf.hparams_from_hf_config({})
    assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert dataclasses.asdict(dec) == dataclasses.asdict(jdec)
    assert (hp.n_audio_state, dec.hidden_size, dec.head_dim) == (1280, 3584, 128)


def _quant_tree():
    from qwen2_audio_tpu_torch.config import Qwen2DecoderConfig
    from qwen2_audio_tpu_torch.quant.qparams import quantize_decoder_params
    cfg = Qwen2DecoderConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                             num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, head_dim=16, tie_word_embeddings=False)
    p = td.random_decoder_params(np.random.default_rng(0), cfg)
    p["_aux"] = [torch.arange(3), {"x": torch.full((2,), 2.5)}]
    p["_bf16"] = torch.linspace(-2, 2, 16, dtype=torch.bfloat16).reshape(4, 4)
    p["_np"] = np.arange(4, dtype=np.int16)
    return quantize_decoder_params(p, GGMLType.Q8_0)


def test_param_cache_roundtrip(tmp_path):
    """The quantized tree (int8, float16 scales, bf16, int64, lists) round
    trips bit for bit through one .npz; cached_build builds once."""
    q = _quant_tree()
    path = str(tmp_path / "sub" / "cache.npz")
    tpc.save_pytree(path, q)
    assert not os.path.exists(path + ".tmp")
    r = tpc.load_pytree(path)
    a, b = jax.tree_util.tree_leaves_with_path(q), jax.tree_util.tree_leaves_with_path(r)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        x = torch.as_tensor(x)
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p
    assert isinstance(r["_aux"], list) and r["layers"]["q"]["qs"].dtype == torch.int8
    calls = []
    t1 = tpc.cached_build(path, lambda: calls.append(1) or q)
    assert not calls and torch.equal(t1["_bf16"], q["_bf16"])
    other = str(tmp_path / "built.npz")
    t2 = tpc.cached_build(other, lambda: calls.append(1) or q)
    assert calls == [1] and t2 is q and os.path.exists(other)
    with pytest.raises(ValueError):
        tpc.save_pytree(str(tmp_path / "bad.npz"), {"a\x1fb": torch.zeros(1)})


def test_param_cache_cross_reads_jax(tmp_path):
    """One layout: the JAX package reads the port's file and the port the
    JAX package's, bfloat16 included."""
    import ml_dtypes
    q = _quant_tree()
    path = str(tmp_path / "port.npz")
    tpc.save_pytree(path, q)
    j = jpc.load_pytree(path)
    assert j["_bf16"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(j["_bf16"].view(np.uint16),
                          q["_bf16"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(j["layers"]["q"]["qs"], q["layers"]["q"]["qs"].numpy())
    jtree = {"w": np.ones((3, 2), ml_dtypes.bfloat16), "l": [np.arange(2)],
             "s": np.float16([1.5])}
    jpath = str(tmp_path / "jax.npz")
    jpc.save_pytree(jpath, jtree)
    t = tpc.load_pytree(jpath)
    assert t["w"].dtype == torch.bfloat16 and torch.equal(t["w"], torch.ones(3, 2,
                                                                            dtype=torch.bfloat16))
    assert t["l"][0].tolist() == [0, 1] and t["s"].dtype == torch.float16


def test_param_cache_dir_root_and_seed(tmp_path):
    """The root is an argument (no environment variable); missing entries
    are seeded from older directories, present ones kept."""
    old = tmp_path / "old"
    old.mkdir()
    (old / "a.npz").write_bytes(b"A")
    (old / "b.npz").write_bytes(b"B")
    d = tcache.param_cache_dir(str(tmp_path / "root"), seed_from=(str(old),))
    assert d == str(tmp_path / "root" / "param_cache") and os.path.isdir(d)
    assert sorted(os.listdir(d)) == ["a.npz", "b.npz"]
    (old / "a.npz").write_bytes(b"changed")
    (tmp_path / "root" / "param_cache" / "b.npz").unlink()
    tcache._seed(d, str(old), str(tmp_path / "missing"))
    assert (tmp_path / "root" / "param_cache" / "b.npz").read_bytes() == b"B"
    assert tcache.DEFAULT_ROOT.endswith(os.path.join(".cache", "qwen2_audio_tpu_torch"))
    blocked = tmp_path / "file"
    blocked.write_bytes(b"")
    fb = tcache._ensure_dir(str(blocked / "x"), str(tmp_path / "fallback"))
    assert fb == str(tmp_path / "fallback") and os.path.isdir(fb)
