"""The port's debug utilities against the JAX package's, on the CPU:
utils/inspect_graph.py (per-node encoder intermediates, node by node against
the JAX encoder_intermediates on the same seeded weights; "ln_post" against
the port's encoder_forward; the divergence report), utils/watchdog.py
(watchdog / guarded: cancelled they never fire, uncancelled they end the
process) and utils/profiling.py (cost_analysis of a matmul equal to XLA's
cost model, the torch.profiler trace).

Tolerances: the port's nodes within NODE_ATOL (+ NODE_RTOL relative) of
JAX's (float32 on both sides, different summation orders); "ln_post"
within 1e-5 of encoder_forward, the JAX test's bound; cost counts equal."""

import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen2_audio_tpu.config import WhisperHParams as JHParams
from qwen2_audio_tpu.models.encoder import random_encoder_params as jrandom_params
from qwen2_audio_tpu.utils import inspect_graph as jinspect
from qwen2_audio_tpu_torch.config import GGMLType, WhisperHParams
from qwen2_audio_tpu_torch.models.encoder import encoder_forward, random_encoder_params
from qwen2_audio_tpu_torch.quant.qparams import quantize_array_for_device
from qwen2_audio_tpu_torch.utils import profiling
from qwen2_audio_tpu_torch.utils import watchdog as wd
from qwen2_audio_tpu_torch.utils.inspect_graph import (compare_runs, encoder_intermediates,
                                                       first_divergence)

HP = WhisperHParams(n_audio_ctx=128, n_audio_state=64, n_audio_head=4,
                    n_audio_layer=2, n_mels=16)
JHP = JHParams(n_audio_ctx=128, n_audio_state=64, n_audio_head=4,
               n_audio_layer=2, n_mels=16)
NODE_ATOL = 1e-4
NODE_RTOL = 1e-4
NODES = ["conv1", "conv2", "pos_add"] + [f"layer{i}.{n}" for i in range(2)
                                         for n in ("ln1", "attn", "fc1", "out")] + \
    ["avg_pool", "ln_post"]


def _mel(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((1, 16, 256)).astype(np.float32)


@pytest.mark.parametrize("gelu_approximate", [False, True])
def test_intermediates_match_jax_node_by_node(gelu_approximate):
    params = random_encoder_params(np.random.default_rng(0), HP)
    jparams = jrandom_params(np.random.default_rng(0), JHP)
    mel = _mel()
    got = encoder_intermediates(params, torch.from_numpy(mel), HP,
                                gelu_approximate=gelu_approximate)
    want = jinspect.encoder_intermediates(jparams, jnp.asarray(mel), JHP,
                                          gelu_approximate=gelu_approximate)
    assert list(got) == list(want) == NODES
    for name in NODES:
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=NODE_ATOL, rtol=NODE_RTOL,
                                   err_msg=name)
    report = compare_runs(got, want, rtol=NODE_RTOL, atol=NODE_ATOL)
    assert first_divergence(report) is None and len(report) == len(NODES)


def test_intermediates_match_forward():
    params = random_encoder_params(np.random.default_rng(0), HP)
    mel = torch.from_numpy(_mel())
    nodes = encoder_intermediates(params, mel, HP)
    want = encoder_forward(params, mel, HP, use_flash=True).numpy()
    np.testing.assert_allclose(nodes["ln_post"], want, atol=1e-5, rtol=0)
    assert "conv1" in nodes and "layer1.out" in nodes and "avg_pool" in nodes


def test_intermediates_bf16_are_float32_host_arrays():
    params = random_encoder_params(np.random.default_rng(0), HP)
    mel = torch.from_numpy(_mel())
    nodes = encoder_intermediates(params, mel, HP, compute_dtype=torch.bfloat16)
    want = encoder_forward(params, mel, HP, use_flash=True, compute_dtype=torch.bfloat16)
    assert all(v.dtype == np.float32 for v in nodes.values())
    np.testing.assert_array_equal(nodes["ln_post"], want.float().numpy())


def test_callback_invoked():
    params = random_encoder_params(np.random.default_rng(0), HP)
    seen = []
    encoder_intermediates(params, torch.from_numpy(_mel()), HP,
                          callback=lambda n, v: seen.append((n, type(v))))
    assert [n for n, _ in seen] == NODES
    assert seen[0][0] == "conv1" and seen[-1][0] == "ln_post"
    assert all(t is torch.Tensor for _, t in seen)


def test_compare_runs_finds_divergence():
    """Quantize only layer 1's fc1 to q4_0 -> the first divergence is
    layer1.fc1, and every node before it is identical."""
    params = random_encoder_params(np.random.default_rng(0), HP)
    q = {**params, "layers": [params["layers"][0], dict(params["layers"][1])]}
    lyr = dict(q["layers"][1])
    fc1 = quantize_array_for_device(lyr["fc1"]["w"].numpy(), GGMLType.Q4_0)
    lyr["fc1"] = {**fc1, "b": lyr["fc1"]["b"]}
    q["layers"][1] = lyr

    mel = torch.from_numpy(_mel())
    a = encoder_intermediates(params, mel, HP)
    b = encoder_intermediates(q, mel, HP)
    report = compare_runs(a, b, atol=1e-6, rtol=1e-6)
    div = first_divergence(report)
    assert div == "layer1.fc1", div
    for r in report:
        if r["node"] == "layer1.fc1":
            break
        assert r["ok"] and r["max_abs"] == 0.0, r


def test_compare_runs_matches_jax():
    rng = np.random.default_rng(3)
    a = {"x": rng.standard_normal((4, 5)).astype(np.float32),
         "y": rng.standard_normal(7).astype(np.float32)}
    b = {"x": a["x"] + 0.05, "y": a["y"].copy(), "z": np.zeros(1, np.float32)}
    assert compare_runs(a, b) == jinspect.compare_runs(a, b)
    assert first_divergence(compare_runs(a, b)) == jinspect.first_divergence(
        jinspect.compare_runs(a, b)) == "x"


def test_watchdog_cancel_prevents_exit():
    cancel = wd.watchdog(0.2, "test")
    cancel()
    time.sleep(0.4)          # would have os._exit(2)'d the test runner


def test_guarded_context_manager():
    with wd.guarded(0.2, "test"):
        pass
    time.sleep(0.4)


def test_watchdog_fires_and_names_the_card():
    code = ("import time; from qwen2_audio_tpu_torch.utils import watchdog as wd; "
            "wd.watchdog(0.3, 'probe', on_timeout=lambda: print('late', flush=True)); "
            "time.sleep(30)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2
    assert "[watchdog:probe] the CUDA device" in r.stderr and "TPU" not in r.stderr
    assert r.stdout.strip() == "late"
    assert wd.DEADLINE_S == 3600.0


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 128, 32)])
def test_cost_analysis_matches_xla(shape):
    from qwen2_audio_tpu.utils.profiling import cost_analysis as jcost
    m, k, n = shape
    got = profiling.cost_analysis(lambda a, b: a @ b, torch.ones(m, k), torch.ones(k, n))
    want = jcost(lambda a, b: a @ b, jnp.ones((m, k), jnp.float32), jnp.ones((k, n), jnp.float32))
    assert got == {"flops": want["flops"], "bytes accessed": want["bytes accessed"]}
    assert got["flops"] == 2 * m * k * n


def test_cost_analysis_counts_no_view():
    a = torch.ones(64, 64)
    got = profiling.cost_analysis(lambda x: x.t()[:10].unsqueeze(0).select(1, 2)[:, :3], a)
    assert got == {"flops": 0.0, "bytes accessed": 0.0}
    # a copy is counted: 64 x 64 float32 read and written
    assert profiling.cost_analysis(lambda x: x.t().contiguous(), a)["bytes accessed"] == \
        2 * 64 * 64 * 4


def test_flops_summary_uses_h100_peaks():
    s = profiling.flops_summary(lambda a, b: a @ b, torch.ones(256, 256), torch.ones(256, 256))
    assert "bound" in s and "989 TFLOP/s" in s and "3.35 TB/s" in s
    assert "card: " in s


def test_trace_writes_a_trace_file(tmp_path):
    d = str(tmp_path / "tr")
    with profiling.trace(d) as out:
        with profiling.annotate("qa_probe_span"):
            _ = torch.ones(64, 64) @ torch.ones(64, 64)
    assert out == d and any(os.scandir(d))
    with open(os.path.join(d, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "qa_probe_span" in names and any("mm" in (n or "") for n in names)
