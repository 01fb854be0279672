"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
(nor ``regex``, which the GPU host lacks), and builds nothing at import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "qwen2_audio_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "qwen2_audio_tpu", "regex", "triton")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_quantized_weight_modules_are_scanned():
    mods = set(_port_modules())
    for m in ("quant", "quant.codecs", "quant.qparams", "ops.quant_matmul", "ops.linear",
              "ops.fused_mlp", "ops.quant_matmul_int8", "ops.quant_matmul_q4b"):
        assert f"qwen2_audio_tpu_torch.{m}" in mods


def test_decode_modules_are_scanned():
    mods = set(_port_modules())
    for m in ("models.dtw", "models.qwen2_decoder", "runtime.generate", "runtime.decoding"):
        assert f"qwen2_audio_tpu_torch.{m}" in mods


def test_loading_and_serving_modules_are_scanned():
    """The HF loader, the parameter cache and the serving layer are imported
    by test_import_leaves_jax_out like every module, and import none of the
    optional packages (safetensors, transformers) at module level."""
    mods = set(_port_modules())
    for m in ("io.hf", "io.param_cache", "utils.cache", "runtime.serving"):
        assert f"qwen2_audio_tpu_torch.{m}" in mods
    for rel in ("io/hf.py", "io/param_cache.py", "utils/cache.py", "runtime/serving.py"):
        tree = ast.parse((PORT / rel).read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names] + \
            [n.module or "" for n in top if isinstance(n, ast.ImportFrom)]
        assert not {x.split(".")[0] for x in names} & {"safetensors", "transformers"}, rel


def test_parallel_and_training_modules_are_scanned():
    """The tensor-parallel and training modules (and the fine-tune example)
    are imported by test_import_leaves_jax_out like every module, and
    scanned for forbidden imports; the spawned test ranks' module too."""
    mods = set(_port_modules())
    for m in ("parallel", "parallel.mesh", "parallel.tp", "parallel.distributed",
              "parallel.collectives", "parallel.launch", "training", "training.step",
              "training.data", "training.checkpoint", "training.finetune"):
        assert f"qwen2_audio_tpu_torch.{m}" in mods
    tree = ast.parse((ROOT / "tests" / "test_torch_dist_workers.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not {n.split(".")[0] for n in names} & set(FORBIDDEN), names


def test_surface_modules_are_scanned():
    """The tokenizer, the whole C API, the audio inputs, the text helpers,
    the native host library's bindings and the command line are imported by
    test_import_leaves_jax_out like every module, and scanned for forbidden
    imports (``regex`` among them: the tokenizer's word split is a scanner
    over unicodedata)."""
    mods = set(_port_modules())
    for m in ("tokenizer", "capi", "native", "audio", "audio.mp3", "audio.capture", "audio.vad",
              "utils.text", "utils.utf8", "utils.bench_utils", "cli", "cli.__main__", "cli.main",
              "cli.output_formats", "cli.bench_cli", "cli.transcribe", "cli.stream",
              "runtime.rpc", "utils.watchdog", "utils.profiling", "utils.inspect_graph"):
        assert f"qwen2_audio_tpu_torch.{m}" in mods, m


JAX_PKG = ROOT / "qwen2_audio_tpu"
# the port's ops.flash_attention is its kernel module, so the JAX ops
# package's two attention functions are exported by ops.fa_variants
MOVED = {("ops", "flash_attention"): "ops.fa_variants",
         ("ops", "flash_attention_encoder"): "ops.fa_variants"}


def _exports(init: Path) -> set[str]:
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@pytest.mark.parametrize("init", sorted(JAX_PKG.rglob("__init__.py")),
                         ids=lambda p: str(p.parent.relative_to(ROOT)))
def test_package_exports_match_jax(init):
    """Every name a JAX package's __init__ exports, the port's counterpart
    exports too (two attention functions by design from ops.fa_variants)."""
    import importlib
    rel = init.parent.relative_to(JAX_PKG)
    sub = ".".join(rel.parts)
    port = importlib.import_module("qwen2_audio_tpu_torch" + (f".{sub}" if sub else ""))
    missing = []
    for name in sorted(_exports(init)):
        where = MOVED.get((sub, name))
        mod = importlib.import_module(f"qwen2_audio_tpu_torch.{where}") if where else port
        if not hasattr(mod, name):
            missing.append(name)
    assert not missing, (sub, missing)


def test_every_jax_module_has_a_counterpart():
    jax_mods = {p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py")}
    port_mods = {p.relative_to(PORT) for p in PORT.rglob("*.py")}
    assert not jax_mods - port_mods, sorted(map(str, jax_mods - port_mods))


def test_no_module_is_left_unported():
    """No entry point of the port raises NotImplementedError."""
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in PORT.rglob("*.py")
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if "NotImplementedError" in line]
    assert not hits, hits


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_every_kernel_source_is_declared():
    from qwen2_audio_tpu_torch.ops import _build
    sources = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert sources == set(_build.SIGNATURES) and {"fused_mlp", "quant_matmul_int8"} <= sources
    # a header the sources share is part of every library's name
    assert (PORT / "csrc" / "qmm_common.cuh").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    for cu in (PORT / "csrc").glob("*.cu"):
        head = cu.read_text()[:2000]
        assert "Replaces the TPU kernel" in head, cu
        assert "What bounds it" in head, cu


def test_chip_smoke_refuses_without_cuda():
    """Without a card the script exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
