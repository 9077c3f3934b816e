"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and not ``tools/kernel_ab.py`` imports JAX or anything of
the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_ab.py"]


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = [_module_name(p) for p in sorted(PKG.rglob("*.py"))]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((node.lineno, n))
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.build", "repro_torch.kernels.ssd_scan.kernel",
    "repro_torch.kernels.ssd_scan.ops", "repro_torch.kernels.ssd_scan.ref",
    "repro_torch.models.ssm", "repro_torch.configs.mamba2_1_3b", "repro_torch.launch.serve",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.flash_attention.ref",
    "repro_torch.configs.whisper_large_v3",
    "repro_torch.kernels.flash_decode", "repro_torch.kernels.flash_decode.kernel",
    "repro_torch.kernels.flash_decode.ops", "repro_torch.kernels.flash_decode.ref",
    "repro_torch.kernels.rmsnorm", "repro_torch.kernels.rmsnorm.kernel",
    "repro_torch.kernels.rmsnorm.ops", "repro_torch.kernels.rmsnorm.ref",
    "repro_torch.core.async_agg", "repro_torch.core.aggregator", "repro_torch.core.sampler",
    "repro_torch.core.robust", "repro_torch.core.federated", "repro_torch.launch.train",
    "repro_torch.obs", "repro_torch.obs.events", "repro_torch.obs.tracer",
    "repro_torch.obs.metrics", "repro_torch.obs.export", "repro_torch.obs.report",
    "repro_torch.control", "repro_torch.control.policy", "repro_torch.control.controller",
    "repro_torch.runtime", "repro_torch.runtime.transport", "repro_torch.runtime.chaos",
    "repro_torch.runtime.driver", "repro_torch.runtime.server", "repro_torch.runtime.worker",
    "repro_torch.models.moe", "repro_torch.configs.granite_3_2b",
    "repro_torch.configs.qwen3_1_7b", "repro_torch.configs.gemma3_4b",
    "repro_torch.configs.deepseek_coder_33b", "repro_torch.configs.chameleon_34b",
    "repro_torch.configs.deepseek_moe_16b", "repro_torch.configs.llama4_scout_17b_a16e",
    "repro_torch.configs.jamba_v0_1_52b",
])
def test_serving_slice_modules_are_among_the_scanned(module):
    assert module in {_module_name(p) for p in SOURCES if p.suffix == ".py" and PKG in p.parents}
