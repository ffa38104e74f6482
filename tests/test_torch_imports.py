"""The PyTorch port stands alone: no module of ``fantoch_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package, and no entry point
runs on the CPU unless asked to."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fantoch_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "fantoch_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fantoch_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], "fantoch_tpu_torch.")
        if not m.name.endswith("__main__")
    )


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for name in ("kernels.qualify_pop", "kernels.loop_ctl",
                 "kernels.step_loop", "parallel.pipeline", "engine.hetero",
                 "engine.skeleton"):
        assert f"fantoch_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fantoch_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fantoch_tpu_torch.resolve_device("cuda")
    assert fantoch_tpu_torch.resolve_device("cpu").type == "cpu"


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    from fantoch_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sweep", "--protocol", "basic", "--n", "3", "--subsets", "1",
              "--commands", "1", "--conflicts", "0"])


def test_kernel_wrappers_refuse_bad_cuda_arguments():
    """On a CUDA tensor a wrapper launches its kernel or raises; the
    argument checks run before any launch (a meta tensor stands in for
    the card here)."""
    from fantoch_tpu_torch.kernels import build

    t = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="dtype"):
        build.check("x", t, torch.bool, (2, 3), t.device)
    with pytest.raises(ValueError, match="shape"):
        build.check("x", t, torch.int32, (3, 2), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        build.check("x", t.t(), torch.int32, (3, 2), t.device)
