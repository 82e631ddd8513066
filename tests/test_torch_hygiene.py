"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, nor OpenCV, Pillow, PyYAML or lmdb (the GPU machine has none of
them), its entry points refuse to fall back to the CPU on their own, and
chip_smoke.py fails without a GPU (and without the rest of the repo).

Imports are checked by parsing the sources: the test process itself has
JAX loaded, so sys.modules says nothing about the port.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nerfloc_tpu_torch import resolve_device

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nerfloc_tpu", "cv2", "PIL", "yaml",
             "lmdb")


def _port_sources():
    return sorted((ROOT / "nerfloc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_check_tells_the_packages_apart(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import nerfloc_tpu_torch.ops\nfrom nerfloc_tpu.ops import knn\n")
    assert list(_imported_roots(src)) == ["nerfloc_tpu_torch", "nerfloc_tpu"]


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    if where == "repo":
        cwd = ROOT
    else:
        cwd = tmp_path
        shutil.copy(ROOT / "chip_smoke.py", cwd / "chip_smoke.py")
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
