"""The whole-name import check, and what the reference and the harness
import."""
import ast
import subprocess
import sys

from conftest import BENCH, ROOT
from harness import guard


def test_whole_names():
    names = ["nerfloc_tpu_torch", "nerfloc_tpu_torch.models", "jax", "jax.numpy", "jaxlib",
             "jaxtyping", "nerfloc_tpu", "nerfloc_tpu.ops", "flax.linen", "flaxen", "numpy"]
    assert guard.forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib",
                                              "nerfloc_tpu", "nerfloc_tpu.ops"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        bad = guard.forbidden_modules(_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "torch", "numpy", "math", "dataclasses", "typing",
                        "functools", "warnings"}, f"{path}: {tops}"
    code = ("import sys; sys.path.insert(0, %r); import reference.train.step, "
            "reference.models.pose_estimator; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd="/", check=True).stdout
    tops = set(eval(out))
    assert not tops & {"nerfloc_tpu_torch", "nerfloc_tpu", "jax", "jaxlib", "harness"}


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "7scenes.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_checkout_without_the_port_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "7scenes.train",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
