"""CPU tests of the benchmark: `python -m pytest benchmark/tests` from the
repository root. The tests that need a card carry the `cuda` marker and
skip here; the decision is taken inside a fixture."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

# tiny widths and frames the CPU runs in seconds
TINY = {"backbone2d_fpn_dim": 16, "model_3d_hidden_dim": 16, "matcher_hidden_dim": 24,
        "appearance_emb_dim": 16,
        "render": {"N_samples": 16, "N_rand": 8},
        "matching": {"coarse_num_3d_keypoints": 16, "fine_num_3d_keypoints": 16},
        "shapes": {"pnp_hypotheses": 32, "pose_refine_rays": 16}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _tiny_config(name: str, real: str, dtype: str) -> dict:
    conf = json.loads((BENCH / "configs" / f"{real}.json").read_text())
    conf["name"] = name
    conf["frame"] = [32, 32]
    cfg = conf["config"]
    for k, v in TINY.items():
        cfg[k] = {**cfg.get(k, {}), **v} if isinstance(v, dict) else v
    cfg["compute_dtype"] = conf["dtype"] = dtype
    return conf


def make_root(tmp: Path, dtype: str = "float32", limits=None, sample: int = 2) -> Path:
    """A checkout at tmp: this benchmark's files, a BENCHMARK.json with
    tiny copies of the configurations, and every mix with fewer items;
    nothing of the real cells is edited."""
    bench = tmp / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        tiny = f"tiny-{c['name']}"
        (bench / "configs" / f"{tiny}.json").write_text(
            json.dumps(_tiny_config(tiny, c["name"], dtype)))
        c.update(name=tiny, file=f"benchmark/configs/{tiny}.json")
    for path in sorted((bench / "traffic").glob("*.json")):
        mix = path.stem
        m = json.loads(path.read_text())
        m.update(pool=3, sample=sample)
        if m["driver"] == "query_loop":
            m.update(warmup=1)
        else:
            m.update(warmup=1, follow=2)
        (bench / "traffic" / f"tiny_{mix}.json").write_text(json.dumps(m))
    cells = []
    for w in spec["workloads"]:
        name = f"tiny-{w['name']}"
        cells.append(dict(w, name=name, config=f"tiny-{w['config']}",
                          traffic=f"tiny_{w['traffic']}"))
        real = json.loads((bench / "cells" / f"{w['name']}.json").read_text())
        (bench / "cells" / f"{name}.json").write_text(json.dumps(
            {"flops_per_item": real["flops_per_item"],
             "limits": limits if limits is not None else real["limits"]}))
    spec["workloads"] = cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"tiny-{x}" for x in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


class Buf:
    """A text stream for runner.run's out and err."""

    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s

    def flush(self):
        pass
