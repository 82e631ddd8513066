"""BENCHMARK.json against the contract's shape, and discovery by name:
every cell's configuration, mix, driver, data and metric readers are
found by file name, and a new configuration, mix, metric and cell work as
new files and entries alone."""
import json
import re

import pytest
import torch

from conftest import ROOT, Buf, make_root
from harness import runner, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"][1] == "benchmark/run.py"
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024
    names = [c["name"] for c in s["configs"]] + [w["name"] for w in s["workloads"]] \
        + [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    used = {w["config"] for w in s["workloads"]}
    assert used == {c["name"] for c in s["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in s["end_to_end"])
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        e2e = {e["name"]: e for e in s["end_to_end"]}[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in e2e or w in e2e["workloads"]


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_cell_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.driver().Driver.KIND in ("query", "train")
    assert set(c.data) >= {"flops_per_item", "limits"}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_every_metric_has_a_reader_file():
    s = _spec()
    for m in s["end_to_end"] + s["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(spec.metric_reader(m["name"]))


def test_unknown_names_refused(tmp_path):
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    with pytest.raises(ValueError):
        spec.metric_reader("../run")


def test_new_config_mix_metric_and_cell_as_files_alone(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell as
    new files and entries, edits no file, and its cell runs and reports
    the new metric."""
    root = make_root(tmp_path, limits={})
    bench = root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    conf = json.loads((bench / "configs" / "tiny-7scenes.json").read_text())
    conf.update(name="tiny-new", frame=[32, 48])
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(conf))
    (bench / "traffic" / "tiny_newmix.json").write_text(json.dumps(
        {"driver": "query_loop", "views": 3, "pool": 2, "warmup": 1, "sample": 1,
         "config": {"cascade_matching": False, "optimize_pose": False}}))
    (bench / "metrics" / "queries_per_s.py").write_text(
        '"""Queries completed per second of the window."""\n\n\n'
        'def read(r):\n    return r.items / r.window_s if r.kind == "query" and not r.trace '
        'else None\n')
    (bench / "cells" / "tiny-new.localize.json").write_text(
        json.dumps({"flops_per_item": None, "limits": {"kp_missed": 0.0}}))
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "tiny-new", "source": "x", "reduced": [], "why": "x",
                         "file": "benchmark/configs/tiny-new.json"})
    s["workloads"].append({"name": "tiny-new.localize", "config": "tiny-new",
                           "traffic": "tiny_newmix", "chips": 1, "why": "x"})
    s["end_to_end"].append({"name": "queries_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["tiny-new.localize"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    out, err = Buf(), Buf()
    torch.set_num_threads(2)
    rc = runner.run("tiny-new.localize", 7, 0.0, False, 0.0, root=root, device="cpu",
                    need_card=False, out=out, err=err)
    assert rc == 0
    res = json.loads(out.text.splitlines()[-1])
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}



def test_scene_is_the_ports_generator():
    """The frozen traffic generator gives the port's make_query_batch."""
    import numpy as np
    from harness import scene
    from nerfloc_tpu_torch.data.synthetic import make_query_batch
    want = make_query_batch(n_views=3, H=24, W=32, seed=2 ** 31 + 5)
    got = scene.query(3, 24, 32, 2 ** 31 + 5, "cpu")
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k], dtype=np.float32),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
