"""`correct` on whole runs at a size a CPU test holds: a sound run passes;
the control (the reference in the port's place, one precision below the
configuration's) and each fault a cell can have, planted under the timed
path, fail. The cells' own limits are used; the tiny configurations run at
float32 so that a sound run reads next to nothing, and the control is the
cells' own: the reference at fp8, its float32 solvers at bf16. The `cuda`
tests run the control at the cells' own sizes on the card."""
import json

import pytest
import torch

from conftest import Buf, make_root
from harness import faults, runner, spec, systems

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, system=systems.port, fault=None, seed=20260101):
    out, err = Buf(), Buf()
    rc = runner.run(f"tiny-{cell}", seed, 0.0, False, 0.0, root=root, device="cpu",
                    need_card=False, system=system, fault=fault, out=out, err=err)
    assert rc == 0, err.text
    res = json.loads(out.text.splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert err.text.splitlines()[-1].startswith("check ")
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    res = _run(root, cell, system=lambda: systems.control("bfloat16"))
    assert res["correct"] is False, res["checks"]


def _faults():
    for cell in CELLS:
        for f in faults.of_cell(spec.load_cell(cell)):
            yield cell, f


@pytest.mark.parametrize("cell,fault", list(_faults()))
def test_fault_is_not_correct(root, cell, fault):
    res = _run(root, cell, fault=fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(card, cell):
    out, err = Buf(), Buf()
    rc = runner.run(cell, 20260102, 0.0, False, 0.0, system=lambda: systems.control(
        spec.load_cell(cell).config["dtype"]), out=out, err=err)
    assert rc == 0
    assert json.loads(out.text.splitlines()[-1])["correct"] is False
