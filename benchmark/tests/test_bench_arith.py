"""The arithmetic of the metrics on synthetic records and traces, and the
frozen work count against the one it was copied from."""
import importlib.util
import math

import pytest

from conftest import ROOT
from harness import cost, readers
from harness.profile import Profile, reduce_trace
from harness.record import Record


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_window_rates():
    r = Record(kind="query", window_s=12.5, items=5)
    assert readers.per_item_ms(r, "query") == pytest.approx(2500.0)
    assert readers.per_item_ms(r, "train") is None
    t = Record(kind="train", window_s=10.0, items=40, trace=True)
    assert readers.per_item_ms(t, "train") is None      # a traced run reports no rate
    assert readers.traced_item_ms(t, "train") == pytest.approx(250.0)
    assert readers.traced_item_ms(t, "query") is None
    assert readers.traced_item_ms(r, "query") is None   # nor an untraced one its copy


def test_trace_busy_idle_and_gaps():
    evs = [_ev("kernel", "void fused_agg_wide<128>(Params)", 0, 100),
           _ev("kernel", "elementwise", 50, 100),           # overlaps: busy 0-150
           _ev("gpu_memcpy", "Memcpy HtoD", 400, 100),       # busy 400-500
           _ev("kernel", "fused_agg_cluster<16>", 900, 100),  # busy 900-1000
           _ev("cpu_op", "aten::nonzero", 160, 230),
           _ev("user_annotation", "span:refine", 0, 1000),
           _ev("cuda_runtime", "cudaLaunchKernel", 10, 5)]
    p = reduce_trace(evs, window_s=0.002)
    assert p.busy_s == pytest.approx(350e-6)
    assert len(p.kernels) == 3
    assert p.kernel_s(readers.FUSED_AGG) == pytest.approx(200e-6)
    assert p.idle_by_host[0][0] == "span:refine | python"
    assert p.idle_by_host[0][1] == pytest.approx(400e-6)
    assert p.idle_by_host[1] == ("span:refine | aten::nonzero", pytest.approx(250e-6))
    r = Record(kind="train", trace=True, profile=p, profile_items=2)
    assert readers.idle_share(r, "train") == pytest.approx(100 * (1 - 350e-6 / 0.002))
    assert readers.launches(r, "train") == 1.5
    assert readers.idle_share(r, "query") is None


def _agg_call(N, K, act_bytes=2):
    shapes = {"rd_w1": (4, 16), "rd_b1": (16,), "rd_w2": (16, 27), "rd_b2": (27,),
              "b_w0p": (222, 128), "b_b0": (128,), "b_w1": (128, 128), "b_b1": (128,),
              "b_w2": (128, 128), "b_b2": (128,), "a_wq": (128, 128), "a_wk": (128, 128),
              "a_wv": (128, 128), "a_wfc": (128, 128), "ln_s": (128,), "ln_b": (128,)}
    return {"N": N, "K": K, "F": 132, "W": 128, "NF": 10, "act_bytes": act_bytes,
            "param_shapes": shapes}


def test_roofline_and_mfu():
    calls = [_agg_call(32768, 8), _agg_call(1024, 1)]
    bound = sum(cost.agg_bound_s(cost.agg_cost(c["N"], c["K"], c["F"], c["W"],
                                               c["param_shapes"], c["NF"], 2), "bf16")
                for c in calls)
    p = Profile(window_s=1.0, busy_s=0.5,
                kernels=[("fused_agg_wide<128>", 4 * bound), ("other", 1.0)])
    r = Record(kind="query", trace=True, profile=p, profile_items=1, agg_calls=calls)
    assert readers.roofline(r, "query") == pytest.approx(25.0)
    r.agg_calls = []
    assert readers.roofline(r, "query") is None          # nothing to read, no 0
    m = Record(kind="train", trace=True, window_s=4.0, items=10, flops_per_item=989e9)
    assert readers.mfu(m, "train") == pytest.approx(100 * 989e9 / 0.4 / 989e12)
    m.flops_per_item = None
    assert readers.mfu(m, "train") is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("N,K,act_bytes", [(1024, 8, 2), (1024, 1, 2), (32768, 8, 2),
                                           (65536, 8, 2), (32768, 8, 4), (262144, 8, 2)])
def test_agg_cost_is_chip_smokes(N, K, act_bytes):
    import torch
    cs = _chip_smoke()
    x = cs.agg_inputs(8, K, 132, 128, seed=0, dev="cpu")
    want = cs.agg_cost(N, K, 132, 128, x["params"], x["freqs"], act_bytes=act_bytes)
    shapes = {k: tuple(v.shape) for k, v in x["params"].items()}
    got = cost.agg_cost(N, K, 132, 128, shapes, x["freqs"].numel(), act_bytes)
    assert got == want
    _, bound_ms, _ = cs.agg_bounds(want, "bf16")
    assert cost.agg_bound_s(got, "bf16") * 1e3 == pytest.approx(bound_ms)
    assert math.isfinite(bound_ms) and torch is not None
