"""The port's tracer (nerfloc_tpu_torch/utils/profiling.py) on the CPU at a
tiny configuration, without JAX.

Off, an eval step and a train step leave no record and no `span:` range in
a torch.profiler trace. On, every span of the port's table (PERF.md) shows
under its parent, as a record and as a profiler range, with one item per
query and per step; the fused aggregation's replayed backward carries the
item of the step it serves (a bf16 call: on the CPU only bf16 inputs go
through _FusedAgg). Refinement runs 2 steps here, not 50: which spans open
where does not depend on the count. On a card (`cuda` marker), a 16-view
train step makes no host sync inside its scene-context build.
"""
import json
import threading

import numpy as np
import pytest
import torch

from nerfloc_tpu_torch.configs import (Config, MatchingConfig, RenderConfig, StaticShapeConfig,
                                      compute_dtype_of)
from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.ops import fused_agg
from nerfloc_tpu_torch.train import step as step_mod
from nerfloc_tpu_torch.train.state import TrainState
from nerfloc_tpu_torch.utils import profiling
from nerfloc_tpu_torch.utils.profiling import span

REFINE_STEPS = 2
EVAL = {"query": None, "localize": "query", "localize.context": "localize",
        "localize.keypoints": "localize", "localize.match": "localize", "pnp": "query",
        "cascade": "query", "refine": "query", "refine.render": "refine",
        "refine.grad": "refine"}
TRAIN = {"step": None, "forward": "step", "forward.context": "forward",
         "forward.match": "forward", "forward.render": "forward", "backward": "step",
         "update": "step"}
# per query: both RANSAC passes; the cascade's match and its gate; a render
# per refinement step and two for the accept test, a gradient per step
EVAL_COUNTS = {"pnp": 2, "cascade": 2, "refine.render": REFINE_STEPS + 2,
               "refine.grad": REFINE_STEPS}


def tiny_cfg(dtype: str = "float32") -> Config:
    return Config(backbone2d_fpn_dim=16, model_3d_hidden_dim=16, matcher_hidden_dim=24,
                  appearance_emb_dim=16, n_views_train=2, n_views_test=2,
                  cascade_matching=True, optimize_pose=True, compute_dtype=dtype,
                  render=RenderConfig(N_samples=8, N_rand=8, chunk=64, fused_query_agg=True),
                  matching=MatchingConfig(fine_num_3d_keypoints=8, coarse_num_3d_keypoints=8),
                  shapes=StaticShapeConfig(pnp_hypotheses=16, pose_refine_rays=8))


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.enable(False)
    profiling.clear()
    yield
    profiling.enable(False)
    profiling.clear()


@pytest.fixture(scope="module")
def tiny():
    """A query (B=1), the f32 model, its steps and its train state, at two
    intra-op threads (more only wait on each other at these sizes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = tiny_cfg()
    model = NerfPoseEstimator(cfg, device="cpu", seed=0, dtype=torch.float32)
    item = device_batch(make_query_batch(n_views=2, H=32, W=32, seed=0))
    batch = to_device_batch(stack_batches([item]), torch.device("cpu"))
    yield (step_mod.make_eval_step(model, cfg), step_mod.make_train_step(model, cfg),
           TrainState(model, cfg), batch)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def traced(tiny):
    """{on: {"eval" | "train": (records, names of the profiler's `span:`
    ranges)}} of eval_step and train_step, each under a CPU profiler, with
    the tracer off and on."""
    eval_step, train_step, state, batch = tiny
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_mod, "REFINE_STEPS", REFINE_STEPS)
        for on in (False, True):
            out[on] = {}
            for which, call in (("eval", lambda g: eval_step(batch, generator=g)),
                                ("train", lambda g: train_step(state, batch, generator=g))):
                profiling.clear()
                profiling.enable(on)
                try:
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                        call(torch.Generator().manual_seed(0))
                finally:
                    profiling.enable(False)
                ranges = {e.name()[len("span:"):] for e in prof.profiler.kineto_results.events()
                          if e.name().startswith("span:")}
                out[on][which] = (profiling.records(), ranges)
    profiling.clear()
    return out


@pytest.mark.parametrize("which", ["eval", "train"])
def test_off_leaves_no_record_and_no_range(traced, which):
    assert traced[False][which] == ([], set())


def test_off_span_is_one_shared_null_context():
    a, b = span("query"), span("refine.render")
    assert a is b
    with a:
        with b:
            pass
    assert profiling.records() == []


def _check_tree(recs, parents):
    assert {r.name for r in recs} == set(parents)
    for r in recs:
        assert r.parent == parents[r.name], r
        assert r.start_ns <= r.end_ns
        assert r.thread == threading.get_ident()


def test_eval_spans_their_parents_and_one_item_per_query(traced):
    recs, ranges = traced[True]["eval"]
    assert ranges == set(EVAL)
    _check_tree(recs, EVAL)
    assert {r.item for r in recs} == {0}
    query = recs[-1]
    assert query.name == "query"
    assert all(query.start_ns <= r.start_ns and r.end_ns <= query.end_ns for r in recs)
    counts = {n: sum(r.name == n for r in recs) for n in EVAL}
    assert counts == {n: EVAL_COUNTS.get(n, 1) for n in EVAL}


def test_train_spans_their_parents_and_one_item_per_step(traced):
    recs, ranges = traced[True]["train"]
    assert ranges == set(TRAIN)
    _check_tree(recs, TRAIN)
    assert {r.item for r in recs} == {0}
    counts = {n: sum(r.name == n for r in recs) for n in TRAIN}
    # both cascade passes matched
    assert counts == {"step": 1, "forward": 1, "forward.context": 1, "forward.match": 2,
                      "forward.render": 1, "backward": 1, "update": 1}
    # the step's records close in order: its own last
    assert recs[-1].name == "step"


def test_replayed_backward_carries_the_step_item():
    cfg = tiny_cfg("bfloat16")
    nerf = NerfPoseEstimator(cfg, device="cpu", seed=0, dtype=torch.bfloat16).model_3d
    N, K, F, W = 16, 8, 3 + cfg.backbone2d_fpn_dim, cfg.model_3d_hidden_dim
    rng = np.random.default_rng(0)
    x = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in (
        ("xyz", (N, 3)), ("mv_agg", (N, W)), ("nb_xyz", (N, K, 3)), ("nb_dir", (N, K, 4)),
        ("nb_feat", (N, K, F)))}
    mv_agg = x["mv_agg"].bfloat16().requires_grad_(True)
    freqs = torch.tensor([2.0 ** i for i in range(cfg.multires)])
    profiling.enable(True)
    with span("step"):
        out = fused_agg.fused_neighbor_agg(
            x["xyz"], x["nb_dir"][:, 0].contiguous(), mv_agg, x["nb_xyz"], x["nb_dir"],
            x["nb_feat"].bfloat16(), torch.tensor(3.5),
            fused_agg.extract_agg_params(nerf, F), freqs)
        with span("backward"):
            out.sum().backward()
    assert mv_agg.grad is not None
    recs = profiling.records()
    # the CPU engine runs the backward on the calling thread; on CUDA
    # tensors its own worker thread runs it, where no span is open
    assert [(r.name, r.parent, r.item) for r in recs] == [
        ("fused_agg.replay", "backward", 0), ("backward", "step", 0), ("step", None, 0)]


def test_span_on_another_thread_carries_the_current_item():
    """As the autograd engine's worker thread runs a CUDA backward: its span
    has no parent on that thread, and the item of the root open on the
    thread that waits for it."""
    profiling.enable(True)
    with span("step"):
        with span("backward"):
            def body():
                with span("fused_agg.replay"):
                    pass
            worker = threading.Thread(target=body)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    replay = [r for r in profiling.records() if r.name == "fused_agg.replay"]
    assert len(replay) == 1
    assert replay[0].parent is None and replay[0].item == 0
    assert replay[0].thread != threading.get_ident()


def test_enable_clear_and_items():
    profiling.enable(True)
    with span("localize"):          # outside a root: item -1
        pass
    for _ in range(2):
        with span("query"):
            pass
    got = profiling.records()
    assert [(r.name, r.item) for r in got] == [("localize", -1), ("query", 0), ("query", 1)]
    got.clear()                     # a copy: the tracer's records stay
    assert len(profiling.records()) == 3
    profiling.enable(False)
    with span("query"):
        pass
    assert len(profiling.records()) == 3     # off keeps what was recorded
    profiling.clear()
    assert profiling.records() == []
    profiling.enable(True)
    with span("step"):
        pass
    assert [(r.name, r.item) for r in profiling.records()] == [("step", 0)]


def _blocks_host(name: str) -> bool:
    """A runtime or driver call that waits for the device: any
    *Synchronize, and a copy without Async (cudaMemcpy, cuMemcpyDtoH...)."""
    if "Synchronize" in name:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name


@pytest.mark.cuda
def test_no_host_sync_in_the_context_of_a_16_view_train_step(tmp_path):
    """Runs on a card only: a bf16 train step at the main widths with 16
    support views (64x64 frames, few rays and keypoints) under the tracer
    and the profiler. Inside `span:forward.context` no runtime or driver
    call blocks the host: the per-view work runs once for all views and
    copies no host-made tensor to the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = Config(n_views_train=16, n_views_test=16, compute_dtype="bfloat16",
                 render=RenderConfig(N_rand=64),
                 matching=MatchingConfig(fine_num_3d_keypoints=64, coarse_num_3d_keypoints=64))
    dev = torch.device("cuda")
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=compute_dtype_of(cfg))
    item = device_batch(make_query_batch(n_views=16, H=64, W=64, seed=0))
    batch = to_device_batch(stack_batches([item]), dev)
    train_step, state = step_mod.make_train_step(model, cfg), TrainState(model, cfg)
    train_step(state, batch, generator=torch.Generator(dev).manual_seed(0))    # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            train_step(state, batch, generator=torch.Generator(dev).manual_seed(1))
            torch.cuda.synchronize()
    finally:
        profiling.enable(False)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    # the host's range (the card's timeline repeats it as a gpu_user_annotation)
    context = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
               if e["name"] == "span:forward.context"
               and not str(e.get("cat", "")).startswith("gpu")]
    assert len(context) == 1, [e.get("cat") for e in events
                               if e["name"] == "span:forward.context"]
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    assert any("LaunchKernel" in e["name"] and context[0][0] <= float(e["ts"]) <= context[0][1]
               for e in calls)
    syncs = [e["name"] for e in calls if _blocks_host(e["name"])
             and context[0][0] <= float(e["ts"]) <= context[0][1]]
    assert syncs == []
