"""Rank processes of tests/test_torch_parallel.py.

    python tests/_torch_ranks.py <scenario> <workdir>

runs one scenario of this file in one process: under torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) as
one rank of a gloo group on the CPU, without it as one plain process. The
scenario's arguments are <workdir>/args.pt; its result goes to
<workdir>/rank<r>.pt. `run_ranks` starts n such processes (n = 0: one
process without torchrun's environment) and returns their results. The
processes import torch and the port only (no JAX), with
PYTHONHASHSEED=0, so dataset items draw alike in every process.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Any, Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(name: str, n: int, work: str, args: Dict[str, Any],
              timeout: float = 240) -> List[Any]:
    """Run scenario `name` as n gloo ranks (n = 0: one process without a
    group) and return each rank's result."""
    import torch
    os.makedirs(work, exist_ok=True)
    torch.save(args, os.path.join(work, "args.pt"))
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    base.update(PYTHONHASHSEED="0", CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = []
    for r in range(max(n, 1)):
        env = dict(base)
        if n:
            env.update(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), name, work],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{name}: rank {r} exited {p.returncode}:\n{out}")
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(max(n, 1))]


# -- scenarios -----------------------------------------------------------------

@scenario
def allgather(args):
    """The 7-query fixture: each rank's strided shard of per-query arrays
    (float, int, bool, pose and file-name rows), all-gathered."""
    import numpy as np
    from nerfloc_tpu_torch.parallel.multihost import allgather_metrics, process_shard_indices
    from nerfloc_tpu_torch.train.evaluate import _decode_names, _encode_names
    n = args["n_items"]
    idx = process_shard_indices(n)
    local = {"rot": np.asarray([i * 1.5 for i in idx], np.float32),
             "sid": np.asarray([i % 3 for i in idx], np.int64),
             "ok": np.asarray([i % 2 == 0 for i in idx]),
             "pose": np.stack([np.full((2, 2), i, np.float32) for i in idx]),
             "fname": _encode_names([f"seq-01/frame-{i:06d}.png" for i in idx])}
    g = allgather_metrics(local, idx, n)
    return {"indices": idx, "local": local, "gathered": g,
            "names": _decode_names(g["fname"])}


def _model(args):
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator
    model = NerfPoseEstimator(args["cfg"], device="cpu", seed=1)
    if "state" in args:
        model.load_state_dict(args["state"])
    return model


@scenario
def train_steps(args):
    """Steps of the data-parallel train step on this rank's rows of one
    global batch, the noise drawn from one generator seeded alike."""
    import torch
    from nerfloc_tpu_torch.models.pose_estimator import to_device_batch
    from nerfloc_tpu_torch.parallel.mesh import MeshSpec, make_mesh, shard_batch, world
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step
    model = _model(args)
    _, n = world()
    mesh = make_mesh(MeshSpec(data=n))
    state = TrainState(model, model.cfg)
    if mesh.data_group is not None:
        state.broadcast(mesh.data_group)
    step = make_train_step(model, model.cfg, group=mesh.data_group)
    batch = to_device_batch(shard_batch(args["host_batch"], mesh), torch.device("cpu"))
    gen = torch.Generator().manual_seed(args["seed"])
    metrics = [{k: float(v) for k, v in step(state, batch, generator=gen).items()}
               for _ in range(args["steps"])]
    return {"metrics": metrics, "model": model.state_dict(), "opt": state.opt_state,
            "step": state.step}


class ItemList:
    """Query items in memory, as a dataset: __len__ and __getitem__."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@scenario
def eval_items(args):
    """eval_dataset over the items (per-query noise from query_seed), with
    the poses collected; then over fewer items than ranks."""
    from nerfloc_tpu_torch.train.evaluate import eval_dataset
    from nerfloc_tpu_torch.train.step import make_eval_step
    model = _model(args)
    step = make_eval_step(model, model.cfg)
    names = args["scene_names"]
    res = eval_dataset(ItemList(args["items"]), step, args["batch"], names, model.cfg,
                       device="cpu", collect_poses=True, query_seed=args["seed"])
    try:
        eval_dataset(ItemList(args["items"][:1]), step, 1, names, model.cfg, device="cpu",
                     query_seed=0)
        few = None
    except ValueError as e:
        few = str(e)
    return {"results": res, "few_items": few}


@scenario
def renders(args):
    """render_image_ray_sharded over a (1, 2) mesh and the batched render
    over a (2, 2) mesh (every rank builds both meshes' groups)."""
    import torch
    from nerfloc_tpu_torch.models.fields.aggregator import SupportViews
    from nerfloc_tpu_torch.models.fields.context import NeuralPoints
    from nerfloc_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from nerfloc_tpu_torch.parallel.render import (make_batched_ray_sharded_render,
                                                   render_image_ray_sharded)
    model = _model(args)
    ctxs = [model.model_3d.assemble_context(SupportViews(**c["sv"]), NeuralPoints(**c["coarse"]),
                                            NeuralPoints(**c["fine"]), c["feat_coarse_src"],
                                            c["feat_fine_src"])
            for c in args["contexts"]]
    mesh_r = make_mesh(MeshSpec(data=1, ray=2))
    mesh_2d = make_mesh(MeshSpec(data=2, ray=2)) if args["batched"] else None
    out = {}
    with torch.no_grad():
        if mesh_r.member:
            H, W = args["hw"]
            out["image"] = render_image_ray_sharded(model, model.cfg, ctxs[0], args["K"],
                                                    args["poses"][0], H, W, mesh_r)
        if mesh_2d is not None:
            render = make_batched_ray_sharded_render(model, model.cfg, mesh_2d)
            out["batched"] = render(ctxs, args["rays_o"], args["rays_d"], args["poses"])
    return out


@scenario
def clis(args):
    """cli.train for one epoch, again with one more (it resumes), then
    cli.test; each rank returns what it printed of the table."""
    from nerfloc_tpu_torch.cli import test as cli_test
    from nerfloc_tpu_torch.cli import train as cli_train
    out = {}
    for i, argv in enumerate(args["train"]):
        out[f"train{i}"] = cli_train.main(argv)
    for i, argv in enumerate(args["test"]):
        out[f"test{i}"] = cli_test.main(argv)
    return out


def main() -> None:
    name, work = sys.argv[1], sys.argv[2]
    sys.path.insert(0, REPO)
    import torch
    torch.set_num_threads(1)
    from nerfloc_tpu_torch.parallel.mesh import init_distributed, launched, world
    if launched():
        init_distributed("gloo", "cpu")
    args = torch.load(os.path.join(work, "args.pt"), weights_only=False)
    result = SCENARIOS[name](args)
    torch.save(result, os.path.join(work, f"rank{world()[0]}.pt"))
    if launched():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
