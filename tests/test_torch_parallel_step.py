"""The port's one-process train step at a batch of 2 against the JAX
package's data-parallel step over a (data=2) mesh of virtual CPU devices,
at tests/test_train.py's fixture (its tiny config, queries of seeds 0 and
1, PRNGKey(1)), on the same weights and noise. (tests/test_torch_parallel.py
shows the port's 2-rank step equal to this one-process step.)

JAX's step returns no gradient. After its first update the Adam first
moment is (1 - b1) times the clipped gradient, and the clip scales by
1 / grad_norm, so the gradient is mu / (1 - b1) * max(1, grad_norm).

Bounds are tests/test_torch_train.py's: metrics 1e-4 of their scale;
gradients per leaf ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-8 ||g_jax||
over all leaves, plus 1.5x the distance between JAX's own gradient
compiled with the batch as an argument (the mesh step) and compiled with
it as a constant (test_reference_gradient_spread): XLA's two programs
differ by up to ~1e-3 on DepthFusionNet's leaves here.

The JAX step differs from the port in one way that no bound covers: its
train state holds the whole variables tree, so Adam also moves the
'frozen' BatchNorm statistics, and their gradient enters the clip norm.
The port keeps them fixed, as the JAX module's own docstring and the
reference intend; the last test shows the difference.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.configs import Config, MatchingConfig, RenderConfig
from nerfloc_tpu.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu.parallel.mesh import MeshSpec, make_mesh, shard_batch
from nerfloc_tpu.train import create_train_state, make_train_step as j_make_train_step
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.train.state import B1, TrainState
from nerfloc_tpu_torch.train.step import make_train_step
from nerfloc_tpu_torch.weights import load_flax_variables

from _torch_parity import CPU, few_threads, port_cfg, t  # noqa: F401
from test_torch_train import (GRAD_REL, TERMS, close, leaf_errors, outside_bound, port_grads,
                              worst_leaves)


def train_cfg():
    """tests/test_train.py's tiny_cfg, with the fused query aggregation."""
    return Config(
        backbone2d_fpn_dim=16, model_3d_hidden_dim=16, matcher_hidden_dim=24, n_views_train=2,
        render=RenderConfig(N_samples=4, N_rand=8, use_render_uncertainty=True,
                            fused_query_agg=True),
        matching=MatchingConfig(fine_num_3d_keypoints=16, coarse_num_3d_keypoints=16),
        shapes=dataclasses.replace(Config().shapes, pnp_hypotheses=32))


@pytest.fixture(scope="module")
def run():
    cfg = train_cfg()
    jmodel = JaxEstimator(cfg)
    host = stack_batches([device_batch(make_query_batch(n_views=2, H=32, W=32, seed=i))
                          for i in range(2)])
    b0 = {k: jnp.asarray(v[0]) for k, v in host.items()}
    key0 = jax.random.PRNGKey(0)
    variables = jax.jit(jmodel.init)(key0, b0, key0)
    np_vars = jax.tree.map(np.asarray, variables)
    rng = jax.random.PRNGKey(1)
    mesh = make_mesh(MeshSpec(data=2, ray=1))
    with mesh:
        state = create_train_state(jax.tree.map(jnp.copy, variables), cfg)
        new, jm = j_make_train_step(jmodel, cfg, mesh)(state, shard_batch(host, mesh), rng)
    jm = {k: float(v) for k, v in jm.items()}
    jgrads = jax.tree.map(lambda m: np.asarray(m) / (1 - B1) * max(1.0, jm["grad_norm"]),
                          new.opt_state[2].mu)

    # the same mean loss with the batch and variables as constants
    rngs = jax.random.split(rng, 2)
    batch = {k: jnp.asarray(v) for k, v in host.items()}

    def mean_loss(params):
        def one(b, r):
            return jmodel.apply({**variables, "params": params}, b, r,
                                method=jmodel.train_forward)["loss"]
        return jnp.mean(jax.vmap(one)(batch, rngs))
    const_grads = jax.jit(jax.grad(mean_loss))(variables["params"])

    model = NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=1)
    assert load_flax_variables(model, np_vars) == []
    kps, idxs = [], []
    for r in rngs:          # train_forward's split: rng -> (rng_kp, rng_ray)
        rng_kp, rng_ray = jax.random.split(r)
        P = model.n_coarse_points(to_device_batch({k: v[0] for k, v in host.items()}, CPU))
        kps.append(t(np.asarray(jax.random.gumbel(rng_kp, (P,), dtype=jnp.float32))))
        idxs.append(t(np.asarray(jax.random.choice(rng_ray, 32 * 32, (cfg.render.N_rand,),
                                                   replace=False))))
    before = copy.deepcopy(model.state_dict())
    state = TrainState(model, model.cfg)
    tm = make_train_step(model, model.cfg)(state, to_device_batch(host, CPU),
                                          kp_gumbel=torch.stack(kps), ray_idx=torch.stack(idxs))

    def port_layout(grads):
        G = NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=1)
        assert load_flax_variables(G, {"params": jax.tree.map(np.asarray, grads),
                                       "frozen": np_vars["frozen"]}) == []
        return {n: p.detach().clone() for n, p in G.named_parameters()}
    return dict(jm=jm, tm={k: float(v) for k, v in tm.items()}, jgrads=jgrads,
                want=port_layout(jgrads["params"]), const=port_layout(const_grads),
                got=port_grads(model), np_vars=np_vars, new=new, model=model, before=before)


@pytest.mark.parametrize("key", TERMS + ("matching_iou",))
def test_metrics_match_the_jax_mesh_step(run, key):
    print(f"{key}: port {run['tm'][key]!r}, jax {run['jm'][key]!r}")
    close(run["tm"][key], run["jm"][key])


def test_gradients_match_the_jax_mesh_step(run):
    errs, total = leaf_errors(run["got"], run["want"])
    spread, _ = leaf_errors(run["const"], run["want"])
    print(f"worst leaves {worst_leaves(errs, total)}; JAX's compile spread "
          f"{worst_leaves(spread, total)}")
    assert not outside_bound(errs, total, {n: 1.5 * d for n, (d, _) in spread.items()})
    params_norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                              for g in jax.tree.leaves(run["jgrads"]["params"])))
    assert abs(run["tm"]["grad_norm"] - params_norm) <= GRAD_REL * params_norm


def test_jax_step_moves_its_frozen_statistics(run):
    """JAX: Adam moved the BatchNorm statistics of the 'frozen' collection.
    The port: its statistics (buffers) are where they were."""
    old = jax.tree.leaves(run["np_vars"]["frozen"])
    new = jax.tree.leaves(run["new"].params["frozen"])
    moved = sum(int(not np.array_equal(a, np.asarray(b))) for a, b in zip(old, new))
    assert moved > len(old) // 2
    for name, buf in run["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(buf, run["before"][name]), name
