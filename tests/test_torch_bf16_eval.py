"""The eval step at the bf16 compute dtype: the PyTorch port's
make_eval_step with a model at dtype=torch.bfloat16 against the JAX
package's make_eval_step with its model at dtype=jnp.bfloat16, on the CPU,
at `__graft_entry__._tiny_cfg()` with render.fused_query_agg=True,
cascade_matching=True and optimize_pose=True (32 refinement rays; JAX's
fused kernel in Pallas interpret mode). The harness (eval_dataset,
render_psnr_eval) runs the bf16 model through.

Both packages get the same weights, the same two queries and the same
noise, drawn on the JAX side as tests/test_torch_eval.py draws it (the
keypoint Gumbel noise at bf16, as JAX's bf16 model draws it). The discrete
outputs (inlier and match counts, PnP success, matching IoU) come from
mutual nearest matches over bf16 scores and move with a 2^-22 weight
change in JAX itself (the test prints both shares): the share equal to
JAX's is held to JAX's own share under that change, PnP success is equal.
The poses and errors hold the yardstick of tests/test_torch_bf16.py
against JAX's bf16-vs-f32 distance, c = 1, after removing in quadrature
each package's own spread under a 2^-22 change of the weights, as the
refinement's 50 Adam steps carry any change of the scene context on
(tests/test_torch_bf16_refine.py measures that spread at the refinement
alone). `-s` prints the ratios.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.configs import StaticShapeConfig
from nerfloc_tpu.parallel.mesh import MeshSpec, make_mesh, shard_batch
from nerfloc_tpu.solve.pose_refine import sample_refine_pixels as j_sample_pixels
from nerfloc_tpu.train.step import make_eval_step as j_make_eval_step
from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu_torch.models.pose_estimator import to_device_batch
from nerfloc_tpu_torch.train.evaluate import (eval_dataset, make_render_psnr_fn,
                                              render_psnr_eval)
from nerfloc_tpu_torch.train.step import make_eval_step

from _torch_parity import CPU, few_threads, t  # noqa: F401
from test_torch_bf16 import BF, JBF, Bf16Setup, rms
from test_torch_eval import Items

DISCRETE = ("num_inliers", "num_matches", "pnp_success", "matching_iou")
PERTURB = 2.0 ** -22


@pytest.fixture(scope="module")
def evaluated():
    S = Bf16Setup(cascade_matching=True, optimize_pose=True,
                  shapes=StaticShapeConfig(pose_refine_rays=32))
    items = [device_batch(make_query_batch(n_views=3, H=32, W=32, seed=s)) for s in (0, 1)]
    host = stack_batches(items)
    key = jax.random.PRNGKey(14)
    mesh = make_mesh(MeshSpec(data=1, ray=1))
    bumped = {**S.variables,
              "params": jax.tree.map(lambda a: a * (1 + PERTURB), S.variables["params"])}
    J = {}
    with mesh:
        batch = shard_batch(host, mesh)
        for d in (32, 16):
            step = j_make_eval_step(S.jm[d], S.cfg, mesh)
            J[d] = step(S.variables, batch, key)
            if d == 16:
                J["16+"] = step(bumped, batch, key)
    J = {k: {n: np.asarray(v) for n, v in out.items()} for k, out in J.items()}
    H, W = host["image"].shape[1:3]
    P = S.pm[16].n_coarse_points({k: t(v[0]) for k, v in host.items()})
    n_kp, n_hyps = S.cfg.matching.fine_num_3d_keypoints, S.cfg.shapes.pnp_hypotheses

    def noise(kp_dtype):
        out = {k: [] for k in ("kp_gumbel", "pnp_gumbel", "pnp2_gumbel", "refine_uv")}
        for r in jax.random.split(key, 2):
            r_match, r_pnp, r_pnp2, r_ref = jax.random.split(r, 4)
            out["kp_gumbel"].append(jax.random.gumbel(r_match, (P,), dtype=kp_dtype)
                                    .astype(jnp.float32))
            out["pnp_gumbel"].append(jax.random.gumbel(r_pnp, (n_hyps, n_kp)))
            out["pnp2_gumbel"].append(jax.random.gumbel(r_pnp2, (n_hyps, n_kp)))
            out["refine_uv"].append(j_sample_pixels(r_ref, H, W, S.cfg.shapes.pose_refine_rays,
                                                    None, mode=S.cfg.optimize_pose_sampling))
        return {k: t(np.stack([np.asarray(x) for x in v])) for k, v in out.items()}
    tbatch = to_device_batch(host, CPU)
    P_ = {}
    for d, model, kp_dt in ((32, S.pm[32], jnp.float32), (16, S.pm[16], JBF)):
        P_[d] = make_eval_step(model, model.cfg)(tbatch, noise=noise(kp_dt))
    bumped_model = copy.deepcopy(S.pm[16])
    with torch.no_grad():
        for p in bumped_model.parameters():
            p.mul_(1 + PERTURB)
    P_["16+"] = make_eval_step(bumped_model, bumped_model.cfg)(tbatch, noise=noise(JBF))
    P_ = {k: {n: v.numpy() for n, v in out.items()} for k, out in P_.items()}
    return S, J, P_


def test_eval_step_bf16_outputs_match_jax(evaluated):
    _, J, P = evaluated
    assert sorted(P[16]) == sorted(J[16])
    for k, v in J[16].items():
        assert P[16][k].shape == v.shape and P[16][k].dtype == v.dtype, k
    # the counts come from mutual nearest matches over bf16 scores, where a
    # 2^-22 weight change already moves JAX's own: the port's share of
    # outputs equal to JAX's is held to JAX's own share under that change
    same = {k: np.mean(P[16][k] == J[16][k]) for k in DISCRETE}
    self_same = {k: np.mean(J["16+"][k] == J[16][k]) for k in DISCRETE}
    print(f"discrete outputs equal to JAX's: {same}; JAX's own under a 2^-22 weight change: "
          f"{self_same}")
    assert np.mean(list(same.values())) >= np.mean(list(self_same.values()))
    assert np.array_equal(P[16]["pnp_success"], J[16]["pnp_success"])
    for k in ("pose_pred", "rot_err_deg", "trans_err_m"):
        p16, j16, j32, p32 = (np.asarray(x[k], np.float64) for x in (P[16], J[16], J[32], P[32]))
        sj, sp = rms(j16 - J["16+"][k]), rms(p16 - P["16+"][k])
        close, ref, real = rms(p16 - j16), rms(j16 - j32), rms(p16 - p32)
        bound = np.sqrt(ref ** 2 + sj ** 2 + sp ** 2)
        print(f"{k}: rms |port16-jax16| {close:.3g}, |jax16-jax32| {ref:.3g}, spreads jax {sj:.3g} "
              f"port {sp:.3g}, |port16-port32| {real:.3g}; ratio {close / bound:.3f}")
        assert close <= bound, k
        assert real ** 2 >= 0.25 * (ref ** 2 - sj ** 2), k
    R = P[16]["pose_pred"][:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    assert np.allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_eval_dataset_and_render_psnr_bf16(evaluated):
    """The harness with the bf16 model: eval_dataset (cascade on,
    refinement off) over two items of two scenes gives a finite table,
    render_psnr_eval a finite PSNR."""
    import dataclasses
    S = evaluated[0]
    cfg = dataclasses.replace(S.pm[16].cfg, optimize_pose=False)
    model = copy.deepcopy(S.pm[16])
    model.cfg = cfg
    assert model.dtype == BF
    res = eval_dataset(Items((0, 1)), make_eval_step(model, cfg), 2, {0: "scene0", 1: "scene1"},
                       cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sorted(res) == ["avg", "scene0", "scene1"]
    for row in res.values():
        assert all(np.isfinite(v) for v in row.values())
        assert 0.0 <= row["pose_acc"] <= 1.0
    psnr = render_psnr_eval(make_render_psnr_fn(S.pm[16]), Items((0, 1, 2)), max_views=1)
    assert psnr["n_rendered"] == 1 and np.isfinite(psnr["psnr_test"])
