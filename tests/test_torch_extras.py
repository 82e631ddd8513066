"""The port's last utilities against the JAX package on the CPU:
geometry/transforms_extra.py (mirroring tests/test_colmap_scene.py::
test_transform_extras, plus values against JAX) and utils/common.AttrDict
(the port's tracer, utils/profiling.py, is tests/test_torch_tracing.py's).
Bounds: f32 values within 1e-6 (the perturbation 1e-5), arccos gradients
1e-3 relative (see there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.geometry import transforms_extra as jx
from nerfloc_tpu.utils.common import AttrDict as JAttrDict
from nerfloc_tpu_torch.geometry import transforms_extra as tx
from nerfloc_tpu_torch.utils.common import AttrDict


def test_transform_extras():
    R = tx.euler_angles_to_matrix(torch.tensor([0.1, -0.2, 0.3]))
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-6)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-6
    T = tx.get_pose_perturb(0.01, 0.01, generator=torch.Generator().manual_seed(0))
    assert T.shape == (4, 4)
    np.testing.assert_allclose((T[:3, :3] @ T[:3, :3].T).numpy(), np.eye(3), atol=1e-5)
    x = torch.tensor(1.0, requires_grad=True)
    tx.acos_linear_extrapolation(x).backward()
    assert np.isfinite(float(x.grad))
    np.testing.assert_allclose(float(tx.acos_linear_extrapolation(torch.tensor(0.5))),
                               float(np.arccos(0.5)), atol=1e-6)


@pytest.mark.parametrize("convention", ["XYZ", "ZYX", "YXZ"])
def test_euler_angles_to_matrix_matches_jax(convention):
    a = np.random.default_rng(1).uniform(-np.pi, np.pi, (20, 3)).astype(np.float32)
    want = jax.jit(jx.euler_angles_to_matrix, static_argnums=1)(jnp.asarray(a), convention)
    got = tx.euler_angles_to_matrix(torch.from_numpy(a), convention)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_get_pose_perturb_matches_jax_with_its_noise():
    """The port's perturbation at JAX's normal draws (split as
    get_pose_perturb splits the key) equals JAX's."""
    key = jax.random.PRNGKey(3)
    want = jx.get_pose_perturb(key, 0.05, 0.1)
    r1, r2 = jax.random.split(key)
    noise = np.concatenate([np.asarray(jax.random.normal(r1, (3,))),
                            np.asarray(jax.random.normal(r2, (3,)))])
    got = tx.get_pose_perturb(0.05, 0.1, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_acos_linear_extrapolation_value_and_gradient_match_jax():
    x = np.concatenate([np.linspace(-1.5, 1.5, 61), [1.0, -1.0, 1 - 1e-4, -1 + 1e-4]])
    x = x.astype(np.float32)
    want = jax.vmap(jax.value_and_grad(jx.acos_linear_extrapolation))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tx.acos_linear_extrapolation(xt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    # the gradient -1/sqrt(1 - x^2) cancels near +-1: at the bound 1 - x^2
    # keeps a 1e-4 share of x's bits, so 1e-3 relative
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[1]), rtol=1e-3, atol=1e-5)
    assert np.isfinite(xt.grad.numpy()).all()


def test_attr_dict_matches_jax_package():
    for cls in (AttrDict, JAttrDict):
        d = cls(a=1)
        d.b = 2
        assert d.a == 1 and d["b"] == 2 and dict(d) == {"a": 1, "b": 2}
        with pytest.raises(AttributeError):
            d.missing
