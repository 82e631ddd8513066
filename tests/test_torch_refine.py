"""Photometric pose refinement on the CPU, without a model: the PyTorch
port's se(3) maps, refinement pixels and `refine_pose` on closed-form
renderers against the JAX package. (The refinement through the real
renderer is held in tests/test_torch_eval.py, beside the model it needs.)

The maps take seeded random twists, θ = 0 and θ within 1e-3 of π. The
toy cases run both packages' refine_pose on the same closed-form renderer.
Bounds, all f32, as measured on the CPU: the maps 1e-6 (absolute, of
outputs of order 1); on the toy renderer, whose loss is smooth, the
refined pose 5e-5 (measured 1.2e-5 on a component of 4e-5: Adam divides
each component by its own root mean square, so a component near 0 moves
by about lr whatever the sign of its last-bit noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.geometry import cameras as jcam
from nerfloc_tpu.geometry import se3 as jse3
from nerfloc_tpu.solve.pose_refine import refine_pose as j_refine
from nerfloc_tpu.solve.pose_refine import sample_refine_pixels as j_sample_pixels
from nerfloc_tpu_torch.geometry import se3 as tse3
from nerfloc_tpu_torch.solve.pose_refine import refine_pose, sample_refine_pixels

from _torch_parity import few_threads, t  # noqa: F401  (autouse fixture)

MAP_TOL, TOY_POSE_TOL = 1e-6, 5e-5
STEPS, LR = 50, 1e-3


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def twists():
    """Random twists up to 0.95 pi, θ = 0, and θ within 1e-3 of pi about a
    random axis and about a coordinate axis."""
    r = rng(0)
    w = r.standard_normal((16, 3))
    w *= (r.uniform(0, 0.95 * np.pi, 16) / np.linalg.norm(w, axis=1))[:, None]
    axis = r.standard_normal(3)
    axis /= np.linalg.norm(axis)
    near_pi = np.stack([axis * (np.pi - d) for d in (1e-3, 5e-4, 1e-4)]
                       + [np.array([np.pi - 1e-3, 0.0, 0.0])])
    w = np.concatenate([w, np.zeros((1, 3)), near_pi])
    rho = r.standard_normal((len(w), 3))
    return np.concatenate([rho, w], axis=1).astype(np.float32)


# -- se(3) maps ----------------------------------------------------------------

def test_se3_exp_map_matches_jax():
    x = twists()
    close(tse3.se3_exp_map(t(x)), jse3.se3_exp_map(jnp.asarray(x)), MAP_TOL)


@pytest.mark.parametrize("which", ["so3_log_map", "se3_log_map"])
def test_log_maps_match_jax(which):
    """On transforms built in f64 and rounded to f32, so that both packages
    read the same matrices (the diagonal branch above 3pi/4 included)."""
    x = twists().astype(np.float64)
    T = np.asarray(jax.jit(jse3.se3_exp_map, backend="cpu")(jnp.asarray(x, jnp.float32)),
                   np.float64)
    # re-orthonormalize in f64 before rounding
    U, _, Vt = np.linalg.svd(T[:, :3, :3])
    T[:, :3, :3] = U @ Vt
    T = T.astype(np.float32)
    arg = T[:, :3, :3] if which == "so3_log_map" else T
    got = getattr(tse3, which)(t(arg))
    want = getattr(jse3, which)(jnp.asarray(arg))
    close(got, want, MAP_TOL * 10 if which == "se3_log_map" else MAP_TOL)
    # exp(log(T)) gives T back, the rotations near pi included, to f32's
    # resolution of θ there: cos θ = -1 + d is exact only to 2^-24, so θ
    # only to sqrt(2 * 2^-24) ~ 3.5e-4
    back = tse3.se3_exp_map(got) if which == "se3_log_map" else tse3.so3_exp_map(got)
    close(back, arg, 5e-4)


def test_se3_exp_map_gradient_is_finite_at_zero_and_matches_jax():
    """The refinement differentiates exp at the initial pose's own twist:
    at θ = 0 (and just above the Taylor switch) the gradient is finite and
    JAX's."""
    C = rng(1).standard_normal((4, 4)).astype(np.float32)
    for w in (np.zeros(6, np.float32), np.array([0.1, -0.2, 0.3, 2e-5, 0, 0], np.float32)):
        x = t(w).requires_grad_(True)
        (tse3.se3_exp_map(x) * t(C)).sum().backward()
        want = jax.grad(lambda v: jnp.sum(jse3.se3_exp_map(v) * jnp.asarray(C)))(jnp.asarray(w))
        assert bool(torch.isfinite(x.grad).all())
        close(x.grad, want, MAP_TOL)


# -- refinement pixels -------------------------------------------------------------

def test_sample_refine_pixels_grid_mode():
    """'grid': every dilation-th pixel, evenly subsampled or wrapped to n."""
    uv = sample_refine_pixels(64, 96, 16, mode="grid").numpy()
    assert uv.shape == (16, 2)
    assert (uv[:, 0] % 10 == 0).all() and (uv[:, 1] % 10 == 0).all()
    assert (uv[:, 0] < 96).all() and (uv[:, 1] < 64).all()
    assert len(np.unique(uv, axis=0)) == 16
    uv2 = sample_refine_pixels(16, 16, 6, mode="grid").numpy()
    assert uv2.shape == (6, 2) and len(np.unique(uv2, axis=0)) == 4
    for H, W, n in ((64, 96, 16), (16, 16, 6), (240, 320, 512)):
        want = j_sample_pixels(jax.random.PRNGKey(0), H, W, n, mode="grid")
        close(sample_refine_pixels(H, W, n, mode="grid"), want, 0)


def test_sample_refine_pixels_random_mode():
    """n distinct pixels from the generator (the same seed, the same
    pixels), only inside the target mask when one is given; the given
    Gumbel noise picks its n largest."""
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    uv = sample_refine_pixels(16, 20, 50, generator=g())
    assert uv.shape == (50, 2) and len(np.unique(uv.numpy(), axis=0)) == 50
    assert torch.equal(uv, sample_refine_pixels(16, 20, 50, generator=g()))
    mask = torch.zeros(16, 20)
    mask[4:10, 5:15] = 1
    uv = sample_refine_pixels(16, 20, 40, target_mask=mask, generator=g()).long()
    assert bool((mask[uv[:, 1], uv[:, 0]] > 0).all())
    noise = torch.arange(16 * 20, dtype=torch.float32)
    uv = sample_refine_pixels(16, 20, 3, gumbel=noise)
    assert uv.tolist() == [[19.0, 15.0], [18.0, 15.0], [17.0, 15.0]]


# -- refine_pose on closed-form renderers ---------------------------------------------

K_TOY = np.array([[50.0, 0, 16.0], [0, 50.0, 16.0], [0, 0, 1.0]], np.float32)


def toy_uv(n=16):
    return np.stack([np.arange(n) * 2 % 32, np.arange(n) * 3 % 32], -1).astype(np.float32)


def test_refine_rejects_mask_collapse():
    """A renderer whose scene exists only for cameras within 0.2 of the
    origin and whose colour approaches the target as the camera leaves it:
    at a huge lr the pose drifts out, where every ray misses. The
    count-normalized loss and the valid-ray floor must return pose_init."""
    def render_fn(rays_o, rays_d, p):
        d2 = torch.sum(p[:3, 3] ** 2)
        mask = (d2 < 0.04).expand(rays_o.shape[0])
        return {"rgb": torch.full((rays_o.shape[0], 3), 0.5) - 1.0 / (1.0 + d2), "mask": mask}

    img = torch.full((32, 32, 3), 0.5)
    out = refine_pose(render_fn, torch.eye(4), t(K_TOY), img, t(toy_uv()), max_steps=4, lr=1.0)
    assert bool(torch.isfinite(out).all())
    assert float(torch.linalg.vector_norm(out[:3, 3])) < 0.2


def _toy(xp, nan_above=None):
    """Colour from the ray: 0.5 + 0.1 origin + 0.2 direction (so the loss
    sees rotation and translation). With nan_above, 0.1 sqrt(nan_above - x)
    more while the camera's x is below it: past it that branch is NaN but
    not selected, so the loss stays finite and its gradient is NaN."""
    def render_fn(rays_o, rays_d, p):
        rgb = 0.5 + 0.1 * rays_o + 0.2 * rays_d
        if nan_above is not None:
            x = p[0, 3]
            rgb = xp.where(x > nan_above, rgb, rgb + 0.1 * xp.sqrt(nan_above - x))
        return {"rgb": rgb, "mask": xp.ones(rgb.shape[0], dtype=bool)}
    return render_fn


def _toy_problem():
    """(pose_init, target image) of the toy renderer: the true pose is the
    identity moved by 3 cm along x and turned 0.02 rad."""
    true = np.asarray(jse3.se3_exp_map(jnp.asarray([0.03, 0, 0, 0, 0.02, 0], jnp.float32)))
    uv_all = np.stack(np.meshgrid(np.arange(32), np.arange(32), indexing="xy"), -1)
    ro, rd = jcam.rays_for_pixels(jnp.asarray(uv_all.reshape(-1, 2), jnp.float32),
                                  jnp.asarray(K_TOY), jnp.asarray(true))
    img = np.asarray(0.5 + 0.1 * ro + 0.2 * rd).reshape(32, 32, 3)
    return np.eye(4, dtype=np.float32), img


@pytest.mark.parametrize("case", ["accepted", "nan_freeze"])
def test_refine_pose_matches_jax_on_a_toy_renderer(case):
    """'accepted': 50 steps reduce the loss and the refined pose is kept.
    'nan_freeze': once the camera's x passes 5 mm the gradient is NaN; that
    step keeps its twist, the NaN still enters the moments, so every later
    step keeps it too, and the frozen pose is accepted, as in JAX."""
    nan_above = 0.005 if case == "nan_freeze" else None
    pose0, img = _toy_problem()
    uv = toy_uv(64)
    want = np.asarray(j_refine(_toy(jnp, nan_above), jnp.asarray(pose0), jnp.asarray(K_TOY),
                               jnp.asarray(img), jnp.asarray(uv), jax.random.PRNGKey(0),
                               max_steps=STEPS, lr=LR))
    trace = []
    got = refine_pose(_toy(torch, nan_above), t(pose0), t(K_TOY), t(img), t(uv),
                      max_steps=STEPS, lr=LR, trace=trace)
    close(got, want, TOY_POSE_TOL)
    losses = torch.stack(trace).numpy()
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]
    assert not np.allclose(got.numpy(), pose0)
    frozen = np.flatnonzero(losses != losses[-1])
    if case == "accepted":
        assert frozen.size == STEPS - 1
    else:
        # the loss stops changing a few steps in: x passed 5 mm there
        assert 0 < frozen.size < STEPS // 2, losses
        assert float(got[0, 3]) > nan_above
