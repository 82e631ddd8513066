"""The per-scene fine-tune model's gradients on the CPU: the PyTorch port
against the JAX package at `__graft_entry__._tiny_cfg()` with
render.fused_query_agg, use_scene_coord_memorization=True and
encode_appearance=False (configs/onepose/*.yaml; the other 24 per-scene
YAMLs keep the appearance FiLM, whose gradients tests/test_torch_train.py
and tests/test_torch_bf16_train.py hold). The coordinate heads
(coord_desc_mlp_coarse/_fine) are on every path of the model; their 12
leaves are named in the assertions.

train_forward's terms and every parameter-gradient leaf against jax.grad
(one compiled value_and_grad per dtype, the batch and variables as
constants), with JAX's noise on both sides:
- f32 with tests/test_torch_train.py's bounds: terms 1e-4 of their scale;
  each leaf ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-8 ||g_jax||_all.
- bf16 with tests/test_torch_bf16_train.py's noise-aware yardstick: each
  term and each leaf rms(port16 - jax16)^2 <= rms(jax16 - jax32)^2 +
  spread_jax^2 + spread_port^2 (the spreads: each package's own change
  under weights scaled by 1 +- 2^-22), and rms(port16 - port32)^2 +
  spread_port^2 >= 0.25 (rms(jax16 - jax32)^2 - spread_jax^2) per leaf
  (the port's own spread counts on its side as JAX's does on the other:
  sigma_mlp's and beta_mlp's first biases land near f32 by chance), and
  rms(port16 - port32) >= 0.5 rms(jax16 - jax32) over all leaves
  together. The terms need the spreads too: here render_loss is chaotic in
  JAX's bf16 (a 2^-22 weight change moves it by 3x its bf16-vs-f32
  distance, 0.0031 against 0.0010; the port's is 0.0020 from JAX's), and
  each spread is the RMS change over two runs, at 1 + 2^-22 and 1 - 2^-22.
  One leaf is exempt from the ratio: the heatmap logits' bias
  (fine_matcher.mlps.fc3.bias), whose gradient is zero in exact arithmetic
  (the logits feed a softmax; 9e-8 and 0 at f32) and at bf16 is the
  rounding of a sum that cancels (2^-10 in JAX, 0 or 3 x 2^-10 in the
  port). It is held, on both sides, to the first-order error bound of that
  bf16 sum in windows of 32 (as XLA's CPU backend sums it):
  (31 + n/32) 2^-8 sum |cotangent| over its n terms.

`-s` prints the ratios and the worst leaves.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import few_threads, to_numpy  # noqa: F401
from test_torch_bf16 import JBF, Bf16Setup, f64, rms
from test_torch_bf16_train import PERTURB, port_run
from test_torch_bf16_train import jax_noise as jax_noise_dt
from test_torch_train import (GRAD_FLOOR, GRAD_REL, grads_in_port_layout, leaf_errors,
                              outside_bound, worst_leaves)

FINETUNE = dict(use_scene_coord_memorization=True, encode_appearance=False)
COORD_HEADS = ("model_3d.coord_desc_mlp_coarse", "model_3d.coord_desc_mlp_fine")
TERMS = ("loss", "coarse_loss", "fine_loss", "fine_err", "ref_depth_loss", "render_loss",
         "psnr")
SOFTMAX_BIAS = "fine_matcher.mlps.fc3.bias"


def close(got, want, rel):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def ft():
    """train_forward of the fine-tune model: JAX's value_and_grad at f32,
    at bf16 and at bf16 with the weights scaled by 1 + 2^-22 (one compile
    per dtype, the batch and variables as constants), the port's at both
    dtypes and perturbed."""
    S = Bf16Setup(**FINETUNE)
    S.np_vars = to_numpy(S.variables)
    key = jax.random.PRNGKey(0)

    def leaves(g):
        return {n: v.numpy() for n, v in grads_in_port_layout(S, g).items()}

    J = {}
    bumped = {sign: jax.tree.map(lambda a, s=sign: a * (1 + s * PERTURB), S.variables["params"])
              for sign in (1, -1)}
    for d, runs in ((32, (("32", S.variables["params"]),)),
                    (16, (("16", S.variables["params"]), ("16+", bumped[1]),
                          ("16-", bumped[-1])))):
        m = S.jm[d]

        def f(p, m=m):
            out = m.apply({**S.variables, "params": p}, S.batch, key, method=m.train_forward)
            return out["loss"], out
        vg = jax.jit(jax.value_and_grad(f, has_aux=True))
        for name, p in runs:
            (_, out), g = vg(p)
            J[name] = ({k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()},
                       leaves(g))
    noise = {d: jax_noise_dt(S, key, dt) for d, dt in ((16, JBF), (32, jnp.float32))}
    P = {str(d): port_run(m, S.tbatch, *noise[d]) for d, m in S.pm.items()}
    for name, sign in (("16+", 1), ("16-", -1)):
        m = copy.deepcopy(S.pm[16])
        with torch.no_grad():
            for q in m.parameters():
                q.mul_(1 + sign * PERTURB)
        P[name] = port_run(m, S.tbatch, *noise[16])
    total32 = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in J["32"][1].values()))
    # the cotangents summed into the heatmap logits' bias at bf16
    cot = []

    def keep(mod, args, out):
        out.register_hook(lambda g: cot.append(g.detach().float()))
    hook = S.pm[16].fine_matcher.mlps.register_forward_hook(keep)
    port_run(S.pm[16], S.tbatch, *noise[16])
    hook.remove()
    heat = (sum(float(g.abs().sum()) for g in cot), sum(g.numel() for g in cot))
    return dict(S=S, J=J, P=P, total32=total32, heat_cotangent=heat)


def spread(base, moved):
    """A package's own bf16 spread: the RMS change of its value over the
    runs with the weights scaled by 1 + 2^-22 and by 1 - 2^-22."""
    return float(np.sqrt(np.mean([rms(m - base) ** 2 for m in moved])))


def _heads(names):
    return sorted({n for n in names if n.startswith(COORD_HEADS)})


@pytest.mark.parametrize("key", TERMS)
def test_finetune_train_forward_terms_f32(ft, key):
    got, want = ft["P"]["32"][0][key], ft["J"]["32"][0][key]
    print(f"{key}: port {float(got)!r}, jax {float(want)!r}")
    close(got, want, 1e-4)


def test_finetune_gradients_f32_every_leaf(ft):
    """Every leaf, the coordinate heads' among them, within
    test_torch_train.py's bound; the heads' gradients are not zero."""
    got = ft["P"]["32"][1]
    want = {n: torch.from_numpy(np.asarray(v)) for n, v in ft["J"]["32"][1].items()}
    assert got.keys() == want.keys()
    heads = _heads(got)
    assert len(heads) == 12, heads      # two MLPs of three layers: weight and bias each
    errs, total = leaf_errors(got, want)
    print(f"worst leaves {worst_leaves(errs, total)}; heads " + ", ".join(
        f"{n} {errs[n][0] / errs[n][1]:.2e}" for n in heads))
    assert all(bool(torch.isfinite(g).all()) for g in got.values())
    assert [n for n, _, _ in outside_bound(errs, total)] == []
    for n in heads:
        assert errs[n][1] > GRAD_FLOOR * total and errs[n][0] <= GRAD_REL * errs[n][1], n


@pytest.mark.parametrize("key", ("loss", "coarse_loss", "fine_loss", "render_loss", "psnr"))
def test_finetune_train_forward_terms_bf16(ft, key):
    J, P = ft["J"], ft["P"]
    j16, j32 = (f64(J[k][0][key]) for k in ("16", "32"))
    p16, p32 = (f64(P[k][0][key]) for k in ("16", "32"))
    sj = spread(j16, [f64(J[k][0][key]) for k in ("16+", "16-")])
    sp = spread(p16, [f64(P[k][0][key]) for k in ("16+", "16-")])
    ref = rms(j16 - j32)
    near, real = rms(p16 - j16), rms(p16 - p32)
    bound = np.sqrt(ref ** 2 + sj ** 2 + sp ** 2)
    print(f"{key}: port16-jax16 {near:.3g}, jax16-jax32 {ref:.3g}, spreads jax {sj:.3g} "
          f"port {sp:.3g}; near / bound {near / bound:.3f}, real / ref {real / ref:.3f}")
    assert ref > 0 and near <= bound
    assert real ** 2 + sp ** 2 >= 0.25 * (ref ** 2 - sj ** 2)


def test_finetune_gradients_bf16_every_leaf(ft):
    """Every leaf at bf16 with the noise-aware bound of the module
    docstring; the coordinate heads' leaves by name."""
    J, P = ft["J"], ft["P"]
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in P["16"][1].values())
    rows, far16, far32 = {}, 0.0, 0.0
    for n, w16 in J["16"][1].items():
        j16, j32 = np.asarray(w16, np.float64), np.asarray(J["32"][1][n], np.float64)
        p16, p32 = (f64(P[k][1][n]) for k in ("16", "32"))
        sj = spread(j16, [np.asarray(J[k][1][n], np.float64) for k in ("16+", "16-")])
        sp = spread(p16, [f64(P[k][1][n]) for k in ("16+", "16-")])
        ref = rms(j16 - j32)
        near, real = rms(p16 - j16), rms(p16 - p32)
        far16 += np.sum((p16 - p32) ** 2)
        far32 += np.sum((j16 - j32) ** 2)
        bound = np.sqrt(ref ** 2 + sj ** 2 + sp ** 2)
        zero = np.sqrt(np.sum(j32 ** 2)) <= 1e-6 * ft["total32"]
        rows[n] = (near / bound if bound else 0.0,
                   zero or real ** 2 + sp ** 2 >= 0.25 * (ref ** 2 - sj ** 2))
    worst = sorted(rows.items(), key=lambda kv: -kv[1][0])[:6]
    heads = _heads(rows)
    print("worst (near / bound): " + ", ".join(f"{n} {r[0]:.3f}" for n, r in worst)
          + "; heads: " + ", ".join(f"{n} {rows[n][0]:.3f}" for n in heads))
    assert len(heads) == 12
    # the heatmap logits' bias: zero in exact arithmetic (softmax), its bf16
    # value the rounding of a sum that cancels, on both sides
    n, (S_abs, count) = SOFTMAX_BIAS, ft["heat_cotangent"]
    limit = (31 + -(-count // 32)) * 2.0 ** -8 * S_abs
    vals = {k: float(np.abs(np.asarray(J[k][1][n])).max()) for k in ("16", "16+", "16-")}
    vals.update({"port" + k: float(P[k][1][n].abs().max()) for k in ("16", "16+", "16-")})
    print(f"{n}: |g16| {vals}, f32 {float(np.abs(J['32'][1][n]).max()):.3g} / "
          f"{float(P['32'][1][n].abs().max()):.3g}; summation bound {limit:.3g} "
          f"(sum of |cotangents| {S_abs:.4g} over {count})")
    assert max(float(np.abs(J["32"][1][n]).max()), float(P["32"][1][n].abs().max())) \
        <= 1e-6 * ft["total32"]
    assert max(vals.values()) <= limit
    assert [m for m, r in rows.items() if r[0] > 1.0 and m != n] == []
    assert [(n, rows[n]) for n, r in rows.items() if not r[1]] == []
    assert np.sqrt(far16 / far32) >= 0.5


