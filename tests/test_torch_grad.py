"""
Parity of the port's gradient path (rodeo_tpu_torch.ops: the forward-mode
Dual numbers, the twins of the tangent kernels K11a, K11b, K11c and K11e,
and the entry points solve_mv_fused_batch_grad, basic_fused_batch_grad,
fenrir_fused_batch_grad, dalton_fused_batch_grad and fused_loglik) with the
JAX package's Pallas tangent kernels, which run here in interpret mode.

On the CPU the port's wrappers take the plain PyTorch twins of the CUDA
kernels.  Inputs are made from a seed with numpy and fed to both packages;
both work in float32 and add in different orders.  The tolerances, each
above the largest error measured over these runs:

- the Dual rules against ``torch.func.jvp`` in float64: 1e-10 of the
  largest entry of each output (measured <= 1e-14; the two differ only in
  rounding, and in the scale of sym_inv, which the Duals hold constant);
- a twin against its Pallas kernel, values and each tangent direction on
  their own: SCALED_TOL = 1e-4 of the largest entry, as for the value
  kernels (measured <= 2.0e-5);
- an entry point's value: rtol 1e-4 (DALTON's, a difference of two sums:
  1e-3, as for its value entry point);
- an entry point's gradient, per parameter: GRAD_RTOL = 1e-3 of the
  largest entry (measured <= 8.7e-6), and DALTON_GRAD_RTOL = 5e-3 for
  DALTON's (measured <= 1.7e-3, FitzHugh-Nagumo EK0): its gradient is the
  difference of the two filters' gradients, each ~330 times larger (2e5
  against 600), and each package's float32 result is up to 5e-4 from its
  own float64 run.

Sizes: 60 steps x 4 lanes (Lorenz63 EK1 to t = 0.6, FitzHugh-Nagumo EK0 to
t = 3): a tangent of Lorenz63 grows like a perturbation of the ODE, so a
float32 comparison means something only at short horizons.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.ops import pallas_dalton as pd
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.ops import pallas_kalman as pk

import rodeo_tpu_torch as rt
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import dual
from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops.dual import Dual

RULES_TOL = 1e-10
SCALED_TOL = 1e-4
LOGLIK_RTOL = 1e-4
DALTON_RTOL = 1e-3
GRAD_RTOL = 1e-3
DALTON_GRAD_RTOL = 5e-3
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}
# (model, interrogation, n_steps, t_max, n_obs)
CASES = [("lorenz", "kramer", 60, 0.6, 7), ("fitzhugh", "rodeo", 60, 3.0, 7)]
N_LANE = 4
Q, N_TRI, N_TAN = 3, 6, 3


def _scaled_err(port, ref):
    """max|port - ref| / max|ref|; the absolute error where ref is all zero
    (a tangent that does not depend on its parameter, as Lorenz63's
    covariances do not depend on rho)."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(port - ref).max()
    return err / scale if scale > 0 else err


def _per_slice(port, ref, k, axis):
    """Scaled error of each of the n_aug slices of k entries along axis:
    the values, then each tangent direction."""
    port, ref = np.asarray(port), np.asarray(ref)
    n_aug = ref.shape[axis] // k
    return [_scaled_err(np.take(port, range(a * k, (a + 1) * k), axis),
                        np.take(ref, range(a * k, (a + 1) * k), axis))
            for a in range(n_aug)]


# --- the Dual rules against torch.func.jvp, float64 --------------------------------


def _spd_cols(rng, nb, B, scale=1.0):
    """Packed columns of seeded SPD matrices (nb, B), float64."""
    M = rng.standard_normal((nb, B, Q, Q))
    P = M @ np.swapaxes(M, -1, -2) * scale + 0.1 * np.eye(Q)
    pairs, _ = fk._tri_idx(Q)
    return [torch.from_numpy(P[..., i, j]) for i, j in pairs]


def _cols(rng, n, nb, B):
    return [torch.from_numpy(rng.standard_normal((nb, B))) for _ in range(n)]


def _rule_problem(name, rng):
    """A step function of ``fused_kalman`` on lists of float64 columns, and
    its primal inputs: ``fn(*cols) -> list of columns``."""
    nb, B = 3, 5
    pairs, where = fk._tri_idx(Q)
    q_const = [[1.0, 0.5, 0.125], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]
    R = [c[:, :1] * 0.01 for c in _spd_cols(rng, nb, 1)]
    if name == "predict":
        def fn(*x):
            mp, pp = fk._predict_cols(Q, where, q_const, R, list(x[:Q]),
                                      list(x[Q:]))
            return mp + pp
        return fn, _cols(rng, Q, nb, B) + _spd_cols(rng, nb, B)
    if name == "gain_cols":
        def fn(*x):
            G, g, L = fk._gain_cols_batched(
                Q, N_TRI, q_const, R, list(x[:Q]), list(x[Q:Q + N_TRI]),
                list(x[Q + N_TRI:2 * Q + N_TRI]), list(x[2 * Q + N_TRI:]))
            return [G[i][j] for i in range(Q) for j in range(Q)] + g + L
        return fn, (_cols(rng, Q, nb, B) + _spd_cols(rng, nb, B)
                    + _cols(rng, Q, nb, B) + _spd_cols(rng, nb, B, 10.0))
    if name == "masked_obs_update":
        D = [torch.from_numpy(rng.standard_normal((nb, 1))) for _ in range(Q)]
        y = torch.from_numpy(rng.standard_normal((nb, 1)))
        om = torch.from_numpy(0.1 + rng.random((nb, 1)))
        mask = torch.tensor(1.0, dtype=torch.float64)

        def fn(*x):
            m, p, term = fk._masked_obs_update_cols(
                Q, pairs, where, list(x[:Q]), list(x[Q:]), D, y, om, mask)
            return m + p + [term]
        return fn, _cols(rng, Q, nb, B) + _spd_cols(rng, nb, B)
    model, mode = name.split("/")
    fused = fk.resolve_model(model)
    nb = fused.n_block
    W = [torch.from_numpy(rng.standard_normal((nb, 1))) for _ in range(Q)]
    tv = [torch.tensor(v, dtype=torch.float64) for v in (1.0, 0.1, 0.01)]
    t = torch.tensor(0.5, dtype=torch.float64)

    def fn(*x):
        m, p, z, S, inv_S = fk._interrogate_update_cols(
            fused, Q, pairs, where, W, tv, list(x[:Q]),
            list(x[Q:Q + N_TRI]), x[-1], t, mode)
        return m + p + [z, S, inv_S]
    theta = torch.from_numpy(np.abs(rng.standard_normal((3, B))) + 0.5)
    return fn, _cols(rng, Q, nb, B) + _spd_cols(rng, nb, B) + [theta]


@pytest.mark.parametrize("name", ["predict", "gain_cols", "masked_obs_update",
                                  "lorenz/kramer", "lorenz/rodeo",
                                  "fitzhugh/kramer", "fitzhugh/rodeo"])
def test_dual_rules_match_torch_jvp(name):
    """The column step functions run on Duals give torch.func.jvp's
    tangents: the predict, the gains (sym_inv with its scale held
    constant), the masked update (its log) and the interrogate-update of
    each model and interrogation."""
    rng = np.random.default_rng(31)
    fn, primals = _rule_problem(name, rng)
    n_dir = 2
    tangents = [torch.from_numpy(rng.standard_normal((n_dir,) + p.shape))
                for p in primals]
    outs = fn(*[Dual(p, t) for p, t in zip(primals, tangents)])
    values = fn(*primals)
    for k in range(n_dir):
        ref_v, ref_t = torch.func.jvp(
            lambda *x: tuple(fn(*x)), tuple(primals),
            tuple(t[k] for t in tangents))
        for i, (o, v, rv, rtan) in enumerate(zip(outs, values, ref_v,
                                                 ref_t)):
            assert torch.equal(o.v, v), (name, i)     # values: the plain ops
            err = (torch.broadcast_to(o.d[k], rtan.shape) - rtan).abs().max()
            assert err <= RULES_TOL * rtan.abs().max(), (name, k, i)
            torch.testing.assert_close(rv, v, rtol=0, atol=0)


def test_dual_layout_round_trips():
    """``stack`` lays Duals out as the tangent kernels do (values, then each
    direction) and ``split`` reads that layout back."""
    rng = np.random.default_rng(32)
    cols = [Dual(torch.from_numpy(rng.standard_normal((2, 5))),
                 torch.from_numpy(rng.standard_normal((3, 2, 5))))
            for _ in range(4)]
    aug = dual.stack(cols)
    assert aug.shape == (16, 2, 5)
    torch.testing.assert_close(aug[4 * 2 + 1], cols[1].d[1], rtol=0, atol=0)
    back = dual.split(aug[None].expand(7, 16, 2, 5), 4, axis=1)
    assert back.shape == (7, 4, 2, 5) and back.d.shape == (3, 7, 4, 2, 5)
    for i, c in enumerate(cols):
        torch.testing.assert_close(back.v[:, i], c.v.expand(7, 2, 5),
                                   rtol=0, atol=0)
        torch.testing.assert_close(back.d[:, :, i], c.d[:, None].expand(
            3, 7, 2, 5), rtol=0, atol=0)
    torch.testing.assert_close(dual.rows(cols[0]), torch.cat(
        [cols[0].v[None], cols[0].d]), rtol=0, atol=0)


@pytest.mark.parametrize("model,mode", [("lorenz", "kramer"),
                                        ("fitzhugh", "rodeo")])
def test_tangent_twins_match_torch_jvp(model, mode):
    """Each twin of a tangent kernel, run on Duals, against torch.func.jvp
    of the value twin along each direction, in float64 over a few steps."""
    rng = np.random.default_rng(33)
    n_steps, nb = 6, TMODELS[model].N_VARS
    ops, obs, ld0 = _filter_operands(model, n_steps, 0.6, seed=34,
                                     dtype=torch.float64)
    ops = {k: (v.double() if isinstance(v, torch.Tensor) else v)
           for k, v in ops.items()}
    obs = {k: v.double() for k, v in obs.items()}
    fused = fk.resolve_model(model)
    theta = ops.pop("theta_lanes")

    def filt(th):
        return fk._filter_batch_plain(fused, n_steps, **ops,
                                      theta_lanes=th, mode=mode)

    def dalton(th):
        return fd._dalton_filter_plain(fused, n_steps, **ops, theta_lanes=th,
                                       **obs, ld0=ld0.double(), mode=mode,
                                       with_obs=True)

    aug = fk._filter_batch_tan_plain(fused, n_steps, **ops,
                                     theta_lanes=theta, mode=mode)
    seed = torch.cat([ld0.double()[None], ld0.new_zeros((3, N_LANE),
                                                        dtype=torch.float64)])
    aug_d = fd._dalton_filter_tan_plain(fused, n_steps, **ops,
                                        theta_lanes=theta, **obs, ld0=seed,
                                        mode=mode, with_obs=True)
    chain = [torch.from_numpy(rng.standard_normal(a.shape)) * 0.1 + a
             for a in aug[:3]]
    for k in range(N_TAN):
        e = torch.zeros_like(theta)
        e[k] = 1.0
        _, tans = torch.func.jvp(filt, (theta,), (e,))
        for out, ref, K in zip(aug, tans, (9, 3, 6, 3, 6)):
            sl = out.narrow(out.dim() - 3, (1 + k) * K, K)
            assert _scaled_err(sl, ref) <= RULES_TOL, (k, K)
        _, tan_d = torch.func.jvp(dalton, (theta,), (e,))
        assert _scaled_err(aug_d[1 + k], tan_d) <= RULES_TOL, k
    # the backward twins, along the tangents of a chain
    A, b, C = chain
    d, y, om, mask = (_grid(rng, n_steps, nb)[k] for k in range(4))
    m_seed, p_seed = aug[3], aug[4]
    ld_aug = ff._fenrir_backward_tan_plain(A, b, C, d, y, om, mask, m_seed,
                                           p_seed, N_TAN)
    ms_aug = fk._smoother_mean_tan_plain(b, A, m_seed, N_TAN)
    prim = [x.narrow(1 if x.dim() == 4 else 0, 0, K)
            for x, K in zip((A, b, C, m_seed, p_seed), (9, 3, 6, 3, 6))]

    def tan_of(x, K, k):
        return x.narrow(1 if x.dim() == 4 else 0, (1 + k) * K, K)

    for k in range(N_TAN):
        tans = [tan_of(x, K, k) for x, K in zip((A, b, C, m_seed, p_seed),
                                               (9, 3, 6, 3, 6))]
        _, ref = torch.func.jvp(
            lambda A_, b_, C_, m_, p_: ff._fenrir_backward_plain(
                A_, b_, C_, d, y, om, mask, m_, p_), tuple(prim), tuple(tans))
        assert _scaled_err(ld_aug[1 + k], ref) <= RULES_TOL, k
        _, ref_ms = torch.func.jvp(
            lambda g_, G_, m_: fk._smoother_batch_plain(
                g_, G_, prim[2], m_, prim[4])[0],
            (prim[1], prim[0], prim[3]), (tans[1], tans[0], tans[3]))
        assert _scaled_err(ms_aug[:, (1 + k) * Q:(2 + k) * Q], ref_ms) \
            <= RULES_TOL, k


# --- the twins against the Pallas tangent kernels ---------------------------------


def _problem(model, n_steps, t_max, n_obs, n_lane, seed):
    """A lane batch and observations from a seed, as float32 numpy: thetas
    perturbed by 1% per lane, the 0th derivative of every variable observed
    at n_obs evenly spaced times with variance 0.005."""
    jmod = JMODELS[model]
    cfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    theta = np.asarray(cfg.pop("theta"))
    rng = np.random.default_rng(seed)
    nb = jmod.N_VARS
    thetas = (theta[None] * (1 + 0.01 * rng.standard_normal((n_lane, 3)))
              ).astype(np.float32)
    inits = np.broadcast_to(np.asarray(cfg["ode_init"]),
                            (n_lane,) + cfg["ode_init"].shape)
    obs_w = np.zeros((n_obs, nb, 1, 3), np.float32)
    obs_w[..., 0] = 1.0
    return dict(
        cfg=cfg, thetas=thetas, inits=np.ascontiguousarray(inits, np.float32),
        obs_data=(rng.standard_normal((n_obs, nb, 1)) * 5).astype(np.float32),
        obs_times=np.linspace(0.0, t_max, n_obs),
        obs_weight=obs_w,
        obs_var=np.full((n_obs, nb, 1, 1), 0.005, np.float32))


def _port_args(prob, model, n_steps, t_max, mode):
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    return dict(thetas=torch.from_numpy(prob["thetas"]),
                ode_weight=tcfg["ode_weight"],
                ode_inits=torch.from_numpy(prob["inits"]), t_min=0.0,
                t_max=t_max, n_steps=n_steps, prior_pars=tcfg["prior_pars"],
                model=model, interrogation=mode, device="cpu")


def _obs(prob):
    return {k: prob[k] for k in ("obs_data", "obs_times", "obs_weight",
                                 "obs_var")}


def _filter_operands(model, n_steps, t_max, seed, dtype=torch.float32):
    """The tangent filters' operands for a seeded lane batch, as the port
    builds them: K1's operands, DALTON's observation grid and seed."""
    prob = _problem(model, n_steps, t_max, 7, N_LANE, seed)
    args = _port_args(prob, model, n_steps, t_max, None)
    ops, obs, ld0 = fd._dalton_prepare(
        args["thetas"], args["ode_weight"], args["ode_inits"], 0.0, t_max,
        n_steps, args["prior_pars"], *[torch.as_tensor(prob[k]) for k in (
            "obs_data", "obs_times", "obs_weight", "obs_var")])
    return ops, obs, ld0


def _grid(rng, n_steps, nb):
    """A seeded observation grid (d, y, om, mask) with data at ~1/3 of the
    steps, float64."""
    mask = (rng.random(n_steps) < 0.3).astype(np.float64)
    d = rng.standard_normal((n_steps, Q, nb)) * mask[:, None, None]
    y = rng.standard_normal((n_steps, nb)) * mask[:, None]
    om = np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)), 1.0)
    return [torch.from_numpy(a) for a in (d, y, om, mask)]


def _vmem(shape):
    return pl.BlockSpec(shape, lambda i: tuple([0] * len(shape)),
                        memory_space=pltpu.VMEM)


def _jac(model, mode):
    return getattr(JMODELS[model], f"{model}_jac_flat") \
        if mode == "kramer" else None


@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_filter_tan_twin_matches_pallas(model, mode, n_steps, t_max, n_obs):
    """K11a's twin against pallas_fenrir.fused_filter_batch_tan(emit=
    "gains"): every output, values and each direction on their own."""
    ops, _, _ = _filter_operands(model, n_steps, t_max, seed=35)
    jmod = JMODELS[model]
    ref = pf.fused_filter_batch_tan(
        getattr(jmod, f"{model}_flat"), _jac(model, mode), mode, N_TAN,
        n_steps, None, ops["prior_var"].numpy(), ops["ode_weight"].numpy(),
        ops["x0_lanes"].numpy(), ops["theta_lanes"].numpy(),
        ops["tgrid"].numpy(), ops["t_vec"].numpy(), ops["q_const"],
        interpret=True, emit="gains")
    fk.LAUNCHES["filter_batch_tan"] = 0
    port = fk.fused_filter_batch_tan(model, n_steps, **ops, mode=mode)
    assert fk.LAUNCHES["filter_batch_tan"] == 0     # the CPU takes the twin
    for name, a, r, K in zip(["A", "b", "C", "m_last", "p_last"], port, ref,
                             (9, 3, 6, 3, 6)):
        assert a.shape == r.shape and torch.isfinite(a).all(), name
        axis = 1 if a.dim() == 4 else 0
        errs = _per_slice(a, r, K, axis)
        assert max(errs) <= SCALED_TOL, (name, errs)


def _tan_chain(n_steps, nb, B, seed):
    """A seeded augmented backward chain (values and N_TAN tangents),
    observation grid and seeds, float32 numpy."""
    rng = np.random.default_rng(seed)
    pairs, _ = fk._tri_idx(Q)
    A = np.eye(Q).reshape(1, Q * Q, 1, 1) * 0.8 + \
        0.1 * rng.standard_normal((n_steps, Q * Q, nb, B))
    M = 0.3 * rng.standard_normal((n_steps, nb, B, Q, Q))
    Cf = M @ np.swapaxes(M, -1, -2)
    C = np.stack([Cf[..., i, j] for i, j in pairs], axis=1)
    Mp = rng.standard_normal((nb, B, Q, Q))
    Pf = Mp @ np.swapaxes(Mp, -1, -2)
    p_seed = np.stack([Pf[..., i, j] for i, j in pairs])

    def aug(v, axis):
        tans = [0.1 * rng.standard_normal(v.shape) for _ in range(N_TAN)]
        return np.concatenate([v] + tans, axis=axis)

    d, y, om, mask = (t.numpy() for t in _grid(rng, n_steps, nb))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(A=f32(aug(A, 1)),
                b=f32(aug(rng.standard_normal((n_steps, Q, nb, B)), 1)),
                C=f32(aug(C, 1)), d=f32(d), y=f32(y), om=f32(om),
                mask=f32(mask),
                m_seed=f32(aug(rng.standard_normal((Q, nb, B)), 0)),
                p_seed=f32(aug(p_seed, 0)),
                ld0=f32(rng.standard_normal((1 + N_TAN, B))))


def test_fenrir_backward_tan_twin_matches_pallas():
    """K11b's twin against a pallas_call of
    _fenrir_backward_kernel_batch_tan on a seeded augmented chain."""
    n_steps, nb, B = 60, 3, N_LANE
    n_aug = 1 + N_TAN
    ch = _tan_chain(n_steps, nb, B, seed=36)
    kern = functools.partial(pf._fenrir_backward_kernel_batch_tan, N_TAN,
                             n_steps, Q, nb, N_TRI, B)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n_aug, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_steps, n_aug * Q * Q, nb, B)),
                  _vmem((n_steps, n_aug * Q, nb, B)),
                  _vmem((n_steps, n_aug * N_TRI, nb, B)),
                  _vmem((n_steps, Q, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1)),
                  _vmem((n_aug * Q, nb, B)), _vmem((n_aug * N_TRI, nb, B)),
                  _vmem((n_aug, B))],
        out_specs=_vmem((n_aug, B)),
        scratch_shapes=[pltpu.VMEM((n_aug * Q, nb, B), jnp.float32),
                        pltpu.VMEM((n_aug * N_TRI, nb, B), jnp.float32),
                        pltpu.VMEM((n_aug, B), jnp.float32)],
        interpret=True,
    )(ch["A"], ch["b"], ch["C"], ch["d"][..., None],
      ch["y"][:, None, :, None], ch["om"][:, None, :, None],
      ch["mask"][:, None], ch["m_seed"], ch["p_seed"], ch["ld0"])
    ff.LAUNCHES["fenrir_backward_batch_tan"] = 0
    port = ff.fenrir_backward_batch_tan(*[torch.from_numpy(ch[k]) for k in (
        "A", "b", "C", "d", "y", "om", "mask", "m_seed", "p_seed", "ld0")])
    assert ff.LAUNCHES["fenrir_backward_batch_tan"] == 0
    assert port.shape == (n_aug, B)
    for a in range(n_aug):
        assert _scaled_err(port[a], ref[a]) <= SCALED_TOL, a


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("model,mode,n_steps,t_max", [
    ("lorenz", "kramer", 60, 0.6), ("fitzhugh", "rodeo", 60, 3.0)])
def test_dalton_filter_tan_twin_matches_pallas(model, mode, n_steps, t_max,
                                               with_obs):
    """K11c's twin against a pallas_call of _dalton_filter_kernel_tan, with
    and without the data, the seed's tangents nonzero."""
    ops, obs, ld0 = _filter_operands(model, n_steps, t_max, seed=37)
    jmod = JMODELS[model]
    q, nb, B = ops["x0_lanes"].shape
    n_aug = 1 + N_TAN
    seed = torch.cat([ld0[None], torch.from_numpy(
        np.random.default_rng(38).standard_normal((N_TAN, B))
        .astype(np.float32))])
    kern = functools.partial(
        pd._dalton_filter_kernel_tan, getattr(jmod, f"{model}_flat"),
        _jac(model, mode), with_obs, N_TAN, n_steps, q, nb, N_TRI, B,
        ops["q_const"])
    pairs, _ = fk._tri_idx(q)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n_aug, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((nb, N_TRI)), _vmem((nb, q)), _vmem((q, nb, B)),
                  _vmem((3, B)), _vmem((n_steps, 1)), _vmem((1, q)),
                  _vmem((n_steps, q, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1)),
                  _vmem((n_aug, B))],
        out_specs=_vmem((n_aug, B)),
        scratch_shapes=[pltpu.VMEM((n_aug * q, nb, B), jnp.float32),
                        pltpu.VMEM((n_aug * N_TRI, nb, B), jnp.float32),
                        pltpu.VMEM((n_aug, B), jnp.float32)],
        interpret=True,
    )(fk._pack_tri(ops["prior_var"], pairs).numpy(),
      ops["ode_weight"].numpy(), ops["x0_lanes"].numpy(),
      ops["theta_lanes"].numpy(), ops["tgrid"].numpy()[:, None],
      ops["t_vec"].numpy()[None], obs["d"].numpy()[..., None],
      obs["y"].numpy()[:, None, :, None], obs["om"].numpy()[:, None, :, None],
      obs["mask"].numpy()[:, None], seed.numpy())
    fd.LAUNCHES["dalton_filter_batch_tan"] = 0
    port = fd.dalton_filter_batch_tan(model, n_steps, **ops, **obs,
                                      ld0=seed, mode=mode, with_obs=with_obs)
    assert fd.LAUNCHES["dalton_filter_batch_tan"] == 0
    assert port.shape == (n_aug, B) and torch.isfinite(port).all()
    for a in range(n_aug):
        assert _scaled_err(port[a], ref[a]) <= SCALED_TOL, a


def test_smoother_mean_tan_twin_matches_pallas():
    """K11e's twin against pallas_kalman.smoother_mean_recursion_batch_tan
    on a seeded augmented chain."""
    n_steps, nb, B = 60, 3, N_LANE
    ch = _tan_chain(n_steps, nb, B, seed=39)
    ref = pk.smoother_mean_recursion_batch_tan(
        ch["b"], ch["A"], ch["m_seed"], N_TAN, interpret=True)
    fk.LAUNCHES["smoother_mean_batch_tan"] = 0
    port = fk.smoother_mean_recursion_batch_tan(
        torch.from_numpy(ch["b"]), torch.from_numpy(ch["A"]),
        torch.from_numpy(ch["m_seed"]), N_TAN)
    assert fk.LAUNCHES["smoother_mean_batch_tan"] == 0
    assert port.shape == ref.shape
    errs = _per_slice(port, ref, Q, 1)
    assert max(errs) <= SCALED_TOL, errs


# --- the entry points end to end --------------------------------------------------


def _b_loglik_jax(obs_data, ode_data, **params):
    return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def _b_loglik_torch(obs_data, ode_data, **params):
    return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def _calls(prob, model, mode, n_steps, t_max):
    """Per entry point: the JAX gradient call, the port's gradient call and
    its value call, each returning (loglik, grad) / loglik."""
    jmod = JMODELS[model]
    cfg = prob["cfg"]

    def jax_call(fn, **kw):
        run = jax.jit(lambda ts, x0: fn(
            thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0, t_min=0.0,
            t_max=t_max, n_steps=n_steps, prior_pars=cfg["prior_pars"],
            ode_flat=getattr(jmod, f"{model}_flat"),
            jac_flat=_jac(model, mode), interpret=True, **kw)[:2])
        return lambda: run(jnp.asarray(prob["thetas"]),
                           jnp.asarray(prob["inits"]))

    port = _port_args(prob, model, n_steps, t_max, mode)
    basic_j = dict(obs_data=prob["obs_data"], obs_times=prob["obs_times"],
                   obs_loglik=_b_loglik_jax)
    basic_t = dict(obs_data=torch.from_numpy(prob["obs_data"]),
                   obs_times=prob["obs_times"], obs_loglik=_b_loglik_torch)
    return {
        "fenrir": (jax_call(pf.fenrir_fused_batch_grad, **_obs(prob)),
                   lambda: ff.fenrir_fused_batch_grad(**port, **_obs(prob)),
                   lambda: ff.fenrir_fused_batch(**port, **_obs(prob))),
        "dalton": (jax_call(pd.dalton_fused_batch_grad, **_obs(prob)),
                   lambda: fd.dalton_fused_batch_grad(**port, **_obs(prob)),
                   lambda: fd.dalton_fused_batch(**port, **_obs(prob))),
        "basic": (jax_call(pk.basic_fused_batch_grad, **basic_j),
                  lambda: fk.basic_fused_batch_grad(**port, **basic_t)[:2],
                  lambda: fk.basic_fused_batch(**port, **basic_t)[0]),
    }


@pytest.mark.parametrize("entry", ["fenrir", "dalton", "basic"])
@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_grad_entry_points_match_jax(model, mode, n_steps, t_max, n_obs,
                                     entry):
    prob = _problem(model, n_steps, t_max, n_obs, N_LANE, seed=40)
    jax_call, port_call, _ = _calls(prob, model, mode, n_steps, t_max)[entry]
    ll_j, g_j = jax_call()
    ll_t, g_t = port_call()
    assert ll_t.shape == (N_LANE,) and g_t.shape == (N_LANE, 3)
    assert torch.isfinite(ll_t).all() and torch.isfinite(g_t).all()
    rtol, grad_rtol = ((DALTON_RTOL, DALTON_GRAD_RTOL) if entry == "dalton"
                       else (LOGLIK_RTOL, GRAD_RTOL))
    assert _scaled_err(ll_t, ll_j) <= rtol
    g_j = np.asarray(g_j)
    for k in range(3):
        assert _scaled_err(g_t[:, k], g_j[:, k]) <= grad_rtol, k


@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_solve_grad_matches_jax(model, mode, n_steps, t_max, n_obs):
    """solve_mv_fused_batch_grad's mean and sensitivities against the JAX
    package's; row 0 (the initial state) has no tangent."""
    prob = _problem(model, n_steps, t_max, n_obs, N_LANE, seed=41)
    jmod = JMODELS[model]
    cfg = prob["cfg"]
    mean_j, dmean_j = jax.jit(lambda ts, x0: pk.solve_mv_fused_batch_grad(
        thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0, t_min=0.0,
        t_max=t_max, n_steps=n_steps, prior_pars=cfg["prior_pars"],
        ode_flat=getattr(jmod, f"{model}_flat"), jac_flat=_jac(model, mode),
        interpret=True))(jnp.asarray(prob["thetas"]),
                         jnp.asarray(prob["inits"]))
    port = _port_args(prob, model, n_steps, t_max, mode)
    mean_t, dmean_t = fk.solve_mv_fused_batch_grad(**port)
    assert mean_t.shape == mean_j.shape and dmean_t.shape == dmean_j.shape
    assert (dmean_t[:, 0] == 0).all()
    for d in range(Q):
        assert _scaled_err(mean_t[..., d, :], mean_j[..., d, :]) \
            <= SCALED_TOL, d
        for k in range(N_TAN):
            assert _scaled_err(dmean_t[k, ..., d, :],
                               np.asarray(dmean_j)[k, ..., d, :]) \
                <= GRAD_RTOL, (k, d)
    torch.testing.assert_close(mean_t, fk.solve_mv_fused_batch(
        **{k: v for k, v in port.items() if k != "interrogation"},
        interrogation=mode)[0], rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["fenrir", "dalton", "basic"])
@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_grad_values_equal_the_value_entry_points(model, mode, n_steps, t_max,
                                                  n_obs, entry):
    """On the CPU a gradient entry point's log-likelihood is its value entry
    point's, bitwise: the Duals' values are the plain operations."""
    prob = _problem(model, n_steps, t_max, n_obs, N_LANE, seed=42)
    _, port_call, value_call = _calls(prob, model, mode, n_steps,
                                      t_max)[entry]
    np.testing.assert_array_equal(port_call()[0].numpy(),
                                  value_call().numpy())


@pytest.mark.parametrize("entry", ["fenrir", "dalton", "basic"])
def test_fused_loglik_backward_gives_the_gradient(entry):
    """fused_loglik's backward hands the explicit gradient to thetas."""
    model, mode, n_steps, t_max, n_obs = CASES[0]
    prob = _problem(model, n_steps, t_max, n_obs, N_LANE, seed=43)
    port = _port_args(prob, model, n_steps, t_max, mode)
    thetas = port.pop("thetas").double().requires_grad_(True)
    grad_fn, extra = {
        "fenrir": (rt.fenrir_fused_batch_grad, _obs(prob)),
        "dalton": (rt.dalton_fused_batch_grad, _obs(prob)),
        "basic": (rt.basic_fused_batch_grad, dict(
            obs_data=torch.from_numpy(prob["obs_data"]),
            obs_times=prob["obs_times"], obs_loglik=_b_loglik_torch)),
    }[entry]
    loglik = rt.fused_loglik(grad_fn, thetas, **port, **extra)
    weights = torch.arange(1.0, N_LANE + 1)
    (loglik * weights).sum().backward()
    ll, grad = grad_fn(thetas=thetas.detach(), **port, **extra)[:2]
    assert thetas.grad.dtype == torch.float64
    torch.testing.assert_close(loglik.detach(), ll, rtol=0, atol=0)
    torch.testing.assert_close(thetas.grad, (weights[:, None] * grad)
                               .double(), rtol=0, atol=0)


def _chip_smoke():
    """chip_smoke.py as a module (its imports of torch and the package are
    inside main), for the audit constants it states."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bench_lanes(theta, n_lane):
    """bench.py's lane batch as chip_smoke.py makes it, in float32:
    theta * (1 + 1e-6 * lane index)."""
    lanes = torch.arange(n_lane, dtype=torch.float32)
    return theta.float().expand(n_lane, 3) * (1 + 1e-6 * lanes[:, None])


def test_dalton_gradient_in_float64_is_the_truth():
    """The DALTON tangent twin run in float64 on bench.py's likelihood
    fixture (Lorenz63 EK1, 4000 steps to t = 20, 21 observations) gives the
    cached float64 truth's value and gradient at theta; at the float32
    thetas of chip_smoke.py's lanes 0-7 (theta rounded to float32, then
    moved by at most 7e-6 of itself) the exact gradient lands 0.03 to 0.4
    of its norm away from it, 0.11 at lane 0.  Every float32 evaluation starts from such a
    theta, so no float32 gradient on this configuration can be held to the
    truth; chip_smoke.py states lane 0's distance (GRAD_THETA_ROUNDING) and
    records the gradient as unusable in float32."""
    import math
    from pathlib import Path
    from rodeo_tpu_torch.ops.obs_grid import obs_indices
    from rodeo_tpu_torch.ops.precond import scale_prior, taylor_scale

    truth = np.load(Path(__file__).resolve().parents[1] / ".bench_ref_v8.npz")
    n, t_max, q, f64 = 4000, 20.0, Q, torch.float64
    cfg = tlorenz.setup(n_steps=n, t_max=t_max, dtype=f64, device="cpu")
    n_lane = 1 + 8
    dt = t_max / n
    t_vec = taylor_scale(dt, q, dtype=f64, device="cpu")
    _, Rs = scale_prior(cfg["prior_pars"], t_vec)
    # the scaled transition in float64 (the kernels round it to float32)
    tv = np.array([math.sqrt(dt) * dt ** (q - 1 - i) / math.gamma(q - i)
                   for i in range(q)])
    qw = cfg["prior_pars"][0][0].numpy()
    q_const = [[float(qw[i, j] * tv[j] / tv[i]) for j in range(q)]
               for i in range(q)]
    theta = torch.cat([cfg["theta"][None],
                       _bench_lanes(cfg["theta"], n_lane - 1).double()]).T
    x0 = (cfg["ode_init"][None] / t_vec).permute(2, 1, 0).expand(q, 3,
                                                                 n_lane)
    ops = dict(q_const=q_const, prior_var=Rs,
               ode_weight=(cfg["ode_weight"] * t_vec)[:, 0, :],
               t_vec=t_vec, x0_lanes=x0.contiguous(), theta_lanes=theta,
               tgrid=t_max * (torch.arange(n, dtype=f64) + 1) / n)
    data = torch.from_numpy(np.random.default_rng(0).normal(size=(21, 3)) * 5)
    idx = obs_indices(0.0, t_max, n, np.linspace(0.0, t_max, 21))
    d = torch.zeros((n + 1, q, 3), dtype=f64)
    d[idx, 0] = t_vec[0]
    y = torch.zeros((n + 1, 3), dtype=f64)
    y[idx] = data
    om = torch.ones((n + 1, 3), dtype=f64)
    om[idx] = 0.005
    mask = torch.zeros(n + 1, dtype=f64)
    mask[idx] = 1.0
    z0 = y[0] - cfg["ode_init"][:, 0]
    ld0 = -0.5 * (z0 * z0 / 0.005 + math.log(0.005) + fk._LOG2PI).sum()
    grid = dict(d=d[1:], y=y[1:], om=om[1:], mask=mask[1:])
    seed = torch.zeros((1 + N_TAN, n_lane), dtype=f64)
    seed[0] = ld0
    fused = fk.resolve_model("lorenz")
    joint = fd._dalton_filter_tan_plain(fused, n, **ops, **grid, ld0=seed,
                                        mode="kramer", with_obs=True)
    marg = fd._dalton_filter_tan_plain(fused, n, **ops, **grid,
                                       ld0=torch.zeros_like(seed),
                                       mode="kramer", with_obs=False)
    ll, grad = (joint - marg)[0].numpy(), (joint - marg)[1:].T.numpy()
    ref = truth["dalton_grad"]
    rel = np.linalg.norm(grad - ref, axis=1) / np.linalg.norm(ref)
    np.testing.assert_allclose(ll[0], truth["dalton_ll"], rtol=1e-12)
    assert rel[0] <= 1e-6, rel
    assert 0.03 < rel[1:].min() and rel[1:].max() < 0.4, rel
    smoke = _chip_smoke()
    assert rel[1] > smoke.GRAD_CONTROL_MAX
    np.testing.assert_allclose(smoke.GRAD_THETA_ROUNDING["dalton"], rel[1],
                               rtol=1e-3)


def test_jax_dalton_gradient_in_float32_spreads_over_lanes():
    """The JAX package's own DALTON tangent kernel (Pallas, interpret mode,
    float32) on bench.py's likelihood fixture at chip_smoke.py's lanes 0-7:
    the values agree with the truth as the audit requires, but the
    gradients land 0.006 to 2.3 of the truth's norm away, half of them
    beyond 3x the float32-CPU control of bench.py's rule (0.114), as the
    float64 spread of the exact gradient over these thetas says they may;
    the reverse-mode control's 0.038 is one draw of such a spread."""
    from pathlib import Path

    truth = np.load(Path(__file__).resolve().parents[1] / ".bench_ref_v8.npz")
    ctrl = np.load(Path(__file__).resolve().parents[1]
                   / ".bench_ref_v8_ctrl.npz")
    n, t_max, n_lane, n_obs = 4000, 20.0, 8, 21
    cfg = jlorenz.setup(n_steps=n, t_max=t_max, dtype=jnp.float32)
    thetas = jnp.asarray(_bench_lanes(torch.from_numpy(
        np.asarray(cfg.pop("theta"))), n_lane).numpy())
    weight = jnp.zeros((n_obs, 3, 1, Q), jnp.float32).at[..., 0].set(1.0)
    ll, grad = jax.jit(lambda th: pd.dalton_fused_batch_grad(
        thetas=th, ode_weight=cfg["ode_weight"],
        ode_inits=jnp.broadcast_to(cfg["ode_init"],
                                   (n_lane,) + cfg["ode_init"].shape),
        t_min=0.0, t_max=t_max, n_steps=n, prior_pars=cfg["prior_pars"],
        obs_data=jnp.asarray(np.random.default_rng(0).normal(
            size=(n_obs, 3, 1)) * 5, jnp.float32),
        obs_times=jnp.linspace(0.0, t_max, n_obs, dtype=jnp.float32),
        obs_weight=weight,
        obs_var=jnp.full((n_obs, 3, 1, 1), 0.005, jnp.float32),
        ode_flat=jlorenz.lorenz_flat, jac_flat=jlorenz.lorenz_jac_flat,
        interpret=True))(thetas)
    ref = truth["dalton_grad"]
    rel = (np.linalg.norm(np.asarray(grad, np.float64) - ref, axis=1)
           / np.linalg.norm(ref))
    control = (np.linalg.norm(ctrl["dalton_grad_f32cpu"] - ref)
               / np.linalg.norm(ref))
    assert abs(float(ll[0]) - float(truth["dalton_ll"])) <= 1e-4 * abs(
        float(truth["dalton_ll"]))
    assert rel.max() - rel.min() > 0.3, rel
    assert (rel > 3 * control).any(), (rel, control)


def test_fitzhugh_gradient_in_float32_is_the_truth():
    """bench.py's FitzHugh-Nagumo gradient fixture (EK1, 200 steps to
    t = 10, y_fitz_mcmc observed every 10th step with sigma 0.2) through
    fenrir_fused_batch_grad on the CPU, in float32: lane 0's gradient is
    within chip_smoke.py's GRAD_FITZ_TOL of the cached float64 truth, the
    limit it holds the card's to.  The float32-CPU control of that
    gradient is not a control: on a float32 grid (the JAX package without
    64-bit floats) searchsorted places 19 of the 21 observation times one
    step late, so that run evaluates another likelihood."""
    from pathlib import Path

    truth = np.load(Path(__file__).resolve().parents[1] / ".bench_ref_v8.npz")
    n, t_max, n_lane = 200, 10.0, 2
    cfg = tfitzhugh.setup(n_steps=n, t_max=t_max, dtype=torch.float32,
                          device="cpu")
    idx = np.arange(0, n + 1, 10)
    weight = torch.zeros((len(idx), 2, 1, Q))
    weight[..., 0] = 1.0
    ll, grad = rt.fenrir_fused_batch_grad(
        thetas=_bench_lanes(cfg["theta"], n_lane),
        ode_weight=cfg["ode_weight"],
        ode_inits=cfg["ode_init"].expand((n_lane, 2, Q)), t_min=0.0,
        t_max=t_max, n_steps=n, prior_pars=cfg["prior_pars"],
        obs_data=torch.tensor(truth["y_fitz_mcmc"], dtype=torch.float32)
        [:, :, None],
        obs_times=torch.tensor((t_max * idx / n).astype(np.float32)),
        obs_weight=weight,
        obs_var=torch.full((len(idx), 2, 1, 1), np.float32(0.2 ** 2)),
        model="fitzhugh", device="cpu")
    ref = truth["fenrir_fitz_grad"]
    rel = np.linalg.norm(grad[0].double().numpy() - ref) / np.linalg.norm(ref)
    np.testing.assert_allclose(ll[0].item(), truth["fenrir_fitz_ll"],
                               rtol=1e-4)
    assert rel <= _chip_smoke().GRAD_FITZ_TOL, rel
    grid32 = jnp.linspace(0.0, t_max, n + 1, dtype=jnp.float32)
    late = np.asarray(jnp.searchsorted(
        grid32, jnp.asarray(t_max * idx / n, jnp.float32))) - idx
    assert late.sum() == 19 and set(late.tolist()) == {0, 1}
