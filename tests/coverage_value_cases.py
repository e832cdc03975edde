"""
The small cases of the value-path coverage tests (``tests/
test_torch_coverage_value*.py``): Chkrebtii's ODE at q = 4 (the JAX
package's setup, 40 steps) and q = 5 (its W, x0 padded with a zero, the IBM
prior of 5 derivatives), and Hes1 and SEIRAH at a quarter of their horizons
in 40 steps, each as the JAX package's and the port's float32 setup, with
N_LANE numpy-seeded lanes and observations of derivative 0 of every block
at 5 steps of the grid.

The JAX package's batched entries take Hes1's and SEIRAH's Jacobian from
``jvp_jac_flat``, whose seed columns hold one lane: under kramer they run
one lane a call (``jax_lanes``), each lane against the port's.

The gradient path's tests (``tests/test_torch_coverage_grad*.py``) take
these cases and FitzHugh-Nagumo at q = 4 and 5 (``GRAD_CASES``), the JAX
package's Hes1 and SEIRAH Jacobian for all lanes at once (``jac_lanes``),
and share their tolerances, the tangent kernels' seeded chains and the
solve's checks here; so do DALTON's gradient tests
(``tests/test_torch_coverage_dalton*.py``: check_dalton_case, the JAX
package's plain float64 reference and its fused tangent kernel traced in
float64, the witnesses where float32 does not resolve DALTON).
"""
import functools
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rodeo_tpu import interrogate as jint
from rodeo_tpu.models import chkrebtii as jchk, fitzhugh as jfitz
from rodeo_tpu.models import hes1 as jhes1, seirah as jseirah
from rodeo_tpu.ops import pallas_dalton as pd
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.ops import precond as jprecond
from rodeo_tpu.prior import ibm_init as j_ibm_init

from rodeo_tpu_torch.models import chkrebtii as tchk, fitzhugh as tfitz
from rodeo_tpu_torch.models import hes1 as thes1, seirah as tseirah
from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_coverage_reference as cov_ref  # noqa: E402

# tests/test_torch_fused_kalman.py's tolerance, of the largest reference
# entry; tests/test_torch_likelihood.py's for the likelihoods, relative
SCALED_TOL = 1e-4
LOGLIK_RTOL = 1e-4
DALTON_RTOL = 1e-3
# Chkrebtii's ODE at q = 5 is rounding-bound in both packages' float32
# solves (tests/test_torch_coverage.py)
Q5_TOL = 7.3e-3
# DALTON there is the difference of two sums of ~9.1e5 over these 40 steps,
# whose float32 ulp (0.0625) is 0.85 % of its value (~7.4): the port and
# the JAX package land one ulp apart on two of the 4 lanes (8.5e-3
# relative), each within two ulps of the float64 torch-op.  3 x the gap.
DALTON_Q5_TOL = 2.6e-2
# tests/test_torch_grad.py's tolerance of each parameter's gradient (or
# sensitivity), of its largest entry; at q = 5, where both packages'
# float32 values are rounding-bound (Q5_TOL), GRAD_Q5_TOL: their fenrir
# gradients on FitzHugh-Nagumo under rodeo lie up to 8.2e-4 (the port) and
# 4.0e-4 (the JAX package) of the largest entry from the JAX package's
# float64 plain reference, 1.2e-3 apart; 3 x the gap
GRAD_RTOL = 1e-3
GRAD_Q5_TOL = 3.7e-3
N_STEPS, N_LANE, N_OBS = 40, 4, 5
OBS_VAR = 0.005

# name: (model, q, interrogation)
CASES = {"chkrebtii_q4": ("chkrebtii", 4, "kramer"),
         "chkrebtii_q5": ("chkrebtii", 5, "kramer"),
         "hes1_kramer": ("hes1", 3, "kramer"),
         "hes1_rodeo": ("hes1", 3, "rodeo"),
         "seirah_kramer": ("seirah", 3, "kramer"),
         "seirah_rodeo": ("seirah", 3, "rodeo")}
_MODULES = {"chkrebtii": (jchk, tchk), "hes1": (jhes1, thes1),
            "seirah": (jseirah, tseirah), "fitzhugh": (jfitz, tfitz)}
# The gradient path's cases (tests/test_torch_coverage_grad*.py): those of
# the value path and FitzHugh-Nagumo at q = 4 and 5, the JAX package's
# setup with its weight and initial state padded with zeros past the third
# derivative and the IBM prior of q derivatives (built in numpy, the same
# arrays given to both packages), 40 steps to FITZ_T_MAX.
GRAD_CASES = {**CASES,
              "fitzhugh_q4_kramer": ("fitzhugh", 4, "kramer"),
              "fitzhugh_q4_rodeo": ("fitzhugh", 4, "rodeo"),
              "fitzhugh_q5_kramer": ("fitzhugh", 5, "kramer"),
              "fitzhugh_q5_rodeo": ("fitzhugh", 5, "rodeo")}
FITZ_T_MAX = 2.0
# the gradient cases where the JAX package's fused gradient path misses its
# own float64 plain reference (tests/test_torch_coverage_grad*.py measure
# it): FitzHugh-Nagumo under kramer at q = 4 and 5
JAX_FUSED_MISSES = ("fitzhugh_q4_kramer", "fitzhugh_q5_kramer")


def tol(name, rtol=SCALED_TOL, q5_tol=Q5_TOL):
    """The tolerance of case ``name``: ``rtol``, or ``q5_tol`` at q = 5."""
    return q5_tol if GRAD_CASES[name][1] == 5 else rtol


def _t(a):
    return torch.from_numpy(np.array(a))


def case(name, seed=40):
    """The JAX and port setups of case ``name``, its lanes and
    observations, all float32: a dict of ``model``, ``q``, ``mode``,
    ``t_max``, ``jcfg`` and ``tcfg`` (theta popped out), ``jflat`` and
    ``jjac`` (the JAX package's right-hand side and Jacobian; ``jjac`` None
    under rodeo), ``per_lane`` (whether the JAX package's batch takes one
    lane a call), ``thetas`` ``(B, n_theta)`` and ``inits`` ``(B, n_block,
    q)`` as numpy, and ``obs`` (numpy observations: the port's solve's x at
    N_OBS steps of the grid, at the setup's theta and x0, plus normals of
    variance OBS_VAR, as chip_smoke.py's coverage_value phase makes them:
    every lane lies off them, as a parameter sweep's lanes do).
    Chkrebtii's ODE has no parameter: its lanes scale x0 by 1 + 1e-3 x
    normals; the others scale theta by 1 + 0.01 x normals.  ``name`` is one
    of GRAD_CASES."""
    model, q, mode = GRAD_CASES[name]
    jmod, tmod = _MODULES[model]
    rng = np.random.default_rng(seed)
    if model == "fitzhugh":
        t_max = FITZ_T_MAX
        jcfg = jfitz.setup(n_steps=N_STEPS, t_max=t_max, dtype=jnp.float32)
        theta = np.asarray(jcfg.pop("theta"), np.float32)
        pad = ((0, 0), (0, 0), (0, q - 3))
        W = np.pad(np.asarray(jcfg["ode_weight"], np.float32), pad)
        x0 = np.pad(np.asarray(jcfg["ode_init"], np.float32), pad[1:])
        prior = [np.asarray(a, np.float32) for a in j_ibm_init(
            t_max / N_STEPS, q, jnp.array([0.1, 0.1], jnp.float32))]
        jcfg.update(ode_weight=jnp.asarray(W), ode_init=jnp.asarray(x0),
                    prior_pars=tuple(jnp.asarray(a) for a in prior))
        tcfg = dict(ode_weight=_t(W), ode_init=_t(x0),
                    prior_pars=tuple(_t(a) for a in prior))
        jac = lambda x, th, t: jfitz.fitzhugh_jac_flat(x, th, t) + \
            [None] * (q - 3)  # noqa: E731
        thetas = (theta * (1 + 0.01 * rng.standard_normal(
            (N_LANE, theta.shape[0])))).astype(np.float32)
        inits = np.ascontiguousarray(np.broadcast_to(
            x0, (N_LANE,) + x0.shape), np.float32)
        per_lane = False
    elif model == "chkrebtii":
        t_max = 10.0
        jcfg = jchk.setup(n_steps=N_STEPS, dtype=jnp.float32)
        jcfg.pop("theta")
        jac = jchk.chkrebtii_jac_flat
        if q == 5:
            jac = lambda x, th, t: jchk.chkrebtii_jac_flat(x, th, t) + [None]
            jcfg["ode_weight"] = jnp.zeros((1, 1, 5), jnp.float32).at[
                :, :, 2].set(1.0)
            jcfg["ode_init"] = jnp.array([[-1.0, 0.0, 1.0, 0.0, 0.0]],
                                         jnp.float32)
            jcfg["prior_pars"] = tuple(
                a.astype(jnp.float32) for a in j_ibm_init(
                    t_max / N_STEPS, 5, jnp.array([0.1], jnp.float32)))
        tcfg = tchk.setup(n_steps=N_STEPS, dtype=torch.float32,
                          device="cpu", n_deriv=q)
        tcfg.pop("theta")
        x0 = np.asarray(jcfg["ode_init"], np.float32)
        theta = np.zeros(1, np.float32)
        thetas = np.zeros((N_LANE, 1), np.float32)
        inits = (x0 * (1 + 1e-3 * rng.standard_normal(
            (N_LANE,) + x0.shape))).astype(np.float32)
        per_lane = False
    else:
        t_max = jmod.setup()["t_max"] / 4
        jcfg = jmod.setup(n_steps=N_STEPS, t_max=t_max, dtype=jnp.float32)
        theta = np.asarray(jcfg.pop("theta"), np.float32)
        tcfg = tmod.setup(n_steps=N_STEPS, t_max=t_max, dtype=torch.float32,
                          device="cpu")
        tcfg.pop("theta")
        jac = pk.jvp_jac_flat(getattr(jmod, f"{model}_flat"), jmod.N_VARS, 3)
        thetas = (theta * (1 + 0.01 * rng.standard_normal(
            (N_LANE, theta.shape[0])))).astype(np.float32)
        inits = np.ascontiguousarray(np.broadcast_to(
            np.asarray(jcfg["ode_init"]), (N_LANE,) + jcfg["ode_init"].shape),
            np.float32)
        per_lane = mode == "kramer"
    # the observations: x of the port's solve at the setup's theta and x0
    idx = np.linspace(0, N_STEPS, N_OBS).astype(int)
    mean, _ = fk.solve_mv_fused_batch(
        _t(theta[None]), tcfg["ode_weight"], tcfg["ode_init"][None], 0.0,
        t_max, N_STEPS, tcfg["prior_pars"], model=model, device="cpu")
    nb = inits.shape[1]
    weight = np.zeros((N_OBS, nb, 1, q), np.float32)
    weight[..., 0] = 1.0
    data = mean.numpy()[idx, :, 0, 0][..., None] + OBS_VAR ** 0.5 * \
        rng.standard_normal((N_OBS, nb, 1))
    obs = dict(obs_data=data.astype(np.float32),
               obs_times=np.linspace(0.0, t_max, N_STEPS + 1)[idx],
               obs_weight=weight,
               obs_var=np.full((N_OBS, nb, 1, 1), OBS_VAR, np.float32))
    return dict(model=model, q=q, mode=mode, t_max=t_max, jcfg=jcfg,
                tcfg=tcfg, jflat=getattr(jmod, f"{model}_flat"),
                jjac=jac if mode == "kramer" else None, per_lane=per_lane,
                thetas=thetas, inits=inits, obs=obs)


def jac_lanes(flat, n_block, q):
    """Column 0 of a right-hand side's block-diagonal Jacobian by one
    ``jax.jvp`` per block on lane-wide seeds, as ``pk.jvp_jac_flat``
    takes it on one lane: the JAX package's fused entries take it for all
    lanes at once (the tangent kernels nest it in their own ``jax.jvp``)."""
    def jac_flat(x_cols, th, t):
        col = None
        for b in range(n_block):
            seed = jnp.zeros_like(x_cols[0]).at[b].set(1.0)
            seeds = [seed] + [jnp.zeros_like(c) for c in x_cols[1:]]
            _, tang = jax.jvp(lambda cols: flat(cols, th, t), (x_cols,),
                              (seeds,))
            piece = tang[b:b + 1]
            col = piece if col is None else jnp.concatenate([col, piece])
        return [col] + [None] * (q - 1)

    return jac_flat


def jax_grad_case(name):
    """case(name), the JAX package's Jacobian of Hes1 and SEIRAH under
    kramer taken for all lanes at once (jac_lanes), as the gradient
    tests run its fused gradient entries."""
    c = case(name)
    if c["mode"] == "kramer" and c["model"] in ("hes1", "seirah"):
        nb = c["inits"].shape[1]
        c.update(jjac=jac_lanes(c["jflat"], nb, c["q"]), per_lane=False)
    return c


def jax_lanes(c, call):
    """``call(thetas, inits)`` of the JAX package over the case's lanes: in
    one call, or where its batch takes one lane a call (``per_lane``) one
    lane at a time, stacked on the last axis."""
    if not c["per_lane"]:
        return np.asarray(call(jnp.asarray(c["thetas"]),
                               jnp.asarray(c["inits"])))
    return np.stack([np.asarray(call(jnp.asarray(c["thetas"][b:b + 1]),
                                     jnp.asarray(c["inits"][b:b + 1])))
                     for b in range(N_LANE)], axis=-1)[..., 0, :]


def port_args(c):
    """The port's leading arguments of a batched entry for case ``c``, and
    its keywords (observations included), on the CPU."""
    tcfg = c["tcfg"]
    args = (_t(c["thetas"]), tcfg["ode_weight"], _t(c["inits"]), 0.0,
            c["t_max"], N_STEPS, tcfg["prior_pars"])
    kw = dict(model=c["model"], interrogation=c["mode"], device="cpu")
    return args, kw, {k: _t(v) for k, v in c["obs"].items()}


def ulp_up(a):
    """``a`` (float32) with every nonzero entry moved one ulp up."""
    a = np.asarray(a, np.float32)
    return np.where(a != 0, np.nextafter(a, np.float32(np.inf)), a)


def ulp_case(c):
    """Case ``c`` with its operands moved one float32 ulp (ulp_up): each
    lane's theta and initial state and the prior variance.  The port's
    outputs move by how far float32 resolves them (tests/test_torch_sim.py's
    rule, which moves theta; under rodeo no covariance depends on theta)."""
    tcfg = dict(c["tcfg"])
    weight, var = tcfg["prior_pars"]
    tcfg["prior_pars"] = (weight, _t(ulp_up(var)))
    return dict(c, thetas=ulp_up(c["thetas"]), inits=ulp_up(c["inits"]),
                tcfg=tcfg)


def jax_common(c):
    """The JAX package's keywords shared by its fused entries for case
    ``c``."""
    jcfg = c["jcfg"]
    return dict(ode_weight=jcfg["ode_weight"], t_min=0.0, t_max=c["t_max"],
                n_steps=N_STEPS, prior_pars=jcfg["prior_pars"],
                ode_flat=c["jflat"], jac_flat=c["jjac"])


def scaled_err(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    return np.abs(port - ref).max() / np.abs(ref).max()


# --- the gradient path's twins (tests/test_torch_coverage_grad*.py) --------


def tan_err(port, ref):
    """max|port - ref| / max|ref|; the absolute error where ref is all
    zero (a tangent along a parameter the output does not depend on): the
    tangent tests' scaled error."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(port - ref).max()
    return err / scale if scale > 0 else err


def slice_errs(port, ref, k, axis):
    """Scaled error of each of the n_aug slices of k entries along axis:
    the values, then each tangent direction."""
    port, ref = np.asarray(port), np.asarray(ref)
    n_aug = ref.shape[axis] // k
    return [tan_err(np.take(port, range(a * k, (a + 1) * k), axis),
                        np.take(ref, range(a * k, (a + 1) * k), axis))
            for a in range(n_aug)]


def vmem(shape):
    return pl.BlockSpec(shape, lambda i: tuple([0] * len(shape)),
                        memory_space=pltpu.VMEM)


def tan_chain(q, n_tan, n_steps, nb, B, seed):
    """A seeded augmented backward chain (values and n_tan nonzero
    tangents), observation grid and seeds, float32 numpy."""
    rng = np.random.default_rng(seed)
    pairs, _ = fk._tri_idx(q)
    A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
        0.1 * rng.standard_normal((n_steps, q * q, nb, B))
    M = 0.3 * rng.standard_normal((n_steps, nb, B, q, q))
    Cf = M @ np.swapaxes(M, -1, -2)
    C = np.stack([Cf[..., i, j] for i, j in pairs], axis=1)
    Mp = rng.standard_normal((nb, B, q, q))
    Pf = Mp @ np.swapaxes(Mp, -1, -2)
    p_seed = np.stack([Pf[..., i, j] for i, j in pairs])

    def aug(v, axis):
        tans = [0.1 * rng.standard_normal(v.shape) for _ in range(n_tan)]
        return np.concatenate([v] + tans, axis=axis)

    mask = (rng.random(n_steps) < 0.3).astype(np.float64)
    d = rng.standard_normal((n_steps, q, nb)) * mask[:, None, None]
    y = rng.standard_normal((n_steps, nb)) * mask[:, None]
    om = np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)), 1.0)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(A=f32(aug(A, 1)),
                b=f32(aug(rng.standard_normal((n_steps, q, nb, B)), 1)),
                C=f32(aug(C, 1)), d=f32(d), y=f32(y), om=f32(om),
                mask=f32(mask),
                m_seed=f32(aug(rng.standard_normal((q, nb, B)), 0)),
                p_seed=f32(aug(p_seed, 0)),
                ld0=f32(rng.standard_normal((1 + n_tan, B))))


# --- the solve's sensitivities and basic's gradient
# (tests/test_torch_coverage_grad_solve*.py) ------------------------------


def b_loglik_jax(obs_data, ode_data, **params):
    """The basic likelihood's observation log-density of the gradient
    cases, as the JAX package's obs_loglik (tests/test_torch_grad.py's)."""
    return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def b_loglik_torch(obs_data, ode_data, **params):
    """b_loglik_jax for the port."""
    return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def jax_basic(c, mean_rows, dmean):
    """The JAX package's basic_fused_batch_grad after its solve
    (pallas_kalman.py:2166-2177) on ``(mean_rows, dmean)``: the
    lane-mapped obs_loglik at the observed steps and its jax.jvp along
    each parameter's sensitivity."""
    sim_times = jnp.linspace(0.0, c["t_max"], N_STEPS + 1)
    obs_ind = jnp.searchsorted(sim_times, c["obs"]["obs_times"])
    obs_data = jnp.asarray(c["obs"]["obs_data"], mean_rows.dtype)

    def lls_of(rows):
        return jax.vmap(lambda od: b_loglik_jax(obs_data, od),
                        in_axes=-1)(rows[obs_ind])

    grads = [jax.jvp(lls_of, (mean_rows,), (dmean[k],))[1]
             for k in range(dmean.shape[0])]
    return np.asarray(lls_of(mean_rows)), np.asarray(jnp.stack(grads, -1))


def jax_solve_fused(c):
    """The JAX package's solve_mv_fused_batch_grad over the case's lanes,
    and its basic stage on it: ``(mean, dmean, loglik, grad)``."""
    jcfg = c["jcfg"]
    mean, dmean = jax.jit(lambda ts, x0: pk.solve_mv_fused_batch_grad(
        thetas=ts, ode_weight=jcfg["ode_weight"], ode_inits=x0, t_min=0.0,
        t_max=c["t_max"], n_steps=N_STEPS, prior_pars=jcfg["prior_pars"],
        ode_flat=c["jflat"], jac_flat=c["jjac"], interpret=True))(
        jnp.asarray(c["thetas"]), jnp.asarray(c["inits"]))
    return (np.asarray(mean), np.asarray(dmean)) + jax_basic(c, mean, dmean)


def jax_solve_plain_fitz(c):
    """The JAX package's float64 plain reference of FitzHugh-Nagumo case
    ``c``: ops.precond.solve_mv's posterior mean at each lane and its
    jax.jvp along each parameter, in the fused layout, and the basic stage
    on them: ``(mean, dmean, loglik, grad)``."""
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
    jcfg = c["jcfg"]
    how = getattr(jint, f"interrogate_{c['mode']}")

    def mean_of(th, x0):
        return jprecond.solve_mv(
            None, jfitz.fitzhugh_fun, f64(jcfg["ode_weight"]), x0, 0.0,
            c["t_max"], N_STEPS, how,
            tuple(f64(p) for p in jcfg["prior_pars"]), theta=th)[0]

    means_of = jax.jit(jax.vmap(mean_of, out_axes=-1))
    # each parameter's sensitivity at every lane, (3, ..., B)
    dmeans_of = jax.jit(jax.vmap(lambda th, x0: jax.vmap(
        lambda e: jax.jvp(lambda t: mean_of(t, x0), (th,), (e,))[1])(
            jnp.eye(3)), out_axes=-1))
    ths, x0s = f64(c["thetas"]), f64(c["inits"])
    mean, dmean = means_of(ths, x0s), dmeans_of(ths, x0s)
    return (np.asarray(mean), np.asarray(dmean)) + jax_basic(c, mean, dmean)


@functools.lru_cache(maxsize=None)
def jax_solve_of(name):
    """The JAX package's jax_solve_fused of gradient case ``name`` and, on
    FitzHugh-Nagumo, its jax_solve_plain_fitz (else None), computed once a
    process: check_solve_case and jax_solve_misses share them."""
    c = jax_grad_case(name)
    plain = jax_solve_plain_fitz(c) if c["model"] == "fitzhugh" else None
    return jax_solve_fused(c), plain


def port_solve(c):
    """The port's solve_mv_fused_batch_grad and basic_fused_batch_grad of
    case ``c`` on the CPU (no launch; the means bitwise
    solve_mv_fused_batch's): ``(mean, dmean, loglik, grad)``."""
    args, kw, obs = port_args(c)
    before = dict(fk.LAUNCHES)
    mean, dmean = fk.solve_mv_fused_batch_grad(*args, **kw)
    ll, grad, mean_b = fk.basic_fused_batch_grad(
        *args, obs_data=obs["obs_data"], obs_times=obs["obs_times"],
        obs_loglik=b_loglik_torch, **kw)
    assert fk.LAUNCHES == before            # the CPU takes the twins
    torch.testing.assert_close(mean, fk.solve_mv_fused_batch(*args, **kw)[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(mean_b, mean, rtol=0, atol=0)
    return mean.numpy(), dmean.numpy(), ll.numpy(), grad.numpy()


def held(port, moved, ref, plain, tol):
    """Whether ``port`` holds to the JAX package's fused ``ref`` within
    ``tol`` (tan_err) where ``ref`` lies within ``tol`` / 2 of its float64
    plain reference ``plain`` (None: not computed); else to ``plain``
    within the larger of ``tol`` and 3 x the port's own move under a
    one-ulp move of its operands (``moved``: the port's output at
    ulp_case), which exceeds ``tol`` only where float32 does not resolve
    the output; with the distances."""
    miss = None if plain is None else tan_err(ref, plain)
    if miss is None or miss <= tol / 2:
        err = tan_err(port, ref)
        return err <= tol, (err, miss)
    err, move = tan_err(port, plain), tan_err(moved, port)
    return err <= max(tol, 3 * move), (err, miss, move)


def check_solve_case(name):
    """solve_mv_fused_batch_grad's means and sensitivities, and
    basic_fused_batch_grad's values and gradient, against the JAX
    package's fused path, per derivative, per parameter and derivative,
    and per parameter.  On FitzHugh-Nagumo at q = 4 and 5 the JAX
    package's float64 plain reference is computed too: where its fused
    float32 output lies further than half the tolerance from it (the
    derivatives past the third, padding, in both packages' float32 solves;
    the sensitivities under kramer, JAX_FUSED_MISSES), the port is held to
    that reference instead, within the tolerance or, where float32 does
    not resolve the output, 3 x the port's own one-ulp move (held).  Row
    0, the initial state, has no sensitivity."""
    c = jax_grad_case(name)
    q = c["q"]
    mean, dmean, ll, grad = port = port_solve(c)
    assert np.isfinite(dmean).all() and np.isfinite(grad).all()
    assert (dmean[:, 0] == 0).all()
    ref, plain = jax_solve_of(name)
    moved = (None,) * 4 if plain is None else port_solve(ulp_case(c))
    plain = plain or (None,) * 4
    assert mean.shape == ref[0].shape and dmean.shape == ref[1].shape
    pick = lambda a, *idx: None if a is None else a[idx]  # noqa: E731

    def hold(i, idx, rtol):
        ok, errs = held(port[i][idx], pick(moved[i], *idx), ref[i][idx],
                        pick(plain[i], *idx), rtol)
        assert ok, (i, idx, errs)

    for d in range(q):
        hold(0, (Ellipsis, d, slice(None)), tol(name))
    g_rtol = tol(name, GRAD_RTOL, GRAD_Q5_TOL)
    for k in range(dmean.shape[0]):
        for d in range(q):
            hold(1, (k, Ellipsis, d, slice(None)), g_rtol)
    hold(2, (Ellipsis,), tol(name, LOGLIK_RTOL))
    for k in range(grad.shape[1]):
        hold(3, (slice(None), k), g_rtol)


# --- fenrir's gradient (tests/test_torch_coverage_grad*.py) ------------------


def jax_fenrir_fused(c):
    """The JAX package's fenrir_fused_batch_grad over the case's lanes:
    ``(loglik (B,), grad (B, n_theta))`` as numpy."""
    fn = jax.jit(lambda ts, x0: pf.fenrir_fused_batch_grad(
        thetas=ts, ode_inits=x0, **c["obs"], **jax_common(c)))
    ll, g = fn(jnp.asarray(c["thetas"]), jnp.asarray(c["inits"]))
    return np.asarray(ll), np.asarray(g)


def jax_fenrir_plain_fitz(c):
    """The JAX package's plain float64 reference of FitzHugh-Nagumo case
    ``c``: ``ops.precond.fenrir`` and its jax.value_and_grad in theta at
    each lane, ``(value (B,), grad (B, 3))``."""
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
    jcfg = c["jcfg"]
    how = getattr(jint, f"interrogate_{c['mode']}")
    obs = {k: f64(v) for k, v in c["obs"].items()}

    def value(th, x0):
        return jprecond.fenrir(
            None, jfitz.fitzhugh_fun, f64(jcfg["ode_weight"]), x0, 0.0,
            c["t_max"], N_STEPS, how,
            tuple(f64(p) for p in jcfg["prior_pars"]), **obs, theta=th)

    vg = jax.jit(jax.value_and_grad(value))
    out = [vg(f64(c["thetas"][b]), f64(c["inits"][b]))
           for b in range(N_LANE)]
    return (np.array([float(v) for v, _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


@functools.lru_cache(maxsize=None)
def jax_fenrir_of(name):
    """The JAX package's jax_fenrir_fused of gradient case ``name`` and, at
    JAX_FUSED_MISSES, its jax_fenrir_plain_fitz (else None), computed once a
    process: check_fenrir_case and jax_fenrir_misses share them."""
    c = jax_grad_case(name)
    plain = jax_fenrir_plain_fitz(c) if name in JAX_FUSED_MISSES else None
    return jax_fenrir_fused(c), plain


def check_fenrir_case(name):
    """fenrir_fused_batch_grad's values and gradient against the JAX
    package's fused entry, the values within LOGLIK_RTOL relative and
    each parameter's gradient within GRAD_RTOL of its largest entry (at
    q = 5 Q5_TOL and GRAD_Q5_TOL); at JAX_FUSED_MISSES, where the fused
    entry's gradient misses the JAX package's float64 plain reference
    (jax_fenrir_misses), against that reference within the same
    tolerances.  On the CPU no kernel launches."""
    c = jax_grad_case(name)
    args, kw, obs = port_args(c)
    before = dict(fk.LAUNCHES, **ff.LAUNCHES)
    ll_t, g_t = ff.fenrir_fused_batch_grad(*args, **obs, **kw)
    assert dict(fk.LAUNCHES, **ff.LAUNCHES) == before
    n_theta = c["thetas"].shape[1]
    assert ll_t.shape == (N_LANE,) and g_t.shape == (N_LANE, n_theta)
    assert torch.isfinite(ll_t).all() and torch.isfinite(g_t).all()
    fused, plain = jax_fenrir_of(name)
    ll_j, g_j = plain or fused
    err = np.abs(ll_t.numpy() - ll_j) / np.abs(ll_j)
    assert err.max() <= tol(name, LOGLIK_RTOL), err
    g_rtol = tol(name, GRAD_RTOL, GRAD_Q5_TOL)
    errs = [tan_err(g_t[:, k], g_j[:, k]) for k in range(n_theta)]
    assert max(errs) <= g_rtol, errs


def jax_fenrir_misses(name):
    """How far the JAX package's fused gradient lies from its own float64
    plain reference at JAX_FUSED_MISSES case ``name``: the tan_err of each
    parameter's gradient (jax_fenrir_of)."""
    (_, g_f), (_, g_p) = jax_fenrir_of(name)
    return [tan_err(g_f[:, k], g_p[:, k]) for k in range(g_p.shape[1])]


def jax_solve_misses(name):
    """How far the JAX package's fused sensitivities lie from its own
    float64 plain reference at FitzHugh-Nagumo case ``name``: the tan_err
    of each parameter's sensitivity of each derivative (jax_solve_of)."""
    (_, d_f, _, _), (_, d_p, _, _) = jax_solve_of(name)
    return [tan_err(d_f[k, ..., d, :], d_p[k, ..., d, :])
            for k in range(d_p.shape[0]) for d in range(d_p.shape[-2])]


# --- DALTON's gradient (tests/test_torch_coverage_dalton*.py) --------------

# The gradient cases where float32 does not resolve DALTON in either
# package, FitzHugh-Nagumo at q = 4 and 5: the difference of two float32
# sums of ~6e7 (q = 4) or ~5e11 (q = 5), which rounds to whole numbers (to
# 0 at q = 5), where DALTON is ~10 and its gradient ~5-60.
DALTON_UNRESOLVED = ("fitzhugh_q4_kramer", "fitzhugh_q4_rodeo",
                     "fitzhugh_q5_kramer", "fitzhugh_q5_rodeo")
# Of those, the cases where the JAX package's plain float64 reference
# (ops.precond.dalton, its joint forecast density eigen-masked at steps
# with data) and the fused filters' sequential updates, float64 in both
# packages, part by more than the gradient's tolerance (measured up to
# 1.6e-3 of the value and 3-13 % of a parameter's largest gradient entry;
# under rodeo 4e-7): under kramer
DALTON_PLAIN_PARTS = ("fitzhugh_q4_kramer", "fitzhugh_q5_kramer")


def jax_dalton_fused(c):
    """The JAX package's dalton_fused_batch_grad over the case's lanes:
    ``(loglik (B,), grad (B, n_theta))`` as numpy."""
    fn = jax.jit(lambda ts, x0: pd.dalton_fused_batch_grad(
        thetas=ts, ode_inits=x0, **c["obs"], **jax_common(c)))
    ll, g = fn(jnp.asarray(c["thetas"]), jnp.asarray(c["inits"]))
    return np.asarray(ll), np.asarray(g)


def jax_dalton_plain(c):
    """The JAX package's plain float64 reference of case ``c`` (FitzHugh-
    Nagumo or Chkrebtii's ODE): ``ops.precond.dalton`` and its
    jax.value_and_grad in theta at each lane, ``(value (B,), grad (B,
    n_theta))``; Chkrebtii's ODE has no parameter, its gradient zeros."""
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
    jcfg = c["jcfg"]
    how = getattr(jint, f"interrogate_{c['mode']}")
    obs = {k: f64(v) for k, v in c["obs"].items()}
    chk = c["model"] == "chkrebtii"
    fun = jchk.chkrebtii_fun if chk else jfitz.fitzhugh_fun

    def value(th, x0):
        return jprecond.dalton(
            None, fun, f64(jcfg["ode_weight"]), x0, 0.0, c["t_max"],
            N_STEPS, how, tuple(f64(p) for p in jcfg["prior_pars"]), **obs,
            **({} if chk else {"theta": th}))

    vg = jax.jit(jax.value_and_grad(value))
    out = [vg(f64(c["thetas"][b]), f64(c["inits"][b]))
           for b in range(N_LANE)]
    grads = np.stack([np.asarray(g) for _, g in out])
    return (np.array([float(v) for v, _ in out]),
            np.zeros_like(grads) if chk else grads)


@functools.lru_cache(maxsize=None)
def jax_dalton_of(name):
    """The JAX package's jax_dalton_fused of gradient case ``name`` and, at
    DALTON_UNRESOLVED, its jax_dalton_plain (else None), computed once a
    process: the value and gradient tests share them."""
    c = jax_grad_case(name)
    plain = jax_dalton_plain(c) if name in DALTON_UNRESOLVED else None
    return jax_dalton_fused(c), plain


def port_dalton(c):
    """The port's dalton_fused_batch_grad of case ``c`` on the CPU (no
    launch; the values bitwise dalton_fused_batch's): ``(loglik, grad)``
    as numpy."""
    args, kw, obs = port_args(c)
    before = dict(fd.LAUNCHES)
    ll, g = fd.dalton_fused_batch_grad(*args, **obs, **kw)
    value = fd.dalton_fused_batch(*args, **obs, **kw)
    assert fd.LAUNCHES == before            # the CPU takes the twins
    np.testing.assert_array_equal(ll.numpy(), value.numpy())
    return ll.numpy(), g.numpy()


def port_dalton_f64(c, moved=False):
    """The port's DALTON of case ``c`` by the twins in float64 on the
    entry's float32 operands (tools/torch_coverage_reference.py's
    dalton_float64_twins; with ``moved`` theta, x0 and the prior variance
    then moved one float64 ulp up, how far the twins' float64 arithmetic
    resolves DALTON): ``(loglik, grad)`` as numpy, the gradient zeros on
    Chkrebtii's ODE."""
    ops, grid, ld0 = dalton_operands(c, moved)
    chk = c["model"] == "chkrebtii"
    ll, g = cov_ref.dalton_float64_twins(c["model"], c["mode"], N_STEPS,
                                         ops, grid, ld0, tangent=not chk)
    return ll.numpy(), (np.zeros(c["thetas"].shape) if chk else g.numpy())


def dalton_operands(c, moved=False):
    """The float32 operands of DALTON's two launches for case ``c``
    (``fused_dalton._dalton_prepare``: ``(ops, grid, ld0)``); with
    ``moved`` theta, x0 and the prior variance widened to float64 and
    moved one float64 ulp up."""
    args, _, obs = port_args(c)
    ops, grid, ld0 = fd._dalton_prepare(*args, *obs.values())
    if moved:
        up = lambda a: np.where(a != 0, np.nextafter(a, np.inf), a)  # noqa
        ops = {k: (torch.from_numpy(up(v.double().numpy()))
                   if k in ("theta_lanes", "x0_lanes", "prior_var") else v)
               for k, v in ops.items()}
    return ops, grid, ld0


def jax_dalton_fused64(c, moved=False):
    """The JAX package's fused DALTON formulation in float64: its tangent
    kernel ``_dalton_filter_kernel_tan`` (a ``pallas_call`` in interpret
    mode, every operand and scratch float64) with and without data on the
    port's operands of case ``c`` (``fused_dalton._dalton_prepare``, the
    float32 operands of both packages' fused entries, widened; with
    ``moved`` theta, x0 and the prior variance then moved one float64 ulp
    up): ``(loglik (B,), grad (B, n_theta))`` as numpy, the witness of the
    fused filters where float32 does not resolve them."""
    ops, grid, ld0 = dalton_operands(c, moved)
    f64 = lambda t: np.asarray(t.numpy(), np.float64)  # noqa: E731
    # the kernel initialises its scratch with float32 zeros: traced here
    # with jax.numpy's float32 read as float64 (its module left as it is)
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.float32 = jnp.float64
    q, nb, B = ops["x0_lanes"].shape
    n_tri = q * (q + 1) // 2
    n_tan = ops["theta_lanes"].shape[0]
    n_aug = 1 + n_tan
    pairs, _ = fk._tri_idx(q)
    spec = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: tuple([0] * len(shape)), memory_space=pltpu.VMEM)

    def run(with_obs, seed):
        kern = functools.partial(
            pd._dalton_filter_kernel_tan, c["jflat"], c["jjac"], with_obs,
            n_tan, N_STEPS, q, nb, n_tri, B, ops["q_const"])
        return np.asarray(pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((n_aug, B), jnp.float64),
            grid=(1,),
            in_specs=[spec((nb, n_tri)), spec((nb, q)), spec((q, nb, B)),
                      spec((n_tan, B)), spec((N_STEPS, 1)), spec((1, q)),
                      spec((N_STEPS, q, nb, 1)), spec((N_STEPS, 1, nb, 1)),
                      spec((N_STEPS, 1, nb, 1)), spec((N_STEPS, 1)),
                      spec((n_aug, B))],
            out_specs=spec((n_aug, B)),
            scratch_shapes=[pltpu.VMEM((n_aug * q, nb, B), jnp.float64),
                            pltpu.VMEM((n_aug * n_tri, nb, B), jnp.float64),
                            pltpu.VMEM((n_aug, B), jnp.float64)],
            interpret=True,
        )(f64(fk._pack_tri(ops["prior_var"], pairs)), f64(ops["ode_weight"]),
          f64(ops["x0_lanes"]), f64(ops["theta_lanes"]),
          f64(ops["tgrid"])[:, None], f64(ops["t_vec"])[None],
          f64(grid["d"])[..., None], f64(grid["y"])[:, None, :, None],
          f64(grid["om"])[:, None, :, None], f64(grid["mask"])[:, None],
          seed))

    seed = np.zeros((n_aug, B))
    joint = seed.copy()
    joint[0] = f64(ld0)
    with mock.patch.object(pd, "jnp", wide):
        diff = run(True, joint) - run(False, seed)
    return diff[0], diff[1:].T


@functools.lru_cache(maxsize=None)
def jax_dalton_fused64_of(name, moved=False):
    """jax_dalton_fused64 of gradient case ``name``, computed once a
    process: check_dalton_case and jax_dalton_plain_parts share it."""
    return jax_dalton_fused64(jax_grad_case(name), moved)


def dalton_sums_spacing(c):
    """The float32 spacing of the port's joint log-density sum and of each
    of its tangents (K11c's twin with data, ``(n_aug, B)``) on case ``c``:
    how finely float32 resolves DALTON, the difference of that sum and the
    sum without data, and its gradient, lane by lane."""
    ops, grid, ld0 = dalton_operands(c)
    n_theta = ops["theta_lanes"].shape[0]
    seed = torch.cat([ld0[None], ld0.new_zeros((n_theta, ld0.shape[0]))])
    joint = fd.dalton_filter_batch_tan(c["model"], N_STEPS, **ops, **grid,
                                       ld0=seed, mode=c["mode"])
    return np.spacing(np.abs(joint.numpy()))


def dalton_f32_held(port, moved, plain, spacing, tol):
    """Whether the port's float32 output ``port`` (a value or one
    parameter's gradient over the lanes) lies within the larger of ``tol``
    of the float64 ``plain``'s largest entry, 3 x the port's own move
    under a one-ulp move of its operands (``moved``: ulp_case's output) and
    3 x the float32 spacing of the sums it is the difference of
    (``spacing``, dalton_sums_spacing's row), where float32 does not
    resolve DALTON (DALTON_UNRESOLVED: there the output rounds to whole
    numbers, or to 0, and a one-ulp move need not move it); with the
    distances."""
    port, moved, plain, spacing = (np.asarray(a, np.float64) for a in (
        port, moved, plain, spacing))
    err = np.abs(port - plain).max()
    move = np.abs(moved - port).max()
    bound = max(tol * np.abs(plain).max(), 3 * move, 3 * spacing.max())
    return err <= bound, (err, move, spacing.max(), bound)


def check_dalton_case(name):
    """dalton_fused_batch_grad on the CPU, its values bitwise
    dalton_fused_batch's and its gradient exactly zero on Chkrebtii's ODE
    (no parameter), against the JAX package's fused entry: the values
    within DALTON_RTOL relative and each parameter's gradient within
    GRAD_RTOL of its largest entry (DALTON_Q5_TOL and GRAD_Q5_TOL at
    q = 5).  Where float32 does not resolve DALTON (DALTON_UNRESOLVED),
    the float32 outputs within dalton_f32_held's bound of the JAX
    package's float64 plain reference, and the twins in float64 (on the
    same float32 operands, port_dalton_f64) within DALTON_RTOL and
    GRAD_RTOL of it, but at DALTON_PLAIN_PARTS, where the two
    formulations part, within those tolerances or 3 x the float64 twins'
    own move under a one-ulp float64 move of their operands (the larger)
    of the JAX package's fused formulation in float64
    (jax_dalton_fused64; the moves of both, a one-ulp float64 move of
    their operands, summed: at FitzHugh-Nagumo q = 5 under kramer float64
    resolves the gradient to ~0.3-0.7 %, its sums being ~1e13)."""
    c = jax_grad_case(name)
    ll, g = port_dalton(c)
    n_theta = c["thetas"].shape[1]
    assert ll.shape == (N_LANE,) and g.shape == (N_LANE, n_theta)
    assert np.isfinite(ll).all() and np.isfinite(g).all()
    if c["model"] == "chkrebtii":
        assert (g == 0).all()
    (ll_j, g_j), plain = jax_dalton_of(name)
    v_tol = tol(name, DALTON_RTOL, DALTON_Q5_TOL)
    g_tol = tol(name, GRAD_RTOL, GRAD_Q5_TOL)
    if name not in DALTON_UNRESOLVED:
        err = np.abs(ll - ll_j) / np.abs(ll_j)
        assert err.max() <= v_tol, err
        errs = [tan_err(g[:, k], g_j[:, k]) for k in range(n_theta)]
        assert max(errs) <= g_tol, errs
        return
    ll_m, g_m = port_dalton(ulp_case(c))
    spacing = dalton_sums_spacing(c)
    ok, d = dalton_f32_held(ll, ll_m, plain[0], spacing[0], v_tol)
    assert ok, ("value", d)
    for k in range(n_theta):
        ok, d = dalton_f32_held(g[:, k], g_m[:, k], plain[1][:, k],
                                spacing[1 + k], g_tol)
        assert ok, (k, d)
    ll64, g64 = port_dalton_f64(c)
    if name not in DALTON_PLAIN_PARTS:
        err = np.abs(ll64 - plain[0]) / np.abs(plain[0])
        assert err.max() <= v_tol, err
        errs = [tan_err(g64[:, k], plain[1][:, k]) for k in range(n_theta)]
        assert max(errs) <= g_tol, errs
        return
    ll_w, g_w = jax_dalton_fused64_of(name)
    ll_wm, g_wm = jax_dalton_fused64_of(name, moved=True)
    ll_mv, g_mv = port_dalton_f64(c, moved=True)
    err = np.abs(ll64 - ll_w) / np.abs(ll_w)
    move = (np.abs(ll_mv - ll64) + np.abs(ll_wm - ll_w)) / np.abs(ll_w)
    assert err.max() <= max(v_tol, 3 * move.max()), (err, move)
    for k in range(n_theta):
        err = tan_err(g64[:, k], g_w[:, k])
        move = tan_err(g_mv[:, k], g64[:, k]) + tan_err(g_wm[:, k],
                                                        g_w[:, k])
        assert err <= max(g_tol, 3 * move), (k, err, move)


def jax_dalton_plain_parts(name):
    """How far the port's float64 twins (port_dalton_f64) lie from the JAX
    package's float64 plain reference at DALTON_PLAIN_PARTS case ``name``,
    and the JAX package's fused formulation in float64 (jax_dalton_fused64)
    from it: ``(value's relative error, each parameter's gradient tan_err)``
    for each."""
    c = jax_grad_case(name)
    _, (p_ll, p_g) = jax_dalton_of(name)
    out = []
    for ll, g in (port_dalton_f64(c), jax_dalton_fused64_of(name)):
        out.append((float(np.max(np.abs(ll - p_ll) / np.abs(p_ll))),
                    [tan_err(g[:, k], p_g[:, k]) for k in range(g.shape[1])]))
    return out


# --- non-Gaussian DALTON's gradient (tests/test_torch_coverage_daltonng*.py)
# ------------------------------------------------------------------------------

# tests/test_torch_daltonng.py's tolerances of the fused paths against each
# other: the values relative, each parameter's gradient of its largest
# entry (tan_err)
FUSED_RTOL = 1e-5
FUSED_GRAD_TOL = 1e-4


def jax_gauss_comp_flat(y_cols, x_col, j, th, iobs):
    """The JAX package's per-component observation log-likelihood of the
    cases' Gaussian data of variance OBS_VAR (its ``obs_comp_flat``)."""
    return -0.5 * (y_cols[0] - x_col) ** 2 / OBS_VAR


def jax_daltonng_fused(c):
    """The JAX package's daltonng_fused_batch_grad over the case's lanes
    (its Pallas kernels in interpret mode), the data's derivative 0
    observed: ``(loglik (B,), grad (B, n_theta))`` as numpy."""
    from rodeo_tpu.ops import pallas_daltonng as pdn
    jcfg = c["jcfg"]
    fn = jax.jit(lambda ts, x0: pdn.daltonng_fused_batch_grad(
        thetas=ts, ode_weight=jcfg["ode_weight"], ode_inits=x0, t_min=0.0,
        t_max=c["t_max"], n_steps=N_STEPS, prior_pars=jcfg["prior_pars"],
        obs_data=jnp.asarray(c["obs"]["obs_data"]),
        obs_times=jnp.asarray(c["obs"]["obs_times"], jnp.float32),
        obs_comp_flat=jax_gauss_comp_flat, obs_dims=(0,),
        ode_flat=c["jflat"], jac_flat=c["jjac"], interpret=True))
    ll, g = fn(jnp.asarray(c["thetas"]), jnp.asarray(c["inits"]))
    return np.asarray(ll), np.asarray(g)


def jax_daltonng_plain(c):
    """The JAX package's plain float64 reference of case ``c``:
    ``ops.precond.daltonng`` and its jax.value_and_grad in theta at each
    lane, ``(value (B,), grad (B, n_theta))``; Chkrebtii's ODE has no
    parameter, its gradient zeros."""
    f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
    jcfg = c["jcfg"]
    how = getattr(jint, f"interrogate_{c['mode']}")
    chk = c["model"] == "chkrebtii"
    fun = getattr(_MODULES[c["model"]][0], f"{c['model']}_fun")

    def loglik(o, s, i, **params):
        return jnp.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2 / OBS_VAR)

    def value(th, x0):
        return jprecond.daltonng(
            None, fun, f64(jcfg["ode_weight"]), x0, 0.0, c["t_max"],
            N_STEPS, how, tuple(f64(p) for p in jcfg["prior_pars"]),
            f64(c["obs"]["obs_data"]), f64(c["obs"]["obs_times"]), loglik,
            **({} if chk else {"theta": th}))

    vg = jax.jit(jax.value_and_grad(value))
    out = [vg(f64(c["thetas"][b]), f64(c["inits"][b]))
           for b in range(N_LANE)]
    grads = np.stack([np.asarray(g) for _, g in out])
    return (np.array([float(v) for v, _ in out]),
            np.zeros_like(grads) if chk else grads)


def port_daltonng_args(c):
    """The port's daltonng_fused_batch(_grad) arguments of case ``c`` on the
    CPU (tools/torch_coverage_reference.py's daltonng_args)."""
    from rodeo_tpu_torch.models import obs as obs_models
    args, kw, obs = port_args(c)
    return args + (obs["obs_data"], obs["obs_times"],
                   obs_models.gauss(OBS_VAR), (0,), kw["model"])


def port_daltonng(c):
    """The port's daltonng_fused_batch_grad of case ``c`` on the CPU (no
    launch; the values bitwise daltonng_fused_batch's): ``(loglik, grad)``
    as numpy."""
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    args = port_daltonng_args(c)
    before = dict(fdn.LAUNCHES, **fk.LAUNCHES)
    ll, g = fdn.daltonng_fused_batch_grad(*args, interrogation=c["mode"],
                                          device="cpu")
    value = fdn.daltonng_fused_batch(*args, interrogation=c["mode"],
                                     device="cpu")
    assert dict(fdn.LAUNCHES, **fk.LAUNCHES) == before
    np.testing.assert_array_equal(ll.numpy(), value.numpy())
    return ll.numpy(), g.numpy()


def port_daltonng_f64(c):
    """The port's non-Gaussian DALTON of case ``c`` by its entries' code
    with the kernels' twins in float64 on the entries' float32 operands
    (tools/torch_coverage_reference.py's daltonng_float64_twins):
    ``(loglik, grad)`` as numpy, the gradient zeros on Chkrebtii's ODE."""
    chk = c["model"] == "chkrebtii"
    ll, g = cov_ref.daltonng_float64_twins(port_daltonng_args(c), c["mode"],
                                           tangent=not chk)
    return ll.numpy(), (np.zeros(c["thetas"].shape) if chk else g.numpy())


# The gradient cases where float32 does not resolve non-Gaussian DALTON, in
# either package: Chkrebtii's ODE at q = 5 and FitzHugh-Nagumo at q = 4 and
# 5, whose float32 values lie 44-1.6e8 times their size from the float64
# plain reference, the port's own one-ulp move 0.03-1.5 of it
# (tests/test_torch_coverage_daltonng_fitz.py records it).  There the
# port's entries run in float64 on the same float32 operands
# (port_daltonng_f64) and the JAX package's fused call is not made.
DALTONNG_UNRESOLVED = ("chkrebtii_q5", "fitzhugh_q4_kramer",
                       "fitzhugh_q4_rodeo", "fitzhugh_q5_kramer",
                       "fitzhugh_q5_rodeo")


@functools.lru_cache(maxsize=None)
def jax_daltonng_of(name):
    """The JAX package's references of gradient case ``name``, computed once
    a process: ``(fused, plain)``, its jax_daltonng_fused (None at
    DALTONNG_UNRESOLVED, where float32 resolves nothing) and its
    jax_daltonng_plain."""
    c = jax_grad_case(name)
    fused = None if name in DALTONNG_UNRESOLVED else jax_daltonng_fused(c)
    return fused, jax_daltonng_plain(c)


# The gradient cases where the two packages' float32 part by more than the
# tolerances and 3 x the port's one-ulp move (Hes1 and SEIRAH under rodeo,
# whose float32 sums lose up to 1e-3 of some parameters' gradients in both
# packages, far beyond a one-ulp move; PERF.md records each reading): there
# daltonng_held also takes the port's distance from the float64 plain
# reference.
DALTONNG_F32_PARTS = ("hes1_rodeo", "seirah_rodeo")


def daltonng_held(port, moved, fused, plain, tol, parts):
    """Whether the port's float32 output ``port`` (the values, or one
    parameter's gradient over the lanes) holds to the JAX package: within
    the larger of ``tol`` and 3 x the port's own move under a one-ulp move
    of its operands (``moved``, ulp_case's output) of the JAX package's
    fused float32 output ``fused``; or, where ``parts`` (a case of
    DALTONNG_F32_PARTS) and the two part by more, no further from the JAX
    package's float64 plain reference ``plain`` than the larger of that
    and 3 x the JAX package's own float32 distance from it; with the
    distances (tan_err)."""
    move = tan_err(moved, port)
    err = tan_err(port, fused)
    if err <= max(tol, 3 * move) or not parts:
        return err <= max(tol, 3 * move), (err, move)
    miss, err_p = tan_err(fused, plain), tan_err(port, plain)
    return err_p <= max(tol, 3 * move, 3 * miss), (err, move, err_p, miss)


def check_daltonng_case(name):
    """daltonng_fused_batch_grad on the CPU (the twins of K11d, K11e and
    K11a), its values bitwise daltonng_fused_batch's and its gradient
    exactly zero on Chkrebtii's ODE (no parameter), against the JAX
    package: where float32 resolves the result, the values and each
    parameter's gradient by daltonng_held with FUSED_RTOL and
    FUSED_GRAD_TOL against its fused entry (Pallas kernels in interpret
    mode), and at DALTONNG_F32_PARTS its float64 plain reference (the two
    packages' float32 lie 3e-5 to 1e-3 apart on Hes1 and SEIRAH,
    Chkrebtii's ODE at q = 4 up to 0.7 %); at DALTONNG_UNRESOLVED the
    port's entries in float64 on the same float32 operands
    (port_daltonng_f64) against the float64 plain reference within
    FUSED_RTOL (values, relative) and FUSED_GRAD_TOL."""
    c = jax_grad_case(name)
    ll, g = port_daltonng(c)
    n_theta = c["thetas"].shape[1]
    assert ll.shape == (N_LANE,) and g.shape == (N_LANE, n_theta)
    assert np.isfinite(ll).all() and np.isfinite(g).all()
    if c["model"] == "chkrebtii":
        assert (g == 0).all()
    fused, plain = jax_daltonng_of(name)
    if fused is not None:
        parts = name in DALTONNG_F32_PARTS
        ll_m, g_m = port_daltonng(ulp_case(c))
        ok, errs = daltonng_held(ll, ll_m, fused[0], plain[0], FUSED_RTOL,
                                 parts)
        assert ok, ("value", errs)
        for k in range(n_theta):
            ok, errs = daltonng_held(g[:, k], g_m[:, k], fused[1][:, k],
                                     plain[1][:, k], FUSED_GRAD_TOL, parts)
            assert ok, (k, errs)
        return
    ll64, g64 = port_daltonng_f64(c)
    err = np.abs(ll64 - plain[0]) / np.abs(plain[0])
    assert err.max() <= FUSED_RTOL, err
    errs = [tan_err(g64[:, k], plain[1][:, k]) for k in range(n_theta)]
    assert max(errs) <= FUSED_GRAD_TOL, errs
