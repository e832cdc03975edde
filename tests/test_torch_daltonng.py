"""
Parity of the port's non-Gaussian DALTON (rodeo_tpu_torch.inference.daltonng,
rodeo_tpu_torch.ops.precond.daltonng and rodeo_tpu_torch.ops.fused_daltonng)
with the JAX package, whose Pallas kernels run here in interpret mode, and
of the closed forms it rests on (sym_eigh_small, the masked eigendecomposition,
the eigen-masked log-density and the Jet2 derivatives of the observation
models).

On the CPU the fused entry points take the plain PyTorch twins of kernels
K9 (filter_nn_batch) and K11d (filter_nn_batch_tan), with K1, K2r, K11a and
K11e's twins.  The grid is 64 steps to t = 0.5 (dt = 2^-7, so that float32
observation times sit on grid points), 5 observations.  Tolerances, each with
the largest deviation measured here:

- the float64 torch-ops against the JAX package's (60 steps to t = 0.6,
  the torch-ops' grid): value 1e-10 relative, gradient 1e-8 of its largest
  entry for the preconditioned op (measured 0 and 6e-13); 1e-7 and 1e-6 for
  the unpreconditioned op, whose coordinates turn the different rounding of
  its LU solves into up to 4.7e-8 and 7.7e-8;
- the twins of K9 and K11d against the Pallas kernels: 1e-5 and 1e-4 of
  each stream's largest entry;
- the fused path against the JAX package's fused path: value 1e-5
  relative (6e-8), gradient 1e-4 relative L2 per lane (1.2e-5); against the
  float64 reference the JAX package's own test's rtol 5e-3 (1.0e-3),
  cosine > 0.99 and norm ratio 0.9-1.1.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.inference import daltonng as j_daltonng
from rodeo_tpu.interrogate import interrogate_kramer as j_kramer
from rodeo_tpu.models import chkrebtii as jchk, hes1 as jhes1
from rodeo_tpu.models import fitzhugh as jfitzhugh, lorenz as jlorenz
from rodeo_tpu.models import seirah as jseirah
from rodeo_tpu.ops import linalg as jlinalg
from rodeo_tpu.ops import pallas_daltonng as jd
from rodeo_tpu.ops import precond as jprecond
from rodeo_tpu.utils import multivariate_normal_logpdf as j_mvn_logpdf

import coverage_value_cases as cv
import rodeo_tpu_torch as rt
from rodeo_tpu_torch.inference import daltonng as t_daltonng
from rodeo_tpu_torch.interrogate import interrogate_kramer as t_kramer
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.models import obs as tobs
from rodeo_tpu_torch.ops import dual
from rodeo_tpu_torch.ops import fused_daltonng as fdn
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import linalg as tlinalg
from rodeo_tpu_torch.ops import precond as tprecond
from rodeo_tpu_torch.utils import multivariate_normal_logpdf as t_mvn_logpdf

N_STEPS, T_MAX, N_OBS = 64, 0.5, 5
# the float64 torch-ops' grid
OP_STEPS, OP_T_MAX = 60, 0.6
VAR = 0.005
B0, B1 = 0.1, 0.05
F64_VALUE_RTOL = 1e-10
F64_GRAD_TOL = 1e-8
UNPRECOND_VALUE_RTOL = 1e-7
UNPRECOND_GRAD_TOL = 1e-6
# both packages' default paths: their subtractive updates amplify the two
# packages' different rounding most (measured 1.04e-6 apart)
UNPRECOND_DEFAULT_GRAD_TOL = 2e-6
STREAM_TOL = 1e-5
TANGENT_TOL = 1e-4
FUSED_RTOL = 1e-5
FUSED_GRAD_TOL = 1e-4
F64_FUSED_RTOL = 5e-3


def _chip_smoke():
    """chip_smoke.py as a module (its imports of torch and the package are
    inside main), for the constants it states."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- the closed forms ------------------------------------------------------------


def _psd_batch(dtype):
    """Seeded symmetric PSD 3 x 3 matrices of rank 3, 2 and 1 over several
    scales, as (n, 3, 3)."""
    rng = np.random.default_rng(0)
    mats = []
    for rank in (3, 2, 1):
        for scale in (1e-3, 1.0, 1e4):
            A = rng.standard_normal((40, 3, rank)) * scale
            mats.append(A @ np.swapaxes(A, -1, -2))
    return np.concatenate(mats).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sym_eigh_small_matches_jax(dtype):
    """The closed-form eigendecomposition against the JAX package's on the
    same matrices: eigenvalues within 1e-6 of the largest, and each
    reconstructs its matrix.  The null pair of a rank-1 matrix is a double
    root of the characteristic cubic, which the trigonometric solution
    resolves to about sqrt(eps) of the largest eigenvalue: in float32 both
    implementations land 1.3e-4 from the exact pair and 9.4e-5 from each
    other, so there the bound is 1e-3."""
    a = _psd_batch(dtype)
    w_j, _ = jlinalg.sym_eigh_small(jnp.asarray(a))
    w_t, v_t = tlinalg.sym_eigh_small(torch.tensor(a))
    wmax = np.abs(np.asarray(w_j)).max(-1, keepdims=True)
    rank1 = np.arange(len(a)) >= 2 * len(a) // 3
    tol = np.where(rank1 & (dtype == np.float32), 1e-3, 1e-6)[:, None]
    assert np.all(np.abs(w_t.numpy() - np.asarray(w_j)) <= tol * wmax)
    rec = (v_t * w_t[..., None, :]) @ v_t.transpose(-1, -2)
    assert np.all(np.abs(rec.numpy() - a).max((-1, -2))
                  <= 1e-3 * wmax[:, 0])


def test_masked_eigh_keeps_what_jax_keeps():
    """The masked eigendecomposition of packed float32 covariances (the
    q = 3 determinant refinement and keep rule) against the JAX package's:
    for ranks 3 and 2 (a smoothing covariance has one structural null
    direction) the same kept directions, and kept eigenvalues within 1e-6
    of the largest.  A rank-1 matrix's null pair is a double root, which
    both implementations resolve only to about sqrt(eps): whether its upper
    member clears the screen is then a matter of float32 rounding (the JAX
    package keeps it in 40 % of these matrices, at ~1e-4 of the largest),
    so there only the largest direction is held to the JAX package's."""
    a = _psd_batch(np.float32)
    pairs, _ = fk._tri_idx(3)
    packed = np.stack([a[:, i, j] for i, j in pairs], -1)      # (n, 6)
    C = packed.reshape(9, 40, 6).transpose(0, 2, 1)[:, :, None, :]
    w_j, _, keep_j = jd._masked_eigh(jnp.asarray(C), 3)
    w_t, _, keep_t = fdn._masked_eigh(torch.tensor(np.ascontiguousarray(C)))
    w_j, keep_j = np.asarray(w_j), np.asarray(keep_j)
    w_t, keep_t = w_t.numpy(), keep_t.numpy()
    wmax = np.abs(w_j).max(-1, keepdims=True)
    full = slice(0, 6)                          # ranks 3 and 2
    np.testing.assert_array_equal(keep_t[full], keep_j[full])
    assert keep_j[full].sum(-1).min() == 2 and keep_j[full].sum(-1).max() == 3
    diff = np.where(keep_j, np.abs(w_t - w_j), 0.0)
    assert np.all(diff[full] <= 1e-6 * wmax[full])
    # rank 1: the largest direction kept by both, its eigenvalue alike
    assert keep_t[6:, ..., 2].all() and keep_j[6:, ..., 2].all()
    assert np.all(diff[6:, ..., 2] <= 1e-6 * wmax[6:, ..., 0])


def _mvn_cases():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 3, 3))
    generic = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)
    B = rng.standard_normal((4, 3, 2))
    rank2 = B @ np.swapaxes(B, -1, -2)
    repeated = np.broadcast_to(np.diag([2.0, 2.0, 0.5]), (4, 3, 3)).copy()
    C = rng.standard_normal((4, 2, 2))
    two = C @ np.swapaxes(C, -1, -2)
    two[0] = np.diag([1.0, 1e-10])
    return {"generic": generic, "rank2": rank2, "repeated": repeated,
            "2x2": two}


@pytest.mark.parametrize("case", ["generic", "rank2", "repeated", "2x2"])
def test_mvn_logpdf_matches_jax(case):
    """multivariate_normal_logpdf's value, gradient (torch.autograd) and jvp
    (torch.func.jvp) against the JAX package's, float64, 1e-10; the
    repeated-eigenvalue case, where the derivative of eigh is NaN, stays
    finite."""
    cov = _mvn_cases()[case]
    p = cov.shape[-1]
    rng = np.random.default_rng(4)
    x, mean = rng.standard_normal((2, 4, p))
    dx, dmean = rng.standard_normal((2, 4, p))
    dcov = rng.standard_normal((4, p, p))
    dcov = dcov + np.swapaxes(dcov, -1, -2)
    j_args = tuple(jnp.asarray(a) for a in (x, mean, cov))
    t_args = tuple(torch.tensor(a, requires_grad=True) for a in (x, mean, cov))
    val_j = np.asarray(j_mvn_logpdf(*j_args))
    val_t = t_mvn_logpdf(*t_args)
    np.testing.assert_allclose(val_t.detach().numpy(), val_j, rtol=1e-10)
    grads_j = jax.grad(lambda *a: jnp.sum(j_mvn_logpdf(*a)),
                       argnums=(0, 1, 2))(*j_args)
    grads_t = torch.autograd.grad(val_t.sum(), t_args)
    for g_t, g_j in zip(grads_t, grads_j):
        assert torch.isfinite(g_t).all()
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   rtol=1e-10, atol=1e-10)
    tans = (dx, dmean, dcov)
    _, jvp_j = jax.jvp(j_mvn_logpdf, j_args, tuple(jnp.asarray(t)
                                                   for t in tans))
    _, jvp_t = torch.func.jvp(t_mvn_logpdf,
                              tuple(a.detach() for a in t_args),
                              tuple(torch.tensor(t) for t in tans))
    assert torch.isfinite(jvp_t).all()
    np.testing.assert_allclose(jvp_t.numpy(), np.asarray(jvp_j), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("name", ["gauss", "poisson"])
def test_jet2_derivatives_of_the_observation_models(name):
    """The observation models evaluated on Jet2(x, 1, 0) give their first
    and second derivative in x (torch.func, float64); on a Jet2 of Duals the
    tangent of the second derivative is the third derivative."""
    model = tobs.gauss(VAR) if name == "gauss" else tobs.poisson(B0, B1)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(3, 4)) * 3)
    y = [torch.tensor(rng.poisson(2.0, size=(3, 1)).astype(np.float64))]

    def f(xx):
        return model.comp_flat(y, xx, 0, None, 0.0)

    def df(xx):
        return torch.func.jvp(f, (xx,), (torch.ones_like(xx),))[1]

    def d2f(xx):
        return torch.func.jvp(df, (xx,), (torch.ones_like(xx),))[1]

    ones = torch.ones_like(x)
    jet = f(dual.Jet2(x, ones, torch.zeros_like(x)))
    for a, b in ((jet.v, f(x)), (jet.d1, df(x)), (jet.d2, d2f(x))):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    xd = dual.Dual(x, torch.ones((1,) + x.shape, dtype=x.dtype))
    jet = f(dual.Jet2(xd, ones, torch.zeros_like(x)))
    third = torch.func.jvp(d2f, (x,), (ones,))[1]
    torch.testing.assert_close(jet.d2.d[0], third, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(jet.d2.v, d2f(x), rtol=1e-12, atol=1e-12)


def test_jet2_rules_match_torch_func():
    """Every Jet2 rule (+ - * /, constants on either side, exp, log)
    against the first and second derivative by torch.func, float64."""
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.uniform(0.5, 2.0, size=(5,)))
    c = torch.tensor(rng.uniform(0.5, 2.0, size=(5,)))

    def f(u):
        a = u * u - 3.0 + 2.0 * u
        b = (a / (u + 1.0)) - (2.0 / u) + (1.5 - u) * c
        return (b * b).exp() / 50.0 + (u * c + 4.0).log() - (-u) / a

    def df(u):
        return torch.func.jvp(f, (u,), (torch.ones_like(u),))[1]

    jet = f(dual.Jet2(x, torch.ones_like(x), torch.zeros_like(x)))
    torch.testing.assert_close(jet.v, f(x), rtol=1e-12, atol=0)
    torch.testing.assert_close(jet.d1, df(x), rtol=1e-10, atol=0)
    torch.testing.assert_close(
        jet.d2, torch.func.jvp(df, (x,), (torch.ones_like(x),))[1],
        rtol=1e-10, atol=0)


# --- the float64 torch-ops ------------------------------------------------------


def _obs(kind, t_max=T_MAX):
    """Seeded observations at N_OBS equally spaced grid points to t_max:
    Gaussian noise x 5, or Poisson counts."""
    rng = np.random.default_rng(11)
    times = np.linspace(0.0, t_max, N_OBS)
    if kind == "gauss":
        return rng.normal(size=(N_OBS, 3, 1)) * 5, times
    return rng.poisson(2.0, size=(N_OBS, 3, 1)).astype(np.float64), times


def _j_loglik(kind):
    if kind == "gauss":
        return lambda o, s, i, **p: jnp.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2
                                            / VAR)

    def pois(o, s, i, **p):
        lam = jnp.exp(B0 + B1 * s[:, 0])
        return jnp.sum(o[:, 0] * jnp.log(lam) - lam)
    return pois


def _t_loglik(kind):
    if kind == "gauss":
        return lambda o, s, i, **p: torch.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2
                                              / VAR)

    def pois(o, s, i, **p):
        lam = torch.exp(B0 + B1 * s[:, 0])
        return torch.sum(o[:, 0] * torch.log(lam) - lam)
    return pois


@pytest.fixture(scope="module")
def jax_f64():
    """The JAX package's float64 value and gradient, jitted once per
    (observation model, entry point), as a function of theta."""
    cache = {}

    def get(kind, entry, n_steps=N_STEPS, t_max=T_MAX):
        key = (kind, entry, n_steps)
        if key not in cache:
            cfg = jlorenz.setup(n_steps=n_steps, t_max=t_max,
                                dtype=jnp.float64)
            cfg.pop("theta")
            y, times = _obs(kind, t_max)
            fn = {"precond": jprecond.daltonng,
                  "inference": j_daltonng}[entry.split("-")[0]]

            def ll(theta):
                return fn(key=None, interrogate=j_kramer, theta=theta,
                          obs_data=jnp.asarray(y),
                          obs_times=jnp.asarray(times),
                          obs_loglik_i=_j_loglik(kind), **cfg)

            def run(theta):
                with jlinalg.fast_linalg(entry == "inference-fast"):
                    return jax.value_and_grad(ll)(theta)
            cache[key] = (jax.jit(run) if entry == "inference-fast"
                          else jax.jit(jax.value_and_grad(ll)))
        return cache[key]

    return get


def _t_value_and_grad(kind, fn, theta):
    cfg = tlorenz.setup(n_steps=OP_STEPS, t_max=OP_T_MAX,
                        dtype=torch.float64, device="cpu")
    cfg.pop("theta")
    y, times = _obs(kind, OP_T_MAX)
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    val = fn(key=None, interrogate=t_kramer, theta=th,
             obs_data=torch.tensor(y), obs_times=torch.tensor(times),
             obs_loglik_i=_t_loglik(kind), **cfg)
    (grad,) = torch.autograd.grad(val, th)
    return val.item(), grad.numpy()


@pytest.mark.parametrize("kind", ["gauss", "poisson"])
@pytest.mark.parametrize("entry", ["precond", "inference-fast", "inference"])
def test_torch_op_daltonng_matches_jax(jax_f64, kind, entry):
    """The float64 torch-ops on Lorenz63 EK1, 60 steps to t = 0.6, against
    the JAX package's, torch.autograd's gradient against jax.grad.

    ops.precond.daltonng against the JAX package's preconditioned entry:
    value 1e-10 relative, gradient 1e-8 of its largest entry (measured 0
    and 6e-13).  inference.daltonng, in the unpreconditioned coordinates of
    the 5e7 prior, against the JAX package's, both under fast_linalg (the
    closed-form masked inverse and solves, the Joseph updates) and both on
    their default path (pinv of the Hessian, LU solves, the subtractive
    covariance updates): the same likelihood, but the conditioning of
    those coordinates turns the different rounding into 1e-8..1e-7, so
    there value 1e-7 and gradient 1e-6; on the default paths, whose
    subtractive updates amplify rounding most, the gradients land 1.04e-6
    apart: 2e-6 there."""
    theta = np.asarray(tlorenz.THETA, np.float64)
    val_j, grad_j = jax_f64(kind, entry, OP_STEPS, OP_T_MAX)(
        jnp.asarray(theta))
    fn = tprecond.daltonng if entry == "precond" else t_daltonng
    with tlinalg.fast_linalg(entry == "inference-fast"):
        val_t, grad_t = _t_value_and_grad(kind, fn, theta)
    value_rtol, grad_tol = {
        "precond": (F64_VALUE_RTOL, F64_GRAD_TOL),
        "inference-fast": (UNPRECOND_VALUE_RTOL, UNPRECOND_GRAD_TOL),
        "inference": (UNPRECOND_VALUE_RTOL, UNPRECOND_DEFAULT_GRAD_TOL),
    }[entry]
    np.testing.assert_allclose(val_t, float(val_j), rtol=value_rtol)
    grad_j = np.asarray(grad_j)
    assert np.abs(grad_t - grad_j).max() <= grad_tol * np.abs(grad_j).max()


# --- the twins of K9 and K11d ------------------------------------------------


def _filter_operands(model, seed):
    """K9's operands, float32 on the CPU, for 4 lanes of seeded thetas:
    Lorenz63 (EK1, Gaussian data x 5) or FitzHugh-Nagumo (EK0, Poisson
    counts), data every 8th step."""
    mod = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}[model]
    cfg = mod.setup(n_steps=N_STEPS, t_max=T_MAX, dtype=torch.float32,
                    device="cpu")
    rng = np.random.default_rng(seed)
    n_lane, nb = 4, cfg["ode_weight"].shape[0]
    thetas = cfg["theta"] * (1 + 0.01 * torch.tensor(
        rng.standard_normal((n_lane, 3)), dtype=torch.float32))
    inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, T_MAX,
                              N_STEPS, cfg["prior_pars"])
    mask = torch.zeros(N_STEPS)
    mask[7::8] = 1.0
    y = (rng.normal(size=(N_STEPS, nb)) * 5 if model == "lorenz"
         else rng.poisson(2.0, size=(N_STEPS, nb)))
    grid = dict(y=torch.tensor(y, dtype=torch.float32) * mask[:, None],
                iobs=torch.cumsum(mask, 0) * mask, mask=mask)
    return ops, grid


_FILTERS = {
    "lorenz": ("kramer", jlorenz.lorenz_flat, jlorenz.lorenz_jac_flat,
               tobs.gauss(VAR),
               lambda y, x, j, th, i: -0.5 * (y[0] - x) ** 2 / VAR),
    "fitzhugh": ("rodeo", jfitzhugh.fitzhugh_flat, None,
                 tobs.poisson(B0, B1),
                 lambda y, x, j, th, i: y[0] * (B0 + B1 * x)
                 - jnp.exp(B0 + B1 * x)),
}


# The instances of K9 and K11d beyond Lorenz63 and FitzHugh-Nagumo at q = 3
# (Hes1 and SEIRAH at q = 3, FitzHugh-Nagumo and Chkrebtii's ODE at q = 4
# and 5, under kramer and rodeo): their twins run NEW_STEPS steps of the
# functor's INSTANCE_CHECKS setup (tools/torch_coverage_reference.py) on 4
# lanes, data every 4th step, under Gaussian data and, where the rate
# exp(B0 + B1 x) stays finite (every model but SEIRAH, whose populations
# reach 6.4e7), under Poisson counts.
NEW_NN = sorted(
    fk._INSTANCES["filter_nn_batch"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))
NEW_STEPS = 8
_JAX_MODELS = {"FitzHughNagumo": jfitzhugh, "Hes1": jhes1,
               "Seirah": jseirah, "Chkrebtii": jchk}
TWIN_CASES = ["lorenz", "fitzhugh"] + [
    f"{functor}-{mode}-{q}-{obs}" for functor, mode, q in NEW_NN
    for obs in ("gauss", "poisson")
    if obs == "gauss" or functor != "Seirah"]


def _jax_jac(functor, mode, q, n_block):
    """The JAX package's Jacobian columns of ``functor`` under kramer at
    ``q`` (None under rodeo): its hand-written one, padded with None past
    the third derivative, or Hes1's and SEIRAH's by jax.jvp on lane-wide
    seeds (coverage_value_cases.jac_lanes)."""
    if mode != "kramer":
        return None
    jmod = _JAX_MODELS[functor]
    name = jmod.__name__.rsplit(".", 1)[-1]
    if functor in ("Hes1", "Seirah"):
        return cv.jac_lanes(getattr(jmod, f"{name}_flat"), n_block, q)
    jac = getattr(jmod, f"{name}_jac_flat")
    pad = q - (4 if functor == "Chkrebtii" else 3)
    return lambda x, th, t: jac(x, th, t) + [None] * pad


def _twin_case(case, seed):
    """The operands and the JAX kernel's callables of twin case ``case``:
    ``(fused model, ops, grid, n_steps, (mode, ode_flat, jac_flat, obs,
    comp))``, Lorenz63's and FitzHugh-Nagumo's from _filter_operands and
    _FILTERS, a new instance's from its INSTANCE_CHECKS setup cut to
    NEW_STEPS steps."""
    if case in _FILTERS:
        ops, grid = _filter_operands(case, seed)
        return fk.resolve_model(case), ops, grid, N_STEPS, _FILTERS[case]
    functor, mode, q, obs_name = case.split("-")
    q = int(q)
    inst = cv.cov_ref.instance_case(functor, mode, q, 4, "cpu", seed)
    fused = inst["fused"]
    ops = {k: v for k, v in inst["batch"].items() if k != "eps"}
    ops["tgrid"] = ops["tgrid"][:NEW_STEPS].contiguous()
    nb = fused.n_block
    rng = np.random.default_rng(seed)
    mask = torch.zeros(NEW_STEPS)
    mask[3::4] = 1.0
    x0 = inst["cfg"]["ode_init"][:, 0]
    if obs_name == "gauss":
        y = x0[None] * (1 + 0.01 * torch.tensor(
            rng.standard_normal((NEW_STEPS, nb)), dtype=torch.float32))
        obs = tobs.gauss(VAR)
        comp = lambda y, x, j, th, i: -0.5 * (y[0] - x) ** 2 / VAR  # noqa
    else:
        y = torch.tensor(rng.poisson(2.0, size=(NEW_STEPS, nb)),
                         dtype=torch.float32)
        obs, comp = tobs.poisson(B0, B1), _FILTERS["fitzhugh"][4]
    grid = dict(y=y * mask[:, None], iobs=torch.cumsum(mask, 0) * mask,
                mask=mask)
    jmod = _JAX_MODELS[functor]
    flat = getattr(jmod, f"{jmod.__name__.rsplit('.', 1)[-1]}_flat")
    return fused, ops, grid, NEW_STEPS, (
        mode, flat, _jax_jac(functor, mode, q, nb), obs, comp)


def _port_filter(fused, ops, grid, n, fns, tangent, dtype=torch.float32,
                 moved=False):
    """K9's twin (K11d's with ``tangent``) on the twin case's operands, in
    ``dtype``; with ``moved`` theta, x0 and the prior variance first moved
    one float32 ulp up (coverage_value_cases.ulp_up)."""
    mode, obs = fns[0], fns[3]
    if moved:
        ops = {k: (torch.from_numpy(cv.ulp_up(v.numpy()))
                   if k in ("theta_lanes", "x0_lanes", "prior_var") else v)
               for k, v in ops.items()}
    wide = {k: v.to(dtype) if isinstance(v, torch.Tensor) else v
            for k, v in {**ops, **grid}.items()}
    twin = fdn._filter_nn_batch_tan_plain if tangent \
        else fdn._filter_nn_batch_plain
    return twin(fused, obs, (0,), n, **wide, mode=mode)


# The twin cases whose float32 EK1 covariances, and their tangents, are
# rounding-bound in both packages, by kernel (False: K9, True: K11d): the
# twins and the Pallas kernels part there by up to 2.3e-5 (K9; FitzHugh-
# Nagumo under kramer at q = 5, Chkrebtii's ODE under kramer at q = 5) and
# 4.1e-4 (K11d; FitzHugh-Nagumo under kramer at q = 4 and 5) of a stream's
# largest entry, so _check_against_pallas holds both to the twin run in
# float64 there.  Every other case keeps the tolerance alone.
ROUNDING_BOUND = {False: ("FitzHughNagumo-kramer-5", "Chkrebtii-kramer-5"),
                  True: ("FitzHughNagumo-kramer-4", "FitzHughNagumo-kramer-5")}


def _check_against_pallas(case, fused, ops, grid, n, fns, out_t, out_j,
                          tangent, tol):
    """Each stream of the port's twin ``out_t``, and each tangent direction
    of it, against the Pallas kernel's ``out_j``: within ``tol`` of the
    Pallas kernel's largest entry (coverage_value_cases.tan_err; the
    absolute error where it is all zero), or, at ROUNDING_BOUND's cases of
    the kernel alone and where the two part by more, both within float32's
    resolution of the twin run in float64 on the same operands: the larger
    of ``tol`` and 3 x the port's own move under a one-ulp move of theta,
    x0 and the prior variance (FitzHugh-Nagumo q = 4 under kramer: port
    1.3e-4 and Pallas 2.7e-5 from the float64 run, the port's move
    1.8e-4)."""
    q = ops["x0_lanes"].shape[0]
    n_tri = q * (q + 1) // 2
    n_aug = 1 + fused.n_theta if tangent else 1
    rounding_bound = case.rsplit("-", 1)[0] in ROUNDING_BOUND[tangent]
    extra = {}
    for s, (a, b, k) in enumerate(zip(out_t, out_j,
                                      (q, n_tri, q, n_tri))):
        a, b = a.numpy(), np.asarray(b)
        assert np.isfinite(a).all(), s
        for d in range(n_aug):
            part = slice(d * k, (d + 1) * k)
            err = cv.tan_err(a[:, part], b[:, part])
            if err <= tol:
                continue
            assert rounding_bound, (s, d, err, tol)
            if not extra:
                extra["plain"] = _port_filter(fused, ops, grid, n, fns,
                                              tangent, torch.float64)
                extra["moved"] = _port_filter(fused, ops, grid, n, fns,
                                              tangent, moved=True)
            plain = extra["plain"][s][:, part].numpy()
            bound = max(tol, 3 * cv.tan_err(
                extra["moved"][s][:, part].numpy(), a[:, part]))
            errs = cv.tan_err(a[:, part], plain), cv.tan_err(b[:, part], plain)
            assert max(errs) <= bound, (s, d, errs, bound)


def _jax_filter(n_steps, fns, ops, grid, tangent):
    """The JAX package's Pallas kernel (interpret mode) on the same float32
    operands, under the twin case's callables ``fns``."""
    mode, ode_flat, jac_flat, _, comp = fns
    j = {k: jnp.asarray(v.numpy()) for k, v in {**ops, **grid}.items()
         if isinstance(v, torch.Tensor)}
    args = (n_steps, None, j["prior_var"], j["ode_weight"], j["x0_lanes"],
            j["theta_lanes"], j["tgrid"], j["t_vec"],
            j["y"][:, None, :, None], j["iobs"][:, None], j["mask"][:, None],
            ops["q_const"])
    if tangent:
        return jd._filter_nn_batch_tan(ode_flat, jac_flat, comp, (0,), mode,
                                       ops["theta_lanes"].shape[0], *args,
                                       interpret=True)
    return jd._filter_nn_batch(ode_flat, jac_flat, comp, (0,), mode, *args,
                               interpret=True)


@pytest.mark.parametrize("case", TWIN_CASES)
def test_k9_twin_matches_pallas(case):
    """K9's twin (Lorenz63 EK1 with Gaussian data, FitzHugh-Nagumo EK0 with
    Poisson counts, 64 steps x 4 lanes; and every new instance, NEW_NN,
    under Gaussian data and Poisson counts) against _filter_nn_batch on the
    same float32 operands: every stream finite and within 1e-5 of its
    largest entry, or, at ROUNDING_BOUND's cases, held by
    _check_against_pallas's rule."""
    fused, ops, grid, n, fns = _twin_case(case, 0)
    mode, obs = fns[0], fns[3]
    out_t = fdn.filter_nn_batch(fused, obs, (0,), n, **ops, **grid,
                                mode=mode)
    out_j = _jax_filter(n, fns, ops, grid, False)
    _check_against_pallas(case, fused, ops, grid, n, fns, out_t, out_j,
                          False, STREAM_TOL)


@pytest.mark.parametrize("case", TWIN_CASES)
def test_k11d_twin_matches_pallas(case):
    """K11d's twin against _filter_nn_batch_tan (Lorenz63 and
    FitzHugh-Nagumo at t <= 0.5, and every new instance): the values equal
    K9's twin bitwise, and each stream's values and each tangent direction
    are within 1e-4 of their largest entry of the Pallas kernel's (the
    absolute error where that direction's tangent is zero: Chkrebtii's
    placeholder parameter), or, at ROUNDING_BOUND's cases, held by
    _check_against_pallas's rule."""
    fused, ops, grid, n, fns = _twin_case(case, 1)
    mode, obs = fns[0], fns[3]
    q = ops["x0_lanes"].shape[0]
    n_tri = q * (q + 1) // 2
    out_t = fdn.filter_nn_batch_tan(fused, obs, (0,), n, **ops, **grid,
                                    mode=mode)
    value = fdn.filter_nn_batch(fused, obs, (0,), n, **ops, **grid,
                                mode=mode)
    out_j = _jax_filter(n, fns, ops, grid, True)
    for a, v, k in zip(out_t, value, (q, n_tri, q, n_tri)):
        assert torch.equal(a[:, :k], v)
    _check_against_pallas(case, fused, ops, grid, n, fns, out_t, out_j,
                          True, TANGENT_TOL)


@pytest.mark.parametrize("case", TWIN_CASES)
def test_twins_skip_only_exact_identities(case):
    """The kernels and their twins skip the pseudo-observation update at
    steps without data; running it there (the JAX package's kernel does)
    changes no bit, of the values or of the tangents."""
    fused, ops, grid, n, fns = _twin_case(case, 2)
    mode, obs = fns[0], fns[3]
    args = (fused, obs, (0,), n, ops["q_const"], ops["prior_var"],
            ops["ode_weight"], ops["t_vec"], ops["x0_lanes"],
            ops["theta_lanes"], ops["tgrid"], grid["y"], grid["iobs"],
            grid["mask"], mode)
    for twin in (fdn._filter_nn_batch_plain, fdn._filter_nn_batch_tan_plain):
        skip = twin(*args)
        full = twin(*args, skip_unobserved=False)
        assert all(torch.equal(a, b) for a, b in zip(skip, full))


# --- the fused path -------------------------------------------------------------


def _lanes(theta, n_lane):
    return np.stack([np.asarray(theta) * (1.0 + 0.01 * i)
                     for i in range(n_lane)]).astype(np.float32)


@pytest.fixture(scope="module")
def fused_lorenz():
    """The port's fused value and gradient (the CPU twins) and the JAX
    package's (interpret mode) on Lorenz63 EK1 with Gaussian data, 3
    lanes."""
    cfg = jlorenz.setup(n_steps=N_STEPS, t_max=T_MAX, dtype=jnp.float32)
    theta = cfg.pop("theta")
    prior = tuple(jnp.asarray(a, jnp.float32) for a in cfg["prior_pars"])
    y, times = _obs("gauss")
    thetas = _lanes(theta, 3)
    inits = np.broadcast_to(np.asarray(cfg["ode_init"]), (3, 3, 3)).copy()
    j_args = dict(ode_weight=cfg["ode_weight"], ode_inits=jnp.asarray(inits),
                  t_min=0.0, t_max=T_MAX, n_steps=N_STEPS, prior_pars=prior,
                  obs_data=jnp.asarray(y, jnp.float32),
                  obs_times=jnp.asarray(times, jnp.float32),
                  obs_comp_flat=_FILTERS["lorenz"][4], obs_dims=(0,),
                  ode_flat=jlorenz.lorenz_flat,
                  jac_flat=jlorenz.lorenz_jac_flat, interpret=True)
    jv = np.asarray(jd.daltonng_fused_batch(jnp.asarray(thetas), **j_args))
    _, jg = jd.daltonng_fused_batch_grad(jnp.asarray(thetas), **j_args)
    tcfg = tlorenz.setup(n_steps=N_STEPS, t_max=T_MAX, device="cpu")
    t_args = dict(ode_weight=tcfg["ode_weight"],
                  ode_inits=torch.tensor(inits), t_min=0.0, t_max=T_MAX,
                  n_steps=N_STEPS, prior_pars=tcfg["prior_pars"],
                  obs_data=torch.tensor(y, dtype=torch.float32),
                  obs_times=torch.tensor(times, dtype=torch.float32),
                  obs_model=tobs.gauss(VAR), obs_dims=(0,), model="lorenz",
                  device="cpu")
    tv = rt.daltonng_fused_batch(torch.tensor(thetas), **t_args)
    tll, tg = rt.daltonng_fused_batch_grad(torch.tensor(thetas), **t_args)
    return dict(thetas=thetas, jv=jv, jg=np.asarray(jg), tv=tv, tll=tll,
                tg=tg)


def test_fused_value_matches_jax(fused_lorenz, jax_f64):
    """daltonng_fused_batch on the CPU against the JAX package's fused path
    (1e-5 relative) and its float64 preconditioned daltonng (5e-3, the JAX
    package's own test's rule)."""
    tv = fused_lorenz["tv"].numpy()
    assert np.all(np.isfinite(tv))
    np.testing.assert_allclose(tv, fused_lorenz["jv"], rtol=FUSED_RTOL)
    for i, th in enumerate(fused_lorenz["thetas"]):
        val, _ = jax_f64("gauss", "precond")(jnp.asarray(th, jnp.float64))
        np.testing.assert_allclose(tv[i], float(val), rtol=F64_FUSED_RTOL)


def test_fused_gradient(fused_lorenz, jax_f64):
    """daltonng_fused_batch_grad on the CPU: its values are the value call's
    bitwise; its gradient is the JAX package's fused gradient within 1e-4
    relative L2 per lane, and points as the float64 jax.grad does (cosine >
    0.99, norm ratio 0.9-1.1, the JAX package's own test's rule)."""
    assert torch.equal(fused_lorenz["tll"], fused_lorenz["tv"])
    tg = fused_lorenz["tg"].double().numpy()
    jg = fused_lorenz["jg"]
    assert tg.shape == (3, 3) and np.all(np.isfinite(tg))
    rel = np.linalg.norm(tg - jg, axis=1) / np.linalg.norm(jg, axis=1)
    assert rel.max() <= FUSED_GRAD_TOL, rel
    for i, th in enumerate(fused_lorenz["thetas"]):
        _, g64 = jax_f64("gauss", "precond")(jnp.asarray(th, jnp.float64))
        g64 = np.asarray(g64)
        cos = tg[i] @ g64 / (np.linalg.norm(tg[i]) * np.linalg.norm(g64))
        ratio = np.linalg.norm(tg[i]) / np.linalg.norm(g64)
        assert cos > 0.99 and 0.9 < ratio < 1.1, (cos, ratio)


def test_fused_poisson_against_the_torch_op():
    """Poisson counts (Lorenz63 EK1, 64 steps, as the JAX package's own
    Poisson test) through the fused value and gradient on the CPU against
    the float64 torch-op ops.precond.daltonng and its torch.autograd
    gradient (the JAX package's rtol 5e-3, and cosine > 0.99).  (On
    FitzHugh-Nagumo over the same short grid the float32 fused path is
    lost to rounding: the JAX package's lands at -334 and the port's at
    -70 against a float64 value of -9.0.)"""
    y, times = _obs("poisson")
    cfg = tlorenz.setup(n_steps=N_STEPS, t_max=T_MAX, dtype=torch.float32,
                        device="cpu")
    thetas = torch.tensor(_lanes(cfg["theta"], 2))
    ll, grad = rt.daltonng_fused_batch_grad(
        thetas, cfg["ode_weight"], cfg["ode_init"].expand(2, 3, 3), 0.0,
        T_MAX, N_STEPS, cfg["prior_pars"],
        torch.tensor(y, dtype=torch.float32),
        torch.tensor(times, dtype=torch.float32), tobs.poisson(B0, B1), (0,),
        "lorenz", device="cpu")
    cfg64 = tlorenz.setup(n_steps=N_STEPS, t_max=T_MAX, dtype=torch.float64,
                          device="cpu")
    cfg64.pop("theta")
    for i in range(2):
        th = thetas[i].double().requires_grad_(True)
        ref = tprecond.daltonng(
            key=None, interrogate=t_kramer, theta=th,
            obs_data=torch.tensor(y), obs_times=torch.tensor(times),
            obs_loglik_i=_t_loglik("poisson"), **cfg64)
        (g64,) = torch.autograd.grad(ref, th)
        np.testing.assert_allclose(ll[i].item(), ref.item(),
                                   rtol=F64_FUSED_RTOL)
        g = grad[i].double()
        assert torch.dot(g, g64) / (g.norm() * g64.norm()) > 0.99


def test_fitzhugh_float32_error_sets_the_card_tolerance():
    """chip_smoke.py's informative check of the card: bench.py's
    FitzHugh-Nagumo fixture (EK1, 200 steps to t = 10, y_fitz_mcmc on both
    blocks, Gaussian data of variance 0.04) at its 4 lanes, through the
    float32 twins against the float64 torch-op ops.precond.daltonng and its
    torch.autograd gradient.  Three times their largest relative errors,
    value and gradient (relative L2), stay within the card's limits
    DALTONNG_FITZ_VALUE_TOL and DALTONNG_FITZ_TOL.  The float32 value is
    rounding-bound here: lanes 1e-6 apart in theta scatter by 0.1 around a
    bias of -0.28 from the float64 value (-16.27), and the JAX package's
    fused path lands 2.2 % off."""
    from pathlib import Path

    truth = np.load(Path(__file__).resolve().parents[1] / ".bench_ref_v8.npz")
    smoke = _chip_smoke()
    n, t_max = 200, 10.0
    idx = np.arange(0, n + 1, 10)
    y = torch.tensor(truth["y_fitz_mcmc"])[:, :, None]
    times = torch.tensor(t_max * idx / n)
    cfg = tfitzhugh.setup(n_steps=n, t_max=t_max, dtype=torch.float32,
                          device="cpu")
    thetas = cfg["theta"] * torch.tensor(smoke.DALTONNG_FITZ_LANES,
                                         dtype=torch.float32)[:, None]
    n_lane = thetas.shape[0]
    ll, grad = rt.daltonng_fused_batch_grad(
        thetas, cfg["ode_weight"], cfg["ode_init"].expand(n_lane, 2, 3), 0.0,
        t_max, n, cfg["prior_pars"], y.float(), times.float(),
        tobs.gauss(smoke.DALTONNG_FITZ_VAR), (0,), "fitzhugh", device="cpu")
    cfg64 = tfitzhugh.setup(n_steps=n, t_max=t_max, device="cpu")
    cfg64.pop("theta")

    def loglik(o, s, i, **p):
        return torch.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2
                         / smoke.DALTONNG_FITZ_VAR)

    value_rel, grad_rel = [], []
    for i in range(n_lane):
        th = thetas[i].double().requires_grad_(True)
        ref = tprecond.daltonng(key=None, interrogate=t_kramer, theta=th,
                                obs_data=y, obs_times=times,
                                obs_loglik_i=loglik, **cfg64)
        (g64,) = torch.autograd.grad(ref, th)
        value_rel.append(abs(ll[i].item() - ref.item()) / abs(ref.item()))
        grad_rel.append(((grad[i].double() - g64).norm()
                         / g64.norm()).item())
    assert 3 * max(value_rel) <= smoke.DALTONNG_FITZ_VALUE_TOL, value_rel
    assert 3 * max(grad_rel) <= smoke.DALTONNG_FITZ_TOL, grad_rel
