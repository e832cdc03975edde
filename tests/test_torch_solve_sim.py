"""
Parity of the port's solve_sim slice with the JAX package at float64 on the
CPU: the fast-linalg switch and what follows it (update, solve_var and the
smoothers' conditional variance), the small linear algebra of
rodeo_tpu_torch.ops.linalg and rodeo_tpu_torch.utils, the Kalman steps
filter, smooth_sim and smooth, indep_init, the Chkrebtii interrogation,
and rodeo_tpu_torch.solve_sim with its preconditioned wrapper.

Inputs are made with numpy from a seed and handed to both packages.  Where
both compute the same float64 formulas the tolerance is 1e-12 relative.
Draws are held exactly where both are given the same normals, and in
distribution where a factor's column signs (free in an SVD or an
eigendecomposition) decide them.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodeo_tpu
import rodeo_tpu.utils as jutils
from rodeo_tpu import interrogate as jinterrogate
from rodeo_tpu.kalmantv import standard as jstandard
from rodeo_tpu.models import fitzhugh as jfitzhugh
from rodeo_tpu.ops import linalg as jlinalg
from rodeo_tpu.ops import precond as jprecond
from rodeo_tpu.prior import indep_init as jindep_init
from rodeo_tpu.solve import _solve_filter as j_solve_filter

import rodeo_tpu_torch
import rodeo_tpu_torch.utils as tutils
from rodeo_tpu_torch import interrogate as tinterrogate
from rodeo_tpu_torch.kalmantv import standard as tstandard
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh
from rodeo_tpu_torch.ops import linalg as tlinalg
from rodeo_tpu_torch.ops import precond as tprecond
from rodeo_tpu_torch.prior import indep_init as tindep_init
from rodeo_tpu_torch.solve import _solve_filter as t_solve_filter

RTOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _psd(rng, *shape):
    a = rng.standard_normal(shape + (shape[-1],))
    return a @ np.swapaxes(a, -1, -2) + shape[-1] * np.eye(shape[-1])


def _switch(fast):
    """Both packages' fast-linalg switch, on or off."""
    stack = contextlib.ExitStack()
    stack.enter_context(jlinalg.fast_linalg(fast))
    stack.enter_context(tlinalg.fast_linalg(fast))
    return stack


@pytest.fixture
def kalman_inputs():
    rng = np.random.default_rng(11)
    nb, q, p = 3, 3, 1
    return dict(
        mean_past=rng.standard_normal((nb, q)), var_past=_psd(rng, nb, q),
        mean_state=rng.standard_normal((nb, q)),
        wgt_state=rng.standard_normal((nb, q, q)),
        var_state=_psd(rng, nb, q), x_meas=rng.standard_normal((nb, p)),
        mean_meas=rng.standard_normal((nb, p)),
        wgt_meas=rng.standard_normal((nb, p, q)),
        var_meas=_psd(rng, nb, p), x_next=rng.standard_normal((nb, q)),
        mean_next=rng.standard_normal((nb, q)), var_next=_psd(rng, nb, q),
        mean_filt=rng.standard_normal((nb, q)), var_filt=_psd(rng, nb, q),
        mean_pred=rng.standard_normal((nb, q)), var_pred=_psd(rng, nb, q))


# ---- the switch -------------------------------------------------------------

def test_fast_linalg_is_a_context_switch():
    assert not tlinalg.fast_linalg_enabled()
    with tlinalg.fast_linalg():
        assert tlinalg.fast_linalg_enabled()
        with tlinalg.fast_linalg(False):
            assert not tlinalg.fast_linalg_enabled()
        assert tlinalg.fast_linalg_enabled()
    assert not tlinalg.fast_linalg_enabled()


@pytest.mark.parametrize("fast", [False, True])
def test_update_with_joseph_none_follows_the_switch(kalman_inputs, fast):
    """update(joseph=None): the subtractive form and an LU solve off the
    switch, the Joseph form and the closed-form solve on it, as the JAX
    package's."""
    k = kalman_inputs
    args = ("x_meas", "mean_meas", "wgt_meas", "var_meas")
    with _switch(fast):
        upd_t = tstandard.update(_t(k["mean_pred"]), _t(k["var_pred"]),
                                 *(_t(k[a]) for a in args))
        upd_j = jstandard.update(k["mean_pred"], k["var_pred"],
                                 *(k[a] for a in args))
        explicit = tstandard.update(_t(k["mean_pred"]), _t(k["var_pred"]),
                                    *(_t(k[a]) for a in args), joseph=fast)
    for a, b, c in zip(upd_t, upd_j, explicit):
        _close(a, b)
        assert torch.equal(a, c)


@pytest.mark.parametrize("fast", [False, True])
def test_solve_var_dispatches_through_solve_psd(fast):
    rng = np.random.default_rng(1)
    V = _psd(rng, 4, 3)
    B = rng.standard_normal((4, 3, 2))
    with _switch(fast):
        _close(tutils.solve_var(_t(V), _t(B)), jutils.solve_var(V, B))
        _close(tutils.solve_var(_t(V), _t(B[..., 0])),
               jutils.solve_var(V, B[..., 0]))
        assert torch.equal(tutils.solve_var(_t(V), _t(B)),
                           tlinalg.solve_psd(_t(V), _t(B)))


# ---- ops.linalg and utils ---------------------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_solve_small_and_solve_psd_match_jax(fast, n):
    """solve_small: LU off the switch or above n = 5, the closed form on it;
    solve_psd adds the Cholesky solve for n > 5 on the switch."""
    rng = np.random.default_rng(n)
    a = _psd(rng, 6, n)
    b = rng.standard_normal((6, n, 2))
    with _switch(fast):
        for fn in ("solve_small", "solve_psd"):
            _close(getattr(tlinalg, fn)(_t(a), _t(b)),
                   getattr(jlinalg, fn)(a, b))
            _close(getattr(tlinalg, fn)(_t(a), _t(b[..., 0])),
                   getattr(jlinalg, fn)(a, b[..., 0]))


def test_solve_psd_is_nan_on_an_indefinite_matrix_above_five():
    """The Cholesky branch returns NaN where the matrix is not positive
    definite, as the JAX package's does, rather than raising."""
    a = -np.eye(7)[None].repeat(2, 0)
    a[0] = np.eye(7) * 2
    b = np.ones((2, 7))
    with _switch(True):
        port = tlinalg.solve_psd(_t(a), _t(b)).numpy()
        ref = np.asarray(jlinalg.solve_psd(a, b))
    assert np.isnan(port[1]).all() and np.isnan(ref[1]).all()
    _close(port[0], ref[0])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_mvn_logpdf_small_matches_jax(n):
    rng = np.random.default_rng(20 + n)
    cov = _psd(rng, 5, n) * 10.0 ** rng.uniform(-3, 3, (5, 1, 1))
    x, mean = rng.standard_normal((2, 5, n))
    with _switch(True):
        _close(tlinalg.mvn_logpdf_small(_t(x), _t(mean), _t(cov)),
               jlinalg.mvn_logpdf_small(x, mean, cov))


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_tri_solve_small_matches_jax(lower, transpose):
    rng = np.random.default_rng(3)
    chol = np.linalg.cholesky(_psd(rng, 4, 5))
    if not lower:
        chol = np.swapaxes(chol, -1, -2)
    b = rng.standard_normal((4, 5, 3))
    _close(tlinalg.tri_solve_small(_t(chol), _t(b), lower=lower,
                                   transpose=transpose),
           jlinalg.tri_solve_small(chol, b, lower=lower, transpose=transpose))


@pytest.mark.parametrize("fast", [False, True])
def test_matmul_small_matches_jax(fast):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 6, 3, 3))
    with _switch(fast):
        _close(tlinalg.matmul_small(_t(a), _t(b)),
               jlinalg.matmul_small(a, b))


@pytest.mark.parametrize("fast", [False, True])
def test_add_sqrt_matches_jax_as_a_gram(fast):
    """QR off the switch, the Cholesky factor of the Gram sum on it; a
    factor is defined up to a rotation, so L L' is compared."""
    rng = np.random.default_rng(5)
    sa = rng.standard_normal((4, 3, 3))
    sb = rng.standard_normal((4, 3, 2))
    with _switch(fast):
        lt = tutils.add_sqrt(_t(sa), _t(sb)).numpy()
        lj = np.asarray(jutils.add_sqrt(sa, sb))
    gram = sa @ np.swapaxes(sa, -1, -2) + sb @ np.swapaxes(sb, -1, -2)
    _close(lt @ np.swapaxes(lt, -1, -2), lj @ np.swapaxes(lj, -1, -2))
    _close(lt @ np.swapaxes(lt, -1, -2), gram)


@pytest.mark.parametrize("fast", [False, True])
def test_mvncond_matches_jax(fast):
    rng = np.random.default_rng(6)
    mu = rng.standard_normal(5)
    sigma = _psd(rng, 5)
    icond = np.array([True, False, True, False, False])
    with _switch(fast):
        for a, b in zip(tutils.mvncond(_t(mu), _t(sigma), _t(icond)),
                        jutils.mvncond(mu, sigma, icond)):
            _close(a, b)


def _eigh_fixture():
    """A symmetric 4 x 4 matrix with a repeated eigenvalue and a zero one,
    rotated."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    return q @ np.diag([0.0, 1.5, 1.5, 4.0]) @ q.T


def test_psd_factor_eigh_gram_and_its_backward_match_jax():
    """The factor's Gram is the matrix; its backward is the transpose of the
    JAX package's clamped JVP, held against jax.vjp at 1e-10: on a matrix
    with a repeated eigenvalue and a zero one, where eigh's own derivative
    is NaN, and on one with a simple spectrum.  The vectors of a repeated
    eigenvalue are free up to a rotation, which two LAPACKs choose apart,
    so the degenerate matrix is diag(0, 1.5, 1.5, 4), whose eigensystem
    both return exactly."""
    cov = np.stack([np.diag([0.0, 1.5, 1.5, 4.0]),
                    _psd(np.random.default_rng(8), 4)])
    ct = np.random.default_rng(9).standard_normal(cov.shape)
    cov_t = _t(cov).requires_grad_(True)
    factor = tlinalg.psd_factor_eigh(cov_t)
    f = factor.detach().numpy()
    _close(f @ np.swapaxes(f, -1, -2), cov, rtol=0, atol=1e-12)
    (grad_t,) = torch.autograd.grad(factor, cov_t, _t(ct))
    out_j, vjp = jax.vjp(jlinalg.psd_factor_eigh, jnp.asarray(cov))
    oj = np.asarray(out_j)
    _close(oj @ np.swapaxes(oj, -1, -2), f @ np.swapaxes(f, -1, -2),
           rtol=0, atol=1e-12)
    # the cotangent lands in the factor's column basis: JAX's and the
    # port's LAPACK return the same eigenvectors up to sign, so the
    # cotangent is given to each in its own basis
    signs = np.sign(np.sum(oj * f, axis=-2, keepdims=True))
    (grad_j,) = vjp(jnp.asarray(ct * signs))
    assert np.isfinite(grad_t.numpy()).all()
    _close(grad_t.numpy(), np.asarray(grad_j), rtol=0,
           atol=1e-10 * np.abs(np.asarray(grad_j)).max())


def test_psd_factor_eigh_jvp_is_the_backwards_transpose():
    """torch.func.jvp of the factor and its backward are transposes of one
    linear map: <dL, G> = <dC, backward(G)>."""
    cov = _t(_eigh_fixture())
    rng = np.random.default_rng(10)
    dcov, g = _t(rng.standard_normal((4, 4))), _t(rng.standard_normal((4, 4)))
    _, dl = torch.func.jvp(tlinalg.psd_factor_eigh, (cov,), (dcov,))
    cov_r = cov.clone().requires_grad_(True)
    (gc,) = torch.autograd.grad(tlinalg.psd_factor_eigh(cov_r), cov_r, g)
    _close(torch.sum(dl * g), torch.sum(dcov * gc))


def test_psd_factor_eigh_in_chunks_is_the_whole_batch(monkeypatch):
    """A batch larger than EIGH_CHUNK is factored a chunk at a time, with
    the factor and its backward bitwise those of one eigh over the batch,
    batch axes and all."""
    rng = np.random.default_rng(11)
    cov = _psd(rng, 3, 5, 3)
    cov[1, 2] = np.diag([0.0, 1.5, 1.5])
    g = _t(rng.standard_normal(cov.shape))

    def factor_and_grad():
        c = _t(cov).requires_grad_(True)
        f = tlinalg.psd_factor_eigh(c)
        return f.detach(), torch.autograd.grad(f, c, g)[0]

    whole = factor_and_grad()
    monkeypatch.setattr(tlinalg, "EIGH_CHUNK", 4)
    chunked = factor_and_grad()
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


# ---- kalmantv.standard, prior.indep_init ------------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_filter_smooth_sim_smooth_and_sim_var_match_jax(kalman_inputs, fast):
    k = kalman_inputs
    kt = {n: _t(a) for n, a in k.items()}
    state = ("mean_past", "var_past", "mean_state", "wgt_state", "var_state")
    meas = ("x_meas", "mean_meas", "wgt_meas", "var_meas")
    mom = ("mean_filt", "var_filt", "mean_pred", "var_pred")
    with _switch(fast):
        for a, b in zip(
                tstandard.filter(*(kt[n] for n in state + meas)),
                jstandard.filter(*(k[n] for n in state + meas))):
            _close(a, b)
        for a, b in zip(
                tstandard.smooth_sim(kt["x_next"], *(kt[n] for n in mom),
                                     kt["wgt_state"],
                                     var_state=kt["var_state"]),
                jstandard.smooth_sim(k["x_next"], *(k[n] for n in mom),
                                     k["wgt_state"],
                                     var_state=k["var_state"])):
            _close(a, b, atol=1e-12)
        for a, b in zip(
                tstandard.smooth(kt["x_next"], kt["mean_next"],
                                 kt["var_next"], *(kt[n] for n in mom),
                                 kt["wgt_state"], var_state=kt["var_state"]),
                jstandard.smooth(k["x_next"], k["mean_next"], k["var_next"],
                                 *(k[n] for n in mom), k["wgt_state"],
                                 var_state=k["var_state"])):
            _close(a, b, atol=1e-12)
        temp_t, gain_t = tstandard._smooth_gain(kt["var_filt"],
                                                kt["var_pred"],
                                                kt["wgt_state"])
        temp_j, gain_j = jstandard._smooth_gain(k["var_filt"], k["var_pred"],
                                                k["wgt_state"])
        for var_state in (None, "given"):
            vs_t = kt["var_state"] if var_state else None
            vs_j = k["var_state"] if var_state else None
            _close(tstandard._sim_var(gain_t, temp_t, kt["var_filt"],
                                      kt["wgt_state"], vs_t),
                   jstandard._sim_var(gain_j, temp_j, k["var_filt"],
                                      k["wgt_state"], vs_j), atol=1e-12)


def test_indep_init_matches_jax():
    rng = np.random.default_rng(12)
    wgt, var = rng.standard_normal((2, 3, 4, 4))
    for a, b in zip(tindep_init((_t(wgt), _t(var))), jindep_init((wgt, var))):
        assert a.shape == (1, 12, 12)
        _close(a, b)


# ---- the Chkrebtii interrogation --------------------------------------------

def _jax_block_normals(key, n_block, n_bstate):
    """The normals jax.random.multivariate_normal draws for each block in
    the JAX package's interrogate_chkrebtii."""
    _, *subkeys = jax.random.split(key, num=n_block + 1)
    return np.stack([np.asarray(jax.random.normal(k, (n_bstate,),
                                                  dtype=jnp.float64))
                     for k in subkeys])


def test_interrogate_chkrebtii_matches_jax_given_its_normals():
    cfg = jfitzhugh.setup(n_steps=40, dtype=jnp.float64)
    rng = np.random.default_rng(13)
    mean = rng.standard_normal((2, 3))
    var = _psd(rng, 2, 3)
    key = jax.random.PRNGKey(5)
    z = _jax_block_normals(key, 2, 3)
    out_j = jinterrogate.interrogate_chkrebtii(
        key, cfg["ode_fun"], cfg["ode_weight"], 0.3, mean, var,
        kalman_type="standard", theta=cfg["theta"])
    cfg_t = tfitzhugh.setup(n_steps=40, device="cpu")
    out_t = tinterrogate.interrogate_chkrebtii(
        _t(z), cfg_t["ode_fun"], cfg_t["ode_weight"], 0.3, _t(mean),
        _t(var), kalman_type="standard", theta=cfg_t["theta"])
    for a, b in zip(out_t, out_j):
        _close(a, b)
    gen = torch.Generator().manual_seed(0)
    drawn = tinterrogate.interrogate_chkrebtii(
        gen, cfg_t["ode_fun"], cfg_t["ode_weight"], 0.3, _t(mean), _t(var),
        kalman_type="standard", theta=cfg_t["theta"])
    assert torch.isfinite(drawn[1]).all()


def test_interrogate_chkrebtii_is_nan_on_a_singular_variance():
    """A Cholesky draw from a singular variance is NaN in the JAX package;
    the port returns the same rather than raising."""
    cfg = tfitzhugh.setup(n_steps=40, device="cpu")
    var = torch.zeros((2, 3, 3), dtype=torch.float64)
    var[0] = torch.eye(3)
    out = tinterrogate.interrogate_chkrebtii(
        torch.zeros((2, 3), dtype=torch.float64), cfg["ode_fun"],
        cfg["ode_weight"], 0.0, torch.zeros((2, 3), dtype=torch.float64),
        var, kalman_type="standard", theta=cfg["theta"])
    cfg_j = jfitzhugh.setup(n_steps=40, dtype=jnp.float64)
    out_j = jinterrogate.interrogate_chkrebtii(
        jax.random.PRNGKey(0), cfg_j["ode_fun"], cfg_j["ode_weight"], 0.0,
        jnp.zeros((2, 3)), jnp.asarray(var.numpy()), kalman_type="standard",
        theta=cfg_j["theta"])
    assert np.array_equal(np.isnan(out[1].numpy()),
                          np.isnan(np.asarray(out_j[1])))
    assert np.isnan(out[1].numpy()).any()


def test_solve_mv_with_chkrebtii_matches_jax_given_its_normals():
    """solve_mv through the Chkrebtii interrogation, the port's key a
    generator that replays the JAX package's per-step normals."""
    n_steps = 10
    cfg_j = jfitzhugh.setup(n_steps=n_steps, dtype=jnp.float64)
    cfg_t = tfitzhugh.setup(n_steps=n_steps, device="cpu")
    key = jax.random.PRNGKey(3)
    step_keys = jax.random.split(key, num=n_steps)
    normals = [_jax_block_normals(k, 2, 3) for k in step_keys]

    def replay(key, **kwargs):
        return tinterrogate.interrogate_chkrebtii(
            _t(normals[replay.n]), **kwargs)

    def counted(key, **kwargs):
        out = replay(key, **kwargs)
        replay.n += 1
        return out

    replay.n = 0
    j_int = functools.partial(jinterrogate.interrogate_chkrebtii,
                              kalman_type="standard")
    mu_j, var_j = rodeo_tpu.solve_mv(
        key=key, interrogate=j_int, ode_fun=cfg_j["ode_fun"],
        ode_weight=cfg_j["ode_weight"], ode_init=cfg_j["ode_init"],
        t_min=0.0, t_max=10.0, n_steps=n_steps,
        prior_pars=cfg_j["prior_pars"], theta=cfg_j["theta"])
    mu_t, var_t = rodeo_tpu_torch.solve_mv(
        key=None, interrogate=functools.partial(counted,
                                                kalman_type="standard"),
        ode_fun=cfg_t["ode_fun"], ode_weight=cfg_t["ode_weight"],
        ode_init=cfg_t["ode_init"], t_min=0.0, t_max=10.0, n_steps=n_steps,
        prior_pars=cfg_t["prior_pars"], theta=cfg_t["theta"])
    _close(mu_t, mu_j, rtol=1e-10, atol=1e-12)
    _close(var_t, var_j, rtol=1e-10, atol=1e-12)


# ---- solve_sim --------------------------------------------------------------

N_SIM = 40
N_DRAWS = 400


def _fitz(n_steps=N_SIM):
    cfg_j = jfitzhugh.setup(n_steps=n_steps, dtype=jnp.float64)
    cfg_t = tfitzhugh.setup(n_steps=n_steps, device="cpu")
    return cfg_j, cfg_t


def _filtered(pkg, entry, n_steps=N_SIM):
    """The forward filter of solve_sim in the coordinates it runs in (the
    Taylor-scaled ones for the preconditioned entry), and its prior."""
    if pkg == "jax":
        cfg = dict(jfitzhugh.setup(n_steps=n_steps, dtype=jnp.float64))
        interrogate, pc, filt = (jinterrogate.interrogate_kramer, jprecond,
                                 j_solve_filter)
    else:
        cfg = dict(tfitzhugh.setup(n_steps=n_steps, device="cpu"))
        interrogate, pc, filt = (tinterrogate.interrogate_kramer, tprecond,
                                 t_solve_filter)
    if entry == "precond":
        t_vec, cfg["ode_weight"], x0, cfg["prior_pars"] = pc._scaled_inputs(
            cfg["ode_weight"], cfg["ode_init"], cfg["prior_pars"],
            cfg["t_min"], cfg["t_max"], n_steps)
        interrogate = pc._wrap_interrogate(interrogate, cfg["ode_weight"]
                                           / t_vec, t_vec)
        cfg["ode_init"] = x0
    out = filt(key=None, interrogate=interrogate,
               prior_weight=cfg["prior_pars"][0],
               prior_var=cfg["prior_pars"][1],
               kalman_funs=jstandard if pkg == "jax" else tstandard,
               **{n: cfg[n] for n in ("ode_fun", "ode_weight", "ode_init",
                                      "t_min", "t_max", "n_steps",
                                      "theta")})
    if pkg == "jax":
        out = out["state_filt"] + out["state_pred"]
    return out, cfg["prior_pars"]


@pytest.mark.parametrize("entry", ["solve", "precond"])
def test_solve_sim_backward_kernels_and_factors_match_jax(entry):
    """What solve_sim(method="eigh") computes before it draws: the
    backward kernels A, b and C of one batched smooth_cond, and the eigh
    factors' Gram, in the coordinates and under the switch each entry runs
    in: exactly (1e-12 relative to each's largest entry) in the scaled
    coordinates.  The plain entry's LU solves on the unscaled prior,
    LAPACK's in each package, round apart by 1.0e-9 relative to the
    largest gain (1.0e-11 to the largest factor Gram): 1e-8 there."""
    n = N_SIM
    with _switch(entry == "precond"):
        conds = {}
        for pkg, std in (("jax", jstandard), ("torch", tstandard)):
            (mf, vf, mp, vp), (wgt, var) = _filtered(pkg, entry)
            conds[pkg] = std.smooth_cond(mf[1:n], vf[1:n], mp[2:n + 1],
                                         vp[2:n + 1], wgt, var_state=var)
        tol = 1e-12 if entry == "precond" else 1e-8
        for a, b in zip(conds["torch"], conds["jax"]):
            b = np.asarray(b)
            _close(a, b, rtol=0, atol=tol * np.abs(b).max())
        lt = tlinalg.psd_factor_eigh(conds["torch"][2]).numpy()
        lj = np.asarray(jlinalg.psd_factor_eigh(conds["jax"][2]))
        gram_j = lj @ np.swapaxes(lj, -1, -2)
        _close(lt @ np.swapaxes(lt, -1, -2), gram_j, rtol=0,
               atol=tol * np.abs(gram_j).max())


def _draws(solver, method, cfg_t, key):
    return torch.stack([solver(
        key=key, ode_fun=cfg_t["ode_fun"], ode_weight=cfg_t["ode_weight"],
        ode_init=cfg_t["ode_init"], t_min=0.0, t_max=10.0, n_steps=N_SIM,
        interrogate=tinterrogate.interrogate_rodeo,
        prior_pars=cfg_t["prior_pars"], method=method,
        theta=cfg_t["theta"]) for _ in range(N_DRAWS)])


@pytest.mark.parametrize("entry,method", [("solve", "eigh"),
                                          ("solve", "svd"),
                                          ("precond", "eigh")])
def test_solve_sim_draws_follow_the_jax_posterior(entry, method):
    """400 draws of FitzHugh-Nagumo (EK0) at 40 steps against the JAX
    package's solve_mv posterior: on the entries whose posterior variance
    exceeds 1e-8, the lane mean within 6 standard errors and the lane
    variance within 0.8-1.25 of the posterior's.  Each draw starts exactly
    at x0."""
    cfg_j, cfg_t = _fitz()
    jsolve = rodeo_tpu.solve_mv if entry == "solve" else jprecond.solve_mv
    tsolver = (rodeo_tpu_torch.solve_sim if entry == "solve"
               else tprecond.solve_sim)
    mu, var = jsolve(key=None, interrogate=jinterrogate.interrogate_rodeo,
                     **cfg_j)
    mu = np.asarray(mu)
    var = np.diagonal(np.asarray(var), axis1=-2, axis2=-1)
    draws = _draws(tsolver, method, cfg_t,
                   torch.Generator().manual_seed(17)).numpy()
    assert draws.shape == (N_DRAWS,) + mu.shape
    assert np.isfinite(draws).all()
    assert np.array_equal(draws[:, 0], np.broadcast_to(
        cfg_t["ode_init"].numpy(), draws[:, 0].shape))
    live = var > 1e-8
    z = (draws.mean(0) - mu) / np.sqrt(var / N_DRAWS)
    ratio = draws.var(0, ddof=1) / var
    assert np.abs(z[live]).max() < 6.0
    assert 0.8 <= ratio[live].min() and ratio[live].max() <= 1.25


def test_solve_sim_takes_normals_in_the_order_of_jaxs_subkeys():
    """Given normals, solve_sim draws the same path as with a generator
    that produced them; the last row is the end point's draw, row n that
    of step n, as the JAX package's subkeys are used.  Held by replaying
    the eigh path's recursion by hand."""
    _, cfg_t = _fitz(8)
    kw = dict(ode_fun=cfg_t["ode_fun"], ode_weight=cfg_t["ode_weight"],
              ode_init=cfg_t["ode_init"], t_min=0.0, t_max=10.0, n_steps=8,
              interrogate=tinterrogate.interrogate_kramer,
              prior_pars=cfg_t["prior_pars"], theta=cfg_t["theta"])
    z = torch.randn((8, 2, 3), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    for method in ("eigh", "svd"):
        a = rodeo_tpu_torch.solve_sim(key=z, method=method, **kw)
        b = rodeo_tpu_torch.solve_sim(
            key=torch.Generator().manual_seed(1), method=method, **kw)
        assert torch.equal(a, b)
    mf, vf, mp, vp = t_solve_filter(
        key=None, prior_weight=kw["prior_pars"][0],
        prior_var=kw["prior_pars"][1], kalman_funs=tstandard,
        **{n: kw[n] for n in ("ode_fun", "ode_weight", "ode_init", "t_min",
                              "t_max", "n_steps", "interrogate", "theta")})
    x = mf[8] + tutils.mvdot(tlinalg.psd_factor_eigh(vf[8]), z[7])
    A, bb, C = tstandard.smooth_cond(mf[1:8], vf[1:8], mp[2:9], vp[2:9],
                                     kw["prior_pars"][0],
                                     var_state=kw["prior_pars"][1])
    path = [x]
    for n in range(6, -1, -1):
        x = tutils.mvdot(A[n], x) + bb[n] + tutils.mvdot(
            tlinalg.psd_factor_eigh(C[n]), z[n])
        path.append(x)
    want = torch.stack([kw["ode_init"]] + path[::-1])
    _close(rodeo_tpu_torch.solve_sim(key=z, method="eigh", **kw), want,
           rtol=0, atol=1e-12 * want.abs().max().item())


def test_solve_sim_eigh_gradient_is_finite():
    """The eigh path's factors go through psd_factor_eigh's clamped
    derivative, never eigh's: the gradient of a draw in theta is finite
    although C is singular at the exact initial state's end."""
    _, cfg_t = _fitz(20)
    theta = cfg_t.pop("theta").clone().requires_grad_(True)
    z = torch.randn((20, 2, 3), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    path = tprecond.solve_sim(
        key=z, interrogate=tinterrogate.interrogate_kramer, method="eigh",
        theta=theta, **cfg_t)
    (grad,) = torch.autograd.grad(path[..., 0].sum(), theta)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize("kwargs", [{"kalman_type": "square-root"},
                                    {"method": "cholesky"}])
def test_solve_sim_raises_for_unported_options(kwargs):
    _, cfg_t = _fitz(4)
    with pytest.raises(NotImplementedError):
        tprecond.solve_sim(key=torch.Generator(),
                           interrogate=tinterrogate.interrogate_kramer,
                           **cfg_t, **kwargs)
