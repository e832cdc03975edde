"""
The fused kernels' full coverage of the JAX package's fused solve, on the
CPU: the interrogations schober and chkrebtii, q = 4 and 5 (the Schur-split
inverse and the closed-form Cholesky), and the models Chkrebtii, Hes1 and
SEIRAH, through the twins of K1, K3, K2r and K4 and every entry point that
runs them, against the JAX package, whose Pallas kernels run in interpret
mode, on the same numpy-seeded inputs.  chkrebtii's draws take the normals
that the JAX package draws from its key (``jax.random.normal(key,
shape)``, its layouts).  And the instance tables: every (kernel, model,
mode, q) that a kernel does not hold raises NotImplementedError in Python
before any launch.

The tolerance is tests/test_torch_fused_kalman.py's SCALED_TOL = 1e-4 of the
largest reference entry, except where the test states the gap it
measured.  Lorenz63's prior (sigma 5e7) is kept for schober, as the JAX
package's own schober test keeps it; under chkrebtii the draws from so wide
a predictive distribution carry the ODE far off and both packages' solves
overflow within 10 steps, so chkrebtii runs Lorenz63 at sigma 10
(CHKREBTII_SIGMA).
"""
import functools
import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rodeo_tpu.models import chkrebtii as jchk, hes1 as jhes1
from rodeo_tpu.models import lorenz as jlorenz, seirah as jseirah
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.ops import pallas_sim as ps
from rodeo_tpu.prior import ibm_init as j_ibm_init

import rodeo_tpu_torch as rt
from rodeo_tpu_torch.models import chkrebtii as tchk, hes1 as thes1
from rodeo_tpu_torch.models import fitzhugh as tfitzhugh
from rodeo_tpu_torch.models import lorenz as tlorenz, seirah as tseirah
from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_sim as fs

SCALED_TOL = 1e-4
# Chkrebtii's ODE at q = 5: the port's solve lies 2.43e-3 of the largest
# entry (its 4th derivative, ~10.6) from the JAX package's on one solve,
# 5.9e-4 on 3 lanes, float32 rounding of both: each lies 0.9e-3 (the JAX
# package) and 1.6e-3 (the port) of it from the float64 torch-op solve
# there, and within 1.1e-6 of it in the solution x.  3 x the gap.
Q5_TOL = 7.3e-3
CHKREBTII_SIGMA = 10.0
N_STEPS, T_MAX, N_LANE = 40, 0.4, 4


def _scaled_err(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    return np.abs(port - ref).max() / np.abs(ref).max()


def _lorenz(mode):
    """Lorenz63, 40 steps to t = 0.4, 4 lanes of thetas 1 % apart."""
    sigma = CHKREBTII_SIGMA if mode == "chkrebtii" else 5e7
    jcfg = jlorenz.setup(n_steps=N_STEPS, t_max=T_MAX, prior_sigma=sigma,
                         dtype=jnp.float32)
    theta = np.asarray(jcfg.pop("theta"))
    tcfg = tlorenz.setup(n_steps=N_STEPS, t_max=T_MAX, prior_sigma=sigma,
                         dtype=torch.float32, device="cpu")
    tcfg.pop("theta")
    rng = np.random.default_rng(3)
    thetas = (theta * (1 + 0.01 * rng.standard_normal((N_LANE, 3)))
              ).astype(np.float32)
    inits = np.broadcast_to(np.asarray(jcfg["ode_init"]),
                            (N_LANE, 3, 3)).astype(np.float32)
    return jcfg, tcfg, thetas, inits


def _obs(n_obs=5, seed=5):
    """Lorenz63's x, y, z at 5 times, rng normals x 5, variance 0.005."""
    rng = np.random.default_rng(seed)
    weight = np.zeros((n_obs, 3, 1, 3), np.float32)
    weight[..., 0] = 1.0
    return dict(
        obs_data=(rng.standard_normal((n_obs, 3, 1)) * 5).astype(np.float32),
        obs_times=np.linspace(0.0, T_MAX, n_obs),
        obs_weight=weight,
        obs_var=np.full((n_obs, 3, 1, 1), 0.005, np.float32))


def _b_loglik_j(obs_data, ode_data, **p):
    return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def _b_loglik_t(obs_data, ode_data, **p):
    return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


# --- the column algebra at q = 4 and 5 ----------------------------------------------


@pytest.mark.parametrize("q", [4, 5])
@pytest.mark.parametrize("fn", ["_sym_inv", "_chol_cols"])
def test_column_algebra_q45_matches_jax(fn, q):
    """The Schur-split inverse and the closed-form Cholesky factor at q = 4
    and 5 against the JAX package's, on covariances whose scales span 12
    decades, in float32."""
    rng = np.random.default_rng(q)
    a = rng.standard_normal((9, q, q))
    m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(q)
    m *= 10.0 ** rng.integers(-6, 6, size=(9, 1, 1))
    pairs, where = fk._tri_idx(q)
    cols = [m[:, i, j].astype(np.float32) for (i, j) in pairs]
    jcols = [jnp.asarray(c) for c in cols]
    tcols = [torch.from_numpy(c) for c in cols]
    if fn == "_sym_inv":
        ref, port = pk._sym_inv(q, jcols), fk._sym_inv(q, tcols)
    else:
        ref = [c for row in pk._chol_cols(q, jcols, where) for c in row]
        port = [c for row in fk._chol_cols(q, tcols, where) for c in row]
    for a_, b_ in zip(port, ref):
        b_ = np.asarray(b_)
        np.testing.assert_allclose(a_.numpy(), b_, rtol=1e-5,
                                   atol=1e-5 * np.abs(b_).max())


# --- schober and chkrebtii through the entry points ---------------------------------


def _jax_entry(entry, mode, jcfg, thetas, inits, key):
    flat = jlorenz.lorenz_flat
    common = dict(ode_weight=jcfg["ode_weight"], t_min=0.0, t_max=T_MAX,
                  n_steps=N_STEPS, prior_pars=jcfg["prior_pars"])
    obs = {k: jnp.asarray(v) for k, v in _obs().items()}
    if entry == "solve_mv_fused_batch":
        return pk.solve_mv_fused_batch(
            thetas=thetas, ode_inits=inits, ode_flat=flat,
            interrogation=mode, key=key, **common)
    if entry == "basic_fused_batch":
        return pk.basic_fused_batch(
            thetas=thetas, ode_inits=inits, ode_flat=flat,
            obs_data=obs["obs_data"], obs_times=obs["obs_times"],
            obs_loglik=_b_loglik_j, interrogation=mode, key=key, **common)
    if entry == "fenrir_fused_batch":
        return pf.fenrir_fused_batch(
            thetas=thetas, ode_inits=inits, ode_flat=flat,
            interrogation=mode, key=key, **obs, **common)
    if entry == "solve_mv_fused":
        return pk.solve_mv_fused(
            key, None, ode_init=inits[0], theta=thetas[0], ode_flat=flat,
            interrogation=mode, **common)
    return pf.fenrir_fused(
        key, None, ode_init=inits[0], interrogate=None, theta=thetas[0],
        ode_flat=flat, interrogation=mode, **obs, **common)


def _port_entry(entry, mode, tcfg, thetas, inits, eps):
    common = dict(ode_weight=tcfg["ode_weight"], t_min=0.0, t_max=T_MAX,
                  n_steps=N_STEPS, prior_pars=tcfg["prior_pars"],
                  model="lorenz", interrogation=mode, device="cpu", eps=eps)
    obs = {k: _t(v) for k, v in _obs().items()}
    if entry == "solve_mv_fused_batch":
        return fk.solve_mv_fused_batch(_t(thetas), ode_inits=_t(inits),
                                       **common)
    if entry == "basic_fused_batch":
        return fk.basic_fused_batch(
            _t(thetas), ode_inits=_t(inits), obs_data=obs["obs_data"],
            obs_times=obs["obs_times"], obs_loglik=_b_loglik_t, **common)
    if entry == "fenrir_fused_batch":
        return ff.fenrir_fused_batch(_t(thetas), ode_inits=_t(inits), **obs,
                                     **common)
    if entry == "solve_mv_fused":
        return fk.solve_mv_fused(_t(thetas[0]), ode_init=_t(inits[0]),
                                 **common)
    return ff.fenrir_fused(_t(thetas[0]), ode_init=_t(inits[0]), **obs,
                           **common)


# the normals each JAX entry draws from its key: (N, q, n_block, B) in the
# lane-batched entries, (N, n_block, q) in the single ones
_BATCHED = ("solve_mv_fused_batch", "basic_fused_batch", "fenrir_fused_batch")


@pytest.mark.parametrize("mode", ["schober", "chkrebtii"])
@pytest.mark.parametrize("entry", _BATCHED + ("solve_mv_fused",
                                              "fenrir_fused"))
def test_entries_match_jax(entry, mode):
    """Each entry that runs K1 or K3 under schober and chkrebtii against the
    JAX package's, chkrebtii given the normals the JAX entry draws."""
    jcfg, tcfg, thetas, inits = _lorenz(mode)
    key = jax.random.PRNGKey(11)
    eps = None
    if mode == "chkrebtii":
        shape = (N_STEPS, 3, 3, N_LANE) if entry in _BATCHED \
            else (N_STEPS, 3, 3)
        eps = _t(jax.random.normal(key, shape, jnp.float32))
    ref = _jax_entry(entry, mode, jcfg, jnp.asarray(thetas),
                     jnp.asarray(inits), key)
    port = _port_entry(entry, mode, tcfg, thetas, inits, eps)
    for a, b in zip(_as_tuple(port), _as_tuple(ref)):
        assert _scaled_err(a, b) <= SCALED_TOL


def test_chkrebtii_draws_move_the_solve():
    """Two sets of normals give two solves, the same normals the same
    bits, and a generator draws normals of the JAX package's layout."""
    _, tcfg, thetas, inits = _lorenz("chkrebtii")
    run = functools.partial(_port_entry, "solve_mv_fused_batch", "chkrebtii",
                            tcfg, thetas, inits)
    g = torch.Generator().manual_seed(0)
    eps = torch.randn((N_STEPS, 3, 3, N_LANE), generator=g)
    a, b = run(eps)[0], run(eps)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, run(torch.randn_like(eps))[0])
    drawn = fk.solve_mv_fused_batch(
        _t(thetas), tcfg["ode_weight"], _t(inits), 0.0, T_MAX, N_STEPS,
        tcfg["prior_pars"], "lorenz", interrogation="chkrebtii",
        device="cpu", generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(drawn, a)


def test_solve_sim_chkrebtii_matches_jax():
    """solve_sim_fused_batch under chkrebtii against the JAX package's,
    given its normals: ``key -> (key, key_int)``, the interrogations' from
    key_int, then the path's and the terminal draw's from the key left."""
    jcfg, tcfg, thetas, inits = _lorenz("chkrebtii")
    key = jax.random.PRNGKey(5)
    ref = ps.solve_sim_fused_batch(
        key, jnp.asarray(thetas), jcfg["ode_weight"], jnp.asarray(inits),
        0.0, T_MAX, N_STEPS, jcfg["prior_pars"], ode_flat=jlorenz.lorenz_flat,
        interrogation="chkrebtii")
    key_left, key_int = jax.random.split(key)
    key_path, key_term = jax.random.split(key_left)
    normal = functools.partial(jax.random.normal, dtype=jnp.float32)
    port = fs.solve_sim_fused_batch(
        _t(thetas), tcfg["ode_weight"], _t(inits), 0.0, T_MAX, N_STEPS,
        tcfg["prior_pars"], "lorenz", interrogation="chkrebtii",
        eps_int=_t(normal(key_int, (N_STEPS, 3, 3, N_LANE))),
        eps=_t(normal(key_path, (N_STEPS - 1, 3, 3, N_LANE))),
        eps_term=_t(normal(key_term, (3, 3, N_LANE))), device="cpu")
    assert _scaled_err(port, ref) <= SCALED_TOL


# --- the models Chkrebtii (q = 4, 5), Hes1 and SEIRAH --------------------------------


def _chkrebtii_cfgs(q):
    """The JAX package's Chkrebtii setup at 40 steps (q = 4), and at q = 5
    the same W, x0 padded with a zero and the IBM prior of 5 derivatives."""
    jcfg = jchk.setup(n_steps=40, dtype=jnp.float32)
    jcfg.pop("theta")
    jac = jchk.chkrebtii_jac_flat
    if q == 5:
        # the JAX package's Jacobian lists N_DERIV = 4 columns
        jac = lambda x, th, t: jchk.chkrebtii_jac_flat(x, th, t) + [None]
        dt = (jcfg["t_max"] - jcfg["t_min"]) / 40
        jcfg["ode_weight"] = jnp.zeros((1, 1, 5), jnp.float32).at[
            :, :, 2].set(1.0)
        jcfg["ode_init"] = jnp.array([[-1.0, 0.0, 1.0, 0.0, 0.0]],
                                     jnp.float32)
        jcfg["prior_pars"] = tuple(
            a.astype(jnp.float32) for a in j_ibm_init(
                dt, 5, jnp.array([0.1], jnp.float32)))
    tcfg = tchk.setup(n_steps=40, dtype=torch.float32, device="cpu",
                      n_deriv=q)
    tcfg.pop("theta")
    return jcfg, tcfg, jac


def _solve_pair(jcfg, tcfg, jflat, jjac, model, theta, n_lane,
                batch_ref=True):
    """The JAX package's and the port's solve of one configuration: one
    solve (``n_lane`` None) or ``n_lane`` lanes of the same, against the
    JAX package's lanes, or with ``batch_ref`` False each lane against its
    single solve (its jvp_jac_flat seeds one column alone)."""
    common = ("ode_weight", "t_min", "t_max", "n_steps", "prior_pars")
    if n_lane is None or not batch_ref:
        ref = pk.solve_mv_fused(
            key=None, ode_fun=None, interrogate=None,
            ode_init=jcfg["ode_init"], ode_flat=jflat, jac_flat=jjac,
            **({} if theta is None else {"theta": jnp.asarray(theta)}),
            **{k: jcfg[k] for k in common})
    if n_lane is not None and not batch_ref:
        mean, var = np.asarray(ref[0]), np.asarray(ref[1])
        pairs, _ = fk._tri_idx(mean.shape[-1])
        packed = np.stack([var[..., i, j] for (i, j) in pairs], axis=-1)
        ref = tuple(np.repeat(a[..., None], n_lane, axis=-1)
                    for a in (mean, packed))
    if n_lane is None:
        port = fk.solve_mv_fused(
            torch.zeros(1) if theta is None else _t(theta),
            ode_init=tcfg["ode_init"], model=model, device="cpu",
            **{k: tcfg[k] for k in common})
        return port, ref
    thetas = np.zeros((n_lane, 1), np.float32) if theta is None \
        else np.broadcast_to(theta, (n_lane, len(theta))).copy()
    if batch_ref:
        jinits = jnp.broadcast_to(jcfg["ode_init"],
                                  (n_lane,) + jcfg["ode_init"].shape)
        ref = pk.solve_mv_fused_batch(
            thetas=jnp.asarray(thetas), ode_inits=jinits, ode_flat=jflat,
            jac_flat=jjac, **{k: jcfg[k] for k in common})
    port = fk.solve_mv_fused_batch(
        _t(thetas), ode_inits=tcfg["ode_init"].expand(
            (n_lane,) + tuple(tcfg["ode_init"].shape)),
        model=model, device="cpu", **{k: tcfg[k] for k in common})
    return port, ref


@pytest.mark.parametrize("n_lane", [None, 3], ids=["single", "batch"])
@pytest.mark.parametrize("q", [4, 5])
def test_chkrebtii_model_matches_jax(q, n_lane):
    """Chkrebtii's second-order ODE under EK1 at q = 4 (the JAX package's
    setup, 40 steps) and q = 5: one solve (K3, K4) and 3 lanes (K1, K2r)."""
    jcfg, tcfg, jac = _chkrebtii_cfgs(q)
    port, ref = _solve_pair(jcfg, tcfg, jchk.chkrebtii_flat, jac,
                            "chkrebtii", None, n_lane)
    for a, b in zip(port, ref):
        assert a.shape == b.shape
        assert _scaled_err(a, b) <= (SCALED_TOL if q == 4 else Q5_TOL)
    # the solution itself, x, the mean's 0th derivative
    assert _scaled_err(port[0][:, :, 0], ref[0][:, :, 0]) <= SCALED_TOL


MODELS = {"hes1": (jhes1, thes1), "seirah": (jseirah, tseirah)}


@pytest.mark.parametrize("n_lane", [None, 3], ids=["single", "batch"])
@pytest.mark.parametrize("model", ["hes1", "seirah"])
def test_other_models_match_jax(model, n_lane):
    """Hes1 and SEIRAH under EK1 at a quarter of their horizons in 40 steps
    (the JAX package's test_fused_other_models), its Jacobian by
    jvp_jac_flat, the port's by Duals: one solve, and 3 lanes each against
    the JAX package's one solve (jvp_jac_flat takes one lane)."""
    jmod, tmod = MODELS[model]
    t_max = jmod.setup()["t_max"] / 4
    jcfg = jmod.setup(n_steps=40, t_max=t_max, dtype=jnp.float32)
    theta = np.asarray(jcfg.pop("theta"))
    tcfg = tmod.setup(n_steps=40, t_max=t_max, dtype=torch.float32,
                      device="cpu")
    tcfg.pop("theta")
    jflat = getattr(jmod, f"{model}_flat")
    jac = pk.jvp_jac_flat(jflat, jmod.N_VARS, 3)
    port, ref = _solve_pair(jcfg, tcfg, jflat, jac, model, theta, n_lane,
                            batch_ref=False)
    for a, b in zip(port, ref):
        assert _scaled_err(a, b) <= SCALED_TOL


@pytest.mark.parametrize("model", ["hes1", "seirah", "chkrebtii"])
def test_dual_jacobians_match_jvp(model):
    """Column 0 of the port's block-diagonal Jacobian (Hes1's and SEIRAH's
    by Duals, Chkrebtii's by hand) against the JAX package's jvp_jac_flat
    at scattered states in float32, within float rounding."""
    jmod = {"hes1": jhes1, "seirah": jseirah, "chkrebtii": jchk}[model]
    tmod = {"hes1": thes1, "seirah": tseirah, "chkrebtii": tchk}[model]
    nb, q = jmod.N_VARS, jmod.N_DERIV
    rng = np.random.default_rng(9)
    x0 = np.asarray(jmod.setup()["ode_init"])[:, 0:1]
    x_cols = [(x0 * (1 + 0.1 * rng.standard_normal((nb, 5)))
               ).astype(np.float32)] + [
        rng.standard_normal((nb, 5)).astype(np.float32)
        for _ in range(q - 1)]
    theta = jmod.setup()["theta"]
    th = np.zeros((1, 5), np.float32) if theta is None else np.broadcast_to(
        np.asarray(theta, np.float32)[:, None], (len(theta), 5)).copy()
    t = np.float32(0.7)
    jflat = getattr(jmod, f"{model}_flat")
    # jvp_jac_flat seeds one (n_block, 1) column: one state at a time
    ref = np.concatenate([np.asarray(pk.jvp_jac_flat(jflat, nb, q)(
        [jnp.asarray(c[:, i:i + 1]) for c in x_cols],
        jnp.asarray(th[:, i:i + 1]), jnp.asarray(t))[0]) for i in range(5)],
        axis=1)
    port = tmod.FUSED.jac_flat([_t(c) for c in x_cols], _t(th), _t(t))
    assert len(port) == q and all(c is None for c in port[1:])
    np.testing.assert_allclose(port[0].numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


# --- the instance tables -------------------------------------------------------------


@pytest.mark.parametrize("kernel", sorted(fk._INSTANCES))
def test_instances_not_held_raise(kernel):
    """Every (model, mode, q) a kernel does not hold raises
    NotImplementedError from the Python gate, naming what it holds; every
    one it holds passes.  The model and mode count only for a kernel that
    takes them."""
    held = fk._INSTANCES[kernel]
    takes_model = any(k[0] is not None for k in held)
    takes_mode = any(k[1] is not None for k in held)
    models = tuple(fk._FUNCTORS) + ("Heat",) if takes_model else (None,)
    modes = tuple(fk._MODES) + ("bogus",) if takes_mode else (None,)
    for model, mode, q in itertools.product(models, modes, range(1, 7)):
        if (model, mode, q) in held:
            fk._check_instance(kernel, q, model, mode)
        else:
            with pytest.raises(NotImplementedError, match="it holds"):
                fk._check_instance(kernel, q, model, mode)


def test_entries_refuse_what_their_kernels_lack():
    """The gradient entries take kramer and rodeo alone, as the JAX
    package's (K11a), and no q beyond 5; DALTON and its gradient kramer and
    rodeo alone and no q beyond 5 (K8, K11c, which take every model of
    K11a: Hes1's and Chkrebtii's gradients run); the stationary solve
    neither the new models nor q = 4."""
    _, tcfg, thetas, inits = _lorenz("schober")
    batch = (_t(thetas), tcfg["ode_weight"], _t(inits), 0.0, T_MAX, N_STEPS,
             tcfg["prior_pars"])
    obs = {k: _t(v) for k, v in _obs().items()}
    for call in (
            lambda: fk.solve_mv_fused_batch_grad(
                *batch, "lorenz", interrogation="schober", device="cpu"),
            lambda: ff.fenrir_fused_batch_grad(
                *batch, **obs, model="lorenz", interrogation="chkrebtii",
                device="cpu"),
            lambda: ff.fenrir_fused_batch_grad(
                *batch, **obs, model="lorenz", interrogation="schober",
                device="cpu"),
            lambda: fd.dalton_fused_batch(
                *batch, **obs, model="lorenz", interrogation="schober",
                device="cpu"),
            lambda: fd.dalton_fused_batch_grad(
                *batch, **obs, model="lorenz", interrogation="schober",
                device="cpu"),
            lambda: fd.dalton_fused_batch_grad(
                *batch, **obs, model="lorenz", interrogation="chkrebtii",
                device="cpu")):
        with pytest.raises(NotImplementedError):
            call()
    _, ccfg, _ = _chkrebtii_cfgs(4)
    args = dict(ode_weight=ccfg["ode_weight"], t_min=0.0, t_max=10.0,
                n_steps=40, prior_pars=ccfg["prior_pars"], model="chkrebtii",
                device="cpu")
    c_obs = dict(obs_data=torch.zeros((3, 1, 1)),
                 obs_times=torch.tensor([0.0, 5.0, 10.0]),
                 obs_weight=torch.zeros((3, 1, 1, 4)),
                 obs_var=torch.ones((3, 1, 1, 1)))
    c_inits = ccfg["ode_init"].expand(2, 1, 4)
    # Chkrebtii's ODE has no parameter: its gradient is exactly zero
    _, c_grad = fd.dalton_fused_batch_grad(torch.zeros((2, 1)),
                                           ode_inits=c_inits, **c_obs,
                                           **args)
    assert c_grad.shape == (2, 1) and (c_grad == 0).all()
    hcfg = thes1.setup(n_steps=40, t_max=60.0, dtype=torch.float32,
                       device="cpu")
    h_obs = dict(obs_data=torch.zeros((3, 3, 1)),
                 obs_times=torch.tensor([0.0, 30.0, 60.0]),
                 obs_weight=torch.zeros((3, 3, 1, 3)),
                 obs_var=torch.ones((3, 3, 1, 1)))
    h_ll, h_grad = fd.dalton_fused_batch_grad(
        hcfg["theta"].expand(2, 7), hcfg["ode_weight"],
        hcfg["ode_init"].expand(2, 3, 3), 0.0, 60.0, 40,
        hcfg["prior_pars"], **h_obs, model="hes1", device="cpu")
    assert torch.isfinite(h_ll).all() and h_grad.shape == (2, 7)
    # FitzHugh-Nagumo padded past its third derivative: q = 6 is no
    # instance of the tangent filter nor of DALTON's filters (K11a, K8 and
    # K11c hold q <= 5)
    fcfg = tfitzhugh.setup(n_steps=40, t_max=2.0, dtype=torch.float32,
                           device="cpu", n_deriv=6)
    f_obs = dict(obs_data=torch.zeros((3, 2, 1)),
                 obs_times=torch.tensor([0.0, 1.0, 2.0]),
                 obs_weight=torch.zeros((3, 2, 1, 6)),
                 obs_var=torch.ones((3, 2, 1, 1)))
    f_args = (fcfg["theta"].expand(2, 3), fcfg["ode_weight"],
              fcfg["ode_init"].expand(2, 2, 6), 0.0, 2.0, 40,
              fcfg["prior_pars"])
    with pytest.raises(NotImplementedError, match="the filter_batch_tan"):
        ff.fenrir_fused_batch_grad(*f_args, **f_obs, model="fitzhugh",
                                   device="cpu")
    with pytest.raises(NotImplementedError,
                       match="the dalton_filter_batch_tan"):
        fd.dalton_fused_batch_grad(*f_args, **f_obs, model="fitzhugh",
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="the dalton_filter_batch "):
        fd.dalton_fused_batch(*f_args, **f_obs, model="fitzhugh",
                              device="cpu")
    with pytest.raises(NotImplementedError, match="mean_"):
        rt.solve_mv_fused_stationary(torch.zeros(1),
                                     ode_init=ccfg["ode_init"], **args)
    with pytest.raises(NotImplementedError, match="mean_"):
        rt.solve_mv_fused_stationary(
            hcfg["theta"], hcfg["ode_weight"], hcfg["ode_init"], 0.0, 60.0,
            40, hcfg["prior_pars"], model="hes1", device="cpu")
