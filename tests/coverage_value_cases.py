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
"""
import numpy as np
import torch
import jax.numpy as jnp

from rodeo_tpu.models import chkrebtii as jchk, hes1 as jhes1
from rodeo_tpu.models import seirah as jseirah
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.prior import ibm_init as j_ibm_init

from rodeo_tpu_torch.models import chkrebtii as tchk, hes1 as thes1
from rodeo_tpu_torch.models import seirah as tseirah
from rodeo_tpu_torch.ops import fused_kalman as fk

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
            "seirah": (jseirah, tseirah)}


def tol(name, rtol=SCALED_TOL, q5_tol=Q5_TOL):
    """The tolerance of case ``name``: ``rtol``, or ``q5_tol`` at q = 5."""
    return q5_tol if CASES[name][1] == 5 else rtol


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
    normals; the others scale theta by 1 + 0.01 x normals."""
    model, q, mode = CASES[name]
    jmod, tmod = _MODULES[model]
    rng = np.random.default_rng(seed)
    if model == "chkrebtii":
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
