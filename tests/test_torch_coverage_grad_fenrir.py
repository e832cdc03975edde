"""
Fenrir's gradient at the instances that K11a and K11b took last, on the
CPU: K11b's twin against the JAX package's
``_fenrir_backward_kernel_batch_tan`` (a ``pallas_call`` in interpret
mode) at q = 4 and 5 with 6 and 7 tangent directions, every tangent seed a
nonzero numpy normal, within tests/test_torch_grad.py's SCALED_TOL = 1e-4
of the largest entry of the value and of each direction; and the lockstep
MALA runner over ``fenrir_fused_batch_grad`` on Hes1 under kramer, its
Jacobian on nested Duals, replaying the JAX package's noise
(tests/fused_chains.py's check_lockstep).
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import coverage_value_cases as cv
import fused_chains as fc
import mcmc_replay
from rodeo_tpu.models import hes1 as jhes1
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.parallel import chains as jc

from rodeo_tpu_torch.models import hes1 as thes1
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.parallel import chains as tc

SCALED_TOL = 1e-4


@pytest.mark.parametrize("q,n_tan", [(4, 6), (4, 7), (5, 6), (5, 7)])
def test_fenrir_backward_tan_twin_matches_pallas(q, n_tan):
    """K11b's twin against a pallas_call of
    _fenrir_backward_kernel_batch_tan on a seeded augmented chain at q = 4
    and 5 with 6 and 7 directions, 30 steps over 3 blocks x 4 lanes."""
    n_steps, nb, B = 30, 3, cv.N_LANE
    n_aug, n_tri = 1 + n_tan, q * (q + 1) // 2
    ch = cv.tan_chain(q, n_tan, n_steps, nb, B, seed=10 * q + n_tan)
    kern = functools.partial(pf._fenrir_backward_kernel_batch_tan, n_tan,
                             n_steps, q, nb, n_tri, B)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n_aug, B), jnp.float32),
        grid=(1,),
        in_specs=[cv.vmem((n_steps, n_aug * q * q, nb, B)),
                  cv.vmem((n_steps, n_aug * q, nb, B)),
                  cv.vmem((n_steps, n_aug * n_tri, nb, B)),
                  cv.vmem((n_steps, q, nb, 1)), cv.vmem((n_steps, 1, nb, 1)),
                  cv.vmem((n_steps, 1, nb, 1)), cv.vmem((n_steps, 1)),
                  cv.vmem((n_aug * q, nb, B)), cv.vmem((n_aug * n_tri, nb, B)),
                  cv.vmem((n_aug, B))],
        out_specs=cv.vmem((n_aug, B)),
        scratch_shapes=[pltpu.VMEM((n_aug * q, nb, B), jnp.float32),
                        pltpu.VMEM((n_aug * n_tri, nb, B), jnp.float32),
                        pltpu.VMEM((n_aug, B), jnp.float32)],
        interpret=True,
    )(ch["A"], ch["b"], ch["C"], ch["d"][..., None],
      ch["y"][:, None, :, None], ch["om"][:, None, :, None],
      ch["mask"][:, None], ch["m_seed"], ch["p_seed"], ch["ld0"])
    ff.LAUNCHES["fenrir_backward_batch_tan"] = 0
    port = ff.fenrir_backward_batch_tan(*[torch.from_numpy(ch[k]) for k in (
        "A", "b", "C", "d", "y", "om", "mask", "m_seed", "p_seed", "ld0")])
    assert ff.LAUNCHES["fenrir_backward_batch_tan"] == 0
    assert port.shape == (n_aug, B) and torch.isfinite(port).all()
    for a in range(n_aug):
        assert cv.tan_err(port[a], ref[a]) <= SCALED_TOL, a



def test_mala_over_fenrir_on_hes1_replays_jax():
    """The lockstep MALA runner over fenrir_fused_batch_grad on Hes1 (K11a,
    K11b on the CPU's twins; EK1, its Jacobian on nested Duals), 8 lanes x
    5 steps from theta x (1 + 0.01 normals) at a step of 1e-4, against the
    JAX package's run_chains_mala_fused from the same key (its Jacobian
    jvp_jac_flat's, one jax.jvp per block on lane-wide seeds): the same
    accept decisions, positions and log-densities (tests/fused_chains.py's
    check_lockstep)."""
    c = cv.case("hes1_kramer")
    n_lane, n_samp, step = 8, 5, 1e-4
    theta = np.asarray(thes1.THETA, np.float32)
    init = (theta * (1 + 0.01 * np.random.default_rng(11).standard_normal(
        (n_lane, theta.shape[0])))).astype(np.float32)
    jcfg, tcfg = c["jcfg"], c["tcfg"]
    common = dict(t_min=0.0, t_max=c["t_max"], n_steps=cv.N_STEPS)
    jkw = dict(ode_weight=jcfg["ode_weight"], ode_init=jcfg["ode_init"],
               prior_pars=jcfg["prior_pars"], ode_flat=jhes1.hes1_flat,
               jac_flat=cv.jac_lanes(jhes1.hes1_flat, 3, 3), **common,
               **{k: jnp.asarray(v) for k, v in c["obs"].items()})
    tkw = dict(ode_weight=tcfg["ode_weight"], ode_init=tcfg["ode_init"],
               prior_pars=tcfg["prior_pars"], model="hes1", device="cpu",
               **common, **c["obs"])
    key = jax.random.PRNGKey(3)
    ref = jc.run_chains_mala_fused(jnp.asarray(init), key,
                                   n_samples=n_samp, step_size=step,
                                   likelihood="fenrir", **jkw)
    noise = mcmc_replay.mala_or_hmc(key, n_samp, init, n_lane, "xi")
    port = tc.run_chains_mala_fused(torch.from_numpy(init), None,
                                    n_samples=n_samp, step_size=step,
                                    likelihood="fenrir", noise=noise, **tkw)
    lpg = tc._fused_theta_logpost_grad(
        "fenrir", n_lane, tkw["ode_weight"], tkw["ode_init"], 0.0,
        c["t_max"], cv.N_STEPS, tkw["prior_pars"], tkw["obs_data"],
        tkw["obs_times"], tkw["obs_weight"], tkw["obs_var"], "hes1", None,
        "cpu")
    eps = tc._step_size(torch.from_numpy(init), step, torch.device("cpu"))

    def margin_at(s, lane):
        pos = port[0][s - 1] if s else torch.from_numpy(init)
        ll, g = lpg(pos)
        draw = torch.from_numpy(noise["xi"][s])
        ratio = tc._mala_proposal(lpg, eps, pos, ll, g, draw)[3]
        return abs(np.log(noise["u"][s][lane]) - float(ratio[lane]))

    fc.check_lockstep(port, ref, init, margin_at)
