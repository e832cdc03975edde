"""
The lane-batched draws at the instances that K6 took last (q = 4 and 5,
the models Chkrebtii, Hes1 and SEIRAH), on the CPU, against the JAX
package: ``solve_sim_fused_batch`` (K1, K6) fed the JAX function's own
standard normals (its key split as ``pallas_sim.py`` splits it) on the
cases of ``tests/coverage_value_cases.py``, each derivative within
SCALED_TOL = 1e-4 of its largest entry (Q5_TOL at q = 5), or within 3 x
the JAX package's own float32 noise there where that exceeds it (the move
of its draws under a one-ulp step of every theta, or of every x0 entry on
Chkrebtii's ODE, as tests/test_torch_sim.py holds Lorenz63's: on Hes1 under
kramer 2.0e-4 of the largest entry in x' and 3.6e-3 in x''); K6's twin at
q = 4 and 5 against the Pallas kernel it replaces, interpret mode; and the
lockstep random walk (K1 and K6 a step) over Chkrebtii's ODE at q = 4 and
5.
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
from rodeo_tpu.ops import pallas_sim as ps

from rodeo_tpu_torch.models import chkrebtii as tchk
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_sim as fs
from rodeo_tpu_torch.parallel import make_chain_runner


@pytest.mark.parametrize("name", sorted(cv.CASES))
def test_solve_sim_matches_jax(name):
    """The port's draws against the JAX package's on the same normals: in
    one JAX call of the case's lanes, or one a lane (Hes1 and SEIRAH under
    kramer), each drawing the normals of its one-lane key."""
    c = cv.case(name)
    args, kw, _ = cv.port_args(c)
    key = jax.random.PRNGKey(41)
    common = cv.jax_common(c)
    fn = jax.jit(lambda ts, x0: ps.solve_sim_fused_batch(
        key, thetas=ts, ode_inits=x0, interrogation=c["mode"], **common))
    ref = cv.jax_lanes(c, fn)
    ulp = "inits" if c["model"] == "chkrebtii" else "thetas"
    moved = np.nextafter(c[ulp], np.float32(np.inf))
    noise = cv.jax_lanes({**c, ulp: moved}, fn)
    nb, q = c["inits"].shape[1:]
    n_key = 1 if c["per_lane"] else cv.N_LANE
    key_path, key_term = jax.random.split(key)
    eps = np.array(jax.random.normal(
        key_path, (cv.N_STEPS - 1, q, nb, n_key), jnp.float32))
    eps_term = np.array(jax.random.normal(key_term, (q, nb, n_key),
                                          jnp.float32))
    if c["per_lane"]:
        eps = np.repeat(eps, cv.N_LANE, axis=-1)
        eps_term = np.repeat(eps_term, cv.N_LANE, axis=-1)
    before = dict(fs.LAUNCHES)
    port = fs.solve_sim_fused_batch(*args, **kw, eps=eps, eps_term=eps_term)
    assert fs.LAUNCHES == before              # the CPU takes the twins
    assert port.shape == ref.shape == (cv.N_STEPS + 1, nb, q, cv.N_LANE)
    assert torch.isfinite(port).all()
    for d in range(q):
        floor = cv.scaled_err(noise[..., d, :], ref[..., d, :])
        assert cv.scaled_err(port[..., d, :], ref[..., d, :]) <= \
            max(cv.tol(name), 3 * floor), d


@pytest.mark.parametrize("q", [4, 5])
def test_sampler_twin_matches_pallas_at_q45(q):
    """K6's twin against ``_sampler_kernel_batch`` on seeded rows at q = 4
    and 5: 150 steps over 3 blocks x 4 lanes."""
    rng = np.random.default_rng(30 + q)
    T, nb, B = 150, 3, 4
    G = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
        0.1 * rng.standard_normal((T, q * q, nb, B))
    args = [np.ascontiguousarray(a, np.float32) for a in (
        rng.standard_normal((T, q, nb, B)), G,
        rng.standard_normal((q, nb, B)))]
    vmem = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: tuple([0] * len(shape)), memory_space=pltpu.VMEM)
    ref = pl.pallas_call(
        functools.partial(ps._sampler_kernel_batch, T, q, nb, B),
        out_shape=jax.ShapeDtypeStruct((T, q, nb, B), jnp.float32),
        grid=(1,),
        in_specs=[vmem((T, q, nb, B)), vmem((T, q * q, nb, B)),
                  vmem((q, nb, B))],
        out_specs=vmem((T, q, nb, B)),
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32)],
        interpret=True)(*args)
    port = fs.sampler_batch(*map(torch.from_numpy, args))
    assert port.shape == (T, q, nb, B)
    assert cv.scaled_err(port, ref) <= cv.SCALED_TOL


@pytest.mark.parametrize("q", [4, 5])
def test_random_walk_takes_chkrebtii_ode(q):
    """The lockstep random walk over draws (K1 and K6 a step) on
    Chkrebtii's ODE at q = 4 and 5: 4 chains x 3 steps, each chain's
    position scaling x0, its likelihood x's Gaussian fit to the setup's
    solve at 5 steps; positions and estimates finite, the twins on the
    CPU."""
    n_steps = 20
    cfg = tchk.setup(n_steps=n_steps, dtype=torch.float32, device="cpu",
                     n_deriv=q)
    mean, _ = fk.solve_mv_fused_batch(
        torch.zeros((1, 1)), cfg["ode_weight"], cfg["ode_init"][None], 0.0,
        cfg["t_max"], n_steps, cfg["prior_pars"], "chkrebtii", device="cpu")
    idx = torch.arange(0, n_steps + 1, 5)
    data = mean[idx, 0, 0, 0]

    def loglik(positions, paths):
        return -0.5 * torch.sum((paths[idx, 0, 0] - data[:, None]) ** 2
                                / cv.OBS_VAR, dim=0) \
            - 0.5 * positions[:, 0] ** 2

    runner = make_chain_runner(
        loglik, 4, 3, 0.01, cfg["ode_weight"], cfg["ode_init"], 0.0,
        cfg["t_max"], n_steps, cfg["prior_pars"], "chkrebtii",
        position_to_init=lambda p: cfg["ode_init"] * (1 + p[:, :, None]),
        device="cpu")
    before = dict(fs.LAUNCHES)
    pos, ld, acc = runner(torch.zeros((4, 1)),
                          torch.Generator().manual_seed(q))
    assert fs.LAUNCHES == before
    assert pos.shape == (3, 4, 1) and ld.shape == (4,)
    assert torch.isfinite(pos).all() and torch.isfinite(ld).all()
    assert ((acc >= 0) & (acc <= 1)).all()
