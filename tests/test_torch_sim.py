"""
Parity of the port's lane-batched posterior sampling
(rodeo_tpu_torch.ops.fused_sim) with the JAX package's Pallas path, which
runs here in interpret mode.

On the CPU the port's wrappers take the plain PyTorch twins of the CUDA
kernels: the twin of K6 (sampler_batch) is pinned to the Pallas kernel it
replaces, fed identical inputs, and solve_sim_fused_batch to its JAX
counterpart fed the JAX function's own standard normals.  Both sides work
in float32 and round differently; measured ~1e-5 of the largest entry over
these runs, the tolerance is SCALED_TOL = 1e-4 of it.
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
from rodeo_tpu.ops import pallas_sim as ps

from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_sim as fs

SCALED_TOL = 1e-4
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def test_sampler_twin_matches_pallas():
    rng = np.random.default_rng(31)
    T, q, nb, B = 150, 3, 3, 4
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
    fs.LAUNCHES["sampler_batch"] = 0
    port = fs.sampler_batch(*map(torch.from_numpy, args))
    assert fs.LAUNCHES["sampler_batch"] == 0      # the CPU takes the twin
    assert port.shape == (T, q, nb, B)
    assert _scaled_err(port, ref) <= SCALED_TOL


def _sim_pair(model, mode, n_steps, t_max, B=4):
    """The JAX sampler's paths for a seeded lane batch, a function that
    redraws them at other thetas with the same key, and the port's paths
    fed the JAX function's standard normals (its key split as
    pallas_sim.py splits it)."""
    jmod = JMODELS[model]
    cfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    theta = np.asarray(cfg.pop("theta"))
    rng = np.random.default_rng(32)
    thetas = (theta[None] * (1 + 0.01 * rng.standard_normal((B, 3)))
              ).astype(np.float32)
    inits = np.ascontiguousarray(np.broadcast_to(
        np.asarray(cfg["ode_init"]), (B,) + cfg["ode_init"].shape),
        np.float32)
    key = jax.random.PRNGKey(7)
    fn = jax.jit(lambda ts, x0: ps.solve_sim_fused_batch(
        key, thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0,
        t_min=0.0, t_max=t_max, n_steps=n_steps,
        prior_pars=cfg["prior_pars"], ode_flat=getattr(jmod, f"{model}_flat"),
        jac_flat=getattr(jmod, f"{model}_jac_flat") if mode == "kramer"
        else None, interrogation=mode))
    jax_at = lambda ts: np.asarray(fn(jnp.asarray(ts), jnp.asarray(inits)))
    nb, q = inits.shape[1:]
    key_path, key_term = jax.random.split(key)
    eps = jax.random.normal(key_path, (n_steps - 1, q, nb, B), jnp.float32)
    eps_term = jax.random.normal(key_term, (q, nb, B), jnp.float32)
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    port = fs.solve_sim_fused_batch(
        torch.from_numpy(thetas), tcfg["ode_weight"],
        torch.from_numpy(inits), 0.0, t_max, n_steps, tcfg["prior_pars"],
        model=model, interrogation=mode, eps=np.array(eps),
        eps_term=np.array(eps_term), device="cpu")
    ref = jax_at(thetas)
    assert port.shape == ref.shape == (n_steps + 1, nb, q, B)
    assert torch.isfinite(port).all()
    return thetas, jax_at, ref, port


@pytest.mark.parametrize("mode", ["kramer", "rodeo"])
def test_solve_sim_fused_batch_matches_jax(mode):
    """FitzHugh-Nagumo at 100 steps on 4 lanes, both interrogations."""
    _, _, ref, port = _sim_pair("fitzhugh", mode, 100, 10.0)
    for d in range(3):
        assert _scaled_err(port[..., d, :], ref[..., d, :]) <= SCALED_TOL, d


def test_solve_sim_fused_batch_lorenz_within_float32_noise():
    """Lorenz63 (prior_sigma 5e7) at 200 steps on 4 lanes.  Its per-step
    conditional covariances are numerically singular in float32: the
    Cholesky's relative pivot floor decides which directions are null, and
    a one-ulp change of theta moves the JAX package's own path by ~1e-3 of
    its largest entry (7e-4 to 2e-3 measured), above SCALED_TOL.  So the
    port is held to that noise: within 3x the JAX path's change under a
    one-ulp step of every theta."""
    thetas, jax_at, ref, port = _sim_pair("lorenz", "kramer", 200, 2.0)
    noise = jax_at(np.nextafter(thetas, np.float32(np.inf)))
    for d in range(3):
        floor = _scaled_err(noise[..., d, :], ref[..., d, :])
        assert floor > SCALED_TOL, d     # the reason for this test's rule
        assert _scaled_err(port[..., d, :], ref[..., d, :]) <= 3 * floor, d


def test_solve_sim_fused_batch_draws_from_its_generator():
    """The same generator state gives the same path; eps and eps_term come
    together or not at all."""
    cfg = tlorenz.setup(n_steps=30, t_max=0.3, device="cpu")
    args = (cfg["theta"].expand(2, 3).contiguous(), cfg["ode_weight"],
            cfg["ode_init"].expand(2, 3, 3).contiguous(), 0.0, 0.3, 30,
            cfg["prior_pars"])
    draws = [fs.solve_sim_fused_batch(
        *args, model="lorenz", device="cpu",
        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    with pytest.raises(ValueError):
        fs.solve_sim_fused_batch(*args, model="lorenz", device="cpu",
                                 eps=torch.zeros(29, 3, 3, 2))
