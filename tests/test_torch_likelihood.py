"""
Parity of the port's lane-batched likelihoods (rodeo_tpu_torch.ops:
fused_fenrir, fused_dalton, basic_fused_batch, and the observation grid)
with the JAX package's Pallas path, which runs here in interpret mode.

On the CPU the port's wrappers take the plain PyTorch twins of the CUDA
kernels, so these tests pin the twins of K7b (fenrir_backward_batch) and K8
(dalton_filter_batch) to the Pallas kernels they replace, fed identical
inputs, and each entry point to its JAX counterpart end to end.  Both sides
work in float32 and add in different orders (XLA fuses and reorders; the
port's K7b sums each block on its own).  Measured over these runs:

- arrays: up to 5.1e-5 of the largest entry (basic's posterior mean on
  Lorenz63); the tolerance is SCALED_TOL = 1e-4;
- a fenrir or basic log-likelihood: <= 3.4e-7 relative; tolerance 1e-4;
- a DALTON log-likelihood, the difference of two float32 sums over every
  step: <= 2.2e-6 relative; tolerance 1e-3;
- one launch of K8 or K7b (a log-density sum): <= 4.9e-7 relative;
  tolerance 1e-5.
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

from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops.obs_grid import dense_obs_grid, obs_indices

SCALED_TOL = 1e-4
LOGLIK_RTOL = 1e-4
DALTON_RTOL = 1e-3
KERNEL_LD_RTOL = 1e-5
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}
# the sizes of these tests: (model, interrogation, n_steps, t_max, n_obs)
CASES = [("lorenz", "kramer", 200, 2.0, 21),
         ("fitzhugh", "rodeo", 100, 10.0, 11)]


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


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


def _jax_call(fn, prob, model, mode, n_steps, t_max, **kw):
    jmod = JMODELS[model]
    cfg = prob["cfg"]
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    run = jax.jit(lambda ts, x0: fn(
        thetas=ts, ode_weight=cfg["ode_weight"], ode_inits=x0, t_min=0.0,
        t_max=t_max, n_steps=n_steps, prior_pars=cfg["prior_pars"],
        ode_flat=getattr(jmod, f"{model}_flat"), jac_flat=jac, **kw))
    return run(jnp.asarray(prob["thetas"]), jnp.asarray(prob["inits"]))


def _port_args(prob, model, n_steps, t_max):
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    return dict(thetas=torch.from_numpy(prob["thetas"]),
                ode_weight=tcfg["ode_weight"],
                ode_inits=torch.from_numpy(prob["inits"]), t_min=0.0,
                t_max=t_max, n_steps=n_steps, prior_pars=tcfg["prior_pars"],
                model=model, device="cpu")


def _obs(prob, keys=("obs_data", "obs_times", "obs_weight", "obs_var")):
    return {k: prob[k] for k in keys}


# --- the observation grid -----------------------------------------------------------


@pytest.mark.parametrize("n_steps,t_max,n_obs", [
    (4000, 20.0, 21),      # bench.py's likelihood fixture and chip_smoke.py
    (200, 2.0, 21), (100, 10.0, 11),            # this file's entry points
    (120, 1.2, 7), (100, 10.0, 6), (20, 0.2, 2),    # ... and its twins
    (1000, 2.0, 11), (1000, 10.0, 11),          # chip_smoke.py's twin phases
    (300, 0.6, 11), (300, 3.0, 11),             # tests/test_torch_cuda.py
    (800, 10.0, 21), (200, 2.0, 11)])
@pytest.mark.parametrize("time_dtype", [np.float32, np.float64])
def test_obs_indices_are_the_jax_packages(n_steps, t_max, n_obs, time_dtype):
    """torch.linspace rounds differently from jnp.linspace: the port builds
    the grid as JAX does, so every index matches (several of these grids put
    an observation one step off under torch.linspace)."""
    times = np.linspace(0.0, t_max, n_obs).astype(time_dtype)
    ref = jnp.searchsorted(jnp.linspace(0.0, t_max, n_steps + 1),
                           jnp.asarray(times))
    port = obs_indices(0.0, t_max, n_steps, torch.from_numpy(times))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        obs_indices(0.0, t_max, n_steps, times).numpy(), np.asarray(ref))


def test_dense_obs_grid_scatters_the_observations():
    prob = _problem("lorenz", 200, 2.0, 21, 2, seed=0)
    t_vec = torch.tensor([0.5, 0.25, 0.125])
    idx = obs_indices(0.0, 2.0, 200, prob["obs_times"])
    d, y, om, mask = dense_obs_grid(idx, 200, t_vec,
                                    _f32(prob["obs_data"]),
                                    _f32(prob["obs_weight"]),
                                    _f32(prob["obs_var"]))
    jidx = np.asarray(idx)
    assert mask.sum().item() == len(np.unique(jidx))
    np.testing.assert_array_equal(y[jidx].numpy(), prob["obs_data"][..., 0])
    np.testing.assert_array_equal(om[jidx].numpy(),
                                  prob["obs_var"][:, :, 0, 0])
    np.testing.assert_array_equal(
        d[jidx].numpy(),
        np.swapaxes(prob["obs_weight"][:, :, 0, :] * t_vec.numpy(), 1, 2))
    free = np.setdiff1d(np.arange(201), jidx)
    assert (d[free] == 0).all() and (y[free] == 0).all()
    assert (om[free] == 1).all() and (mask[free] == 0).all()


# --- the twins of K7b and K8 against the Pallas kernels -----------------------------


def _chain(n_steps, nb, B, seed):
    """A seeded backward chain (A, b, C), observation grid and seeds."""
    rng = np.random.default_rng(seed)
    q, n_tri = 3, 6
    A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
        0.1 * rng.standard_normal((n_steps, q * q, nb, B))
    b = rng.standard_normal((n_steps, q, nb, B))
    M = 0.3 * rng.standard_normal((n_steps, nb, B, q, q))
    Cfull = M @ np.swapaxes(M, -1, -2)
    pairs, _ = fk._tri_idx(q)
    C = np.stack([Cfull[..., i, j] for i, j in pairs], axis=1)
    mask = (rng.random(n_steps) < 0.3).astype(np.float64)
    d = rng.standard_normal((n_steps, q, nb)) * mask[:, None, None]
    y = rng.standard_normal((n_steps, nb)) * mask[:, None]
    om = np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)), 1.0)
    Mp = rng.standard_normal((nb, B, q, q))
    Pfull = Mp @ np.swapaxes(Mp, -1, -2)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return dict(A=f32(A), b=f32(b), C=f32(C), d=f32(d), y=f32(y),
                om=f32(om), mask=f32(mask),
                m_seed=f32(rng.standard_normal((q, nb, B))),
                p_seed=f32(np.stack([Pfull[..., i, j] for i, j in pairs])),
                ld0=f32(rng.standard_normal(B)))


def _vmem(shape):
    return pl.BlockSpec(shape, lambda i: tuple([0] * len(shape)),
                        memory_space=pltpu.VMEM)


def test_fenrir_backward_twin_matches_pallas():
    n_steps, nb, B, q, n_tri = 160, 3, 4, 3, 6
    ch = _chain(n_steps, nb, B, seed=3)
    kern = functools.partial(pf._fenrir_backward_kernel_batch, n_steps, q,
                             nb, n_tri, B, 1)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_steps, q * q, nb, B)), _vmem((n_steps, q, nb, B)),
                  _vmem((n_steps, n_tri, nb, B)), _vmem((n_steps, q, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1)), _vmem((q, nb, B)),
                  _vmem((n_tri, nb, B)), _vmem((1, B))],
        out_specs=_vmem((1, B)),
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32),
                        pltpu.VMEM((n_tri, nb, B), jnp.float32),
                        pltpu.VMEM((1, B), jnp.float32)],
        interpret=True,
    )(ch["A"], ch["b"], ch["C"], ch["d"][..., None],
      ch["y"][:, None, :, None], ch["om"][:, None, :, None],
      ch["mask"][:, None], ch["m_seed"], ch["p_seed"], ch["ld0"][None])[0]
    port = ff.fenrir_backward_batch(*[torch.from_numpy(ch[k]) for k in (
        "A", "b", "C", "d", "y", "om", "mask", "m_seed", "p_seed", "ld0")])
    assert port.shape == (B,)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               rtol=KERNEL_LD_RTOL)


def _filter_operands(model, mode, n_steps, t_max, n_lane, seed):
    """K1 / K8 operands of a seeded lane batch, as the port builds them."""
    prob = _problem(model, n_steps, t_max, max(n_steps // 20, 2) + 1,
                    n_lane, seed)
    args = _port_args(prob, model, n_steps, t_max)
    ops = fk._kernel_operands(args["thetas"], args["ode_weight"],
                              args["ode_inits"], 0.0, t_max, n_steps,
                              args["prior_pars"])
    _, obs, ld0 = fd._dalton_prepare(
        args["thetas"], args["ode_weight"], args["ode_inits"], 0.0, t_max,
        n_steps, args["prior_pars"], *[torch.as_tensor(prob[k]) for k in (
            "obs_data", "obs_times", "obs_weight", "obs_var")])
    return ops, obs, ld0


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("model,mode,n_steps,t_max", [
    ("lorenz", "kramer", 120, 1.2), ("fitzhugh", "rodeo", 100, 10.0)])
def test_dalton_filter_twin_matches_pallas(model, mode, n_steps, t_max,
                                           with_obs):
    ops, obs, ld0 = _filter_operands(model, mode, n_steps, t_max, 4, seed=5)
    jmod = JMODELS[model]
    q, nb, B = ops["x0_lanes"].shape
    n_tri = 6
    kern = functools.partial(
        pd._dalton_filter_kernel, getattr(jmod, f"{model}_flat"),
        getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None,
        with_obs, n_steps, q, nb, n_tri, B, ops["q_const"], 1)
    pairs, _ = fk._tri_idx(q)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((nb, n_tri)), _vmem((nb, q)), _vmem((q, nb, B)),
                  _vmem((3, B)), _vmem((n_steps, 1)), _vmem((1, q)),
                  _vmem((n_steps, q, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1)),
                  _vmem((1, B))],
        out_specs=_vmem((1, B)),
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32),
                        pltpu.VMEM((n_tri, nb, B), jnp.float32),
                        pltpu.VMEM((1, B), jnp.float32)],
        interpret=True,
    )(fk._pack_tri(ops["prior_var"], pairs).numpy(),
      ops["ode_weight"].numpy(), ops["x0_lanes"].numpy(),
      ops["theta_lanes"].numpy(), ops["tgrid"].numpy()[:, None],
      ops["t_vec"].numpy()[None], obs["d"].numpy()[..., None],
      obs["y"].numpy()[:, None, :, None], obs["om"].numpy()[:, None, :, None],
      obs["mask"].numpy()[:, None], ld0.numpy()[None])[0]
    fd.LAUNCHES["dalton_filter_batch"] = 0
    port = fd.dalton_filter_batch(model, n_steps, **ops, **obs, ld0=ld0,
                                  mode=mode, with_obs=with_obs)
    assert fd.LAUNCHES["dalton_filter_batch"] == 0    # the CPU takes the twin
    assert port.shape == (B,) and torch.isfinite(port).all()
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               rtol=KERNEL_LD_RTOL)


def test_gain_entry_zero_is_the_exact_initial_state():
    """Fenrir's chain ends with K1's entry 0, which maps step 1 onto the
    exact initial state: zero gain, zero noise, offset x0."""
    ops, _, _ = _filter_operands("lorenz", "kramer", 20, 0.2, 3, seed=7)
    G, g, L, _, _ = fk.fused_filter_batch("lorenz", 20, **ops, mode="kramer")
    assert (G[0] == 0).all() and (L[0] == 0).all()
    torch.testing.assert_close(g[0], ops["x0_lanes"], rtol=0, atol=0)


# --- the entry points end to end ----------------------------------------------------


@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_fenrir_fused_batch_matches_jax(model, mode, n_steps, t_max, n_obs):
    prob = _problem(model, n_steps, t_max, n_obs, 4, seed=11)
    ref = _jax_call(pf.fenrir_fused_batch, prob, model, mode, n_steps,
                    t_max, interrogation=mode, **_obs(prob))
    ff.LAUNCHES["fenrir_backward_batch"] = 0
    port = ff.fenrir_fused_batch(**_port_args(prob, model, n_steps, t_max),
                                 **_obs(prob), interrogation=mode)
    assert ff.LAUNCHES["fenrir_backward_batch"] == 0
    assert port.shape == (4,) and torch.isfinite(port).all()
    assert _scaled_err(port, ref) <= LOGLIK_RTOL


@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_dalton_fused_batch_matches_jax(model, mode, n_steps, t_max, n_obs):
    prob = _problem(model, n_steps, t_max, n_obs, 4, seed=12)
    ref = _jax_call(pd.dalton_fused_batch, prob, model, mode, n_steps,
                    t_max, **_obs(prob))
    port = fd.dalton_fused_batch(**_port_args(prob, model, n_steps, t_max),
                                 **_obs(prob), interrogation=mode)
    assert port.shape == (4,) and torch.isfinite(port).all()
    assert _scaled_err(port, ref) <= DALTON_RTOL


def _b_loglik_jax(obs_data, ode_data, **params):
    return jnp.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


def _b_loglik_torch(obs_data, ode_data, **params):
    return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


@pytest.mark.parametrize("model,mode,n_steps,t_max,n_obs", CASES)
def test_basic_fused_batch_matches_jax(model, mode, n_steps, t_max, n_obs):
    prob = _problem(model, n_steps, t_max, n_obs, 4, seed=13)
    ll_j, mean_j = _jax_call(
        pk.basic_fused_batch, prob, model, mode, n_steps, t_max,
        interrogation=mode, obs_data=prob["obs_data"],
        obs_times=prob["obs_times"], obs_loglik=_b_loglik_jax)
    ll_t, mean_t = fk.basic_fused_batch(
        **_port_args(prob, model, n_steps, t_max),
        obs_data=torch.from_numpy(prob["obs_data"]),
        obs_times=prob["obs_times"], obs_loglik=_b_loglik_torch,
        interrogation=mode)
    assert ll_t.shape == (4,) and mean_t.shape == mean_j.shape
    assert _scaled_err(ll_t, ll_j) <= LOGLIK_RTOL
    for d in range(3):
        assert _scaled_err(mean_t[..., d, :], mean_j[..., d, :]) \
            <= SCALED_TOL, d


# --- the closed-form Cholesky -------------------------------------------------------


@pytest.mark.parametrize("case", ["spd", "near_singular"])
def test_chol_cols_matches_jax(case):
    q = 3
    rng = np.random.default_rng(21)
    M = rng.standard_normal((q, q, 7))
    P = np.einsum("ijb,kjb->ikb", M, M) + 0.1 * np.eye(q)[..., None]
    if case == "near_singular":
        # column 2 a copy of column 1: the third pivot floors, and the
        # entries below a floored pivot are zeroed
        v = rng.standard_normal((2, 7))
        P = np.stack([np.stack([v[0] * v[0] + 1, v[0] * v[1], v[0] * v[1]]),
                      np.stack([v[0] * v[1], v[1] * v[1] + 1,
                                v[1] * v[1] + 1]),
                      np.stack([v[0] * v[1], v[1] * v[1] + 1,
                                v[1] * v[1] + 1])])
    pairs, where = fk._tri_idx(q)
    cols = [P[i, j].astype(np.float32) for i, j in pairs]
    ref = pk._chol_cols(q, [jnp.asarray(c) for c in cols], where)
    port = fk._chol_cols(q, [torch.from_numpy(c) for c in cols], where)
    for i in range(q):
        for j in range(i + 1):
            np.testing.assert_allclose(
                port[i][j].numpy(), np.asarray(ref[i][j]), rtol=1e-5,
                atol=1e-6 * np.abs(np.asarray(ref[i][i])).max())
    if case == "near_singular":
        assert (port[2][2].numpy() < 1e-2).all()
    eps = [rng.standard_normal(7).astype(np.float32) for _ in range(q)]
    np.testing.assert_allclose(
        torch.stack(fk._chol_matvec(q, port, [torch.from_numpy(e)
                                              for e in eps])).numpy(),
        np.stack([np.asarray(v) for v in pk._chol_matvec(
            q, ref, [jnp.asarray(e) for e in eps])]), rtol=1e-5, atol=1e-5)
