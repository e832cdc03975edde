"""
The twins of the single-solve filter K3, of the smoother rows K2r, of the
single-solve smoother K4, of fenrir's backward filter K7b and its tangent
twin K11b, of non-Gaussian DALTON's filter K9, of MAGI's filter K10a and
its adjoint K10b and of the stationary solve's mean chain K5b against the
JAX package at the edges that the kernels' designs have to mask, with the
JAX package's Pallas kernels in interpret mode.

K2r, K7b and K11b stream their operands through a ring of shared-memory
stages of a few steps each (``csrc/stream_ring.cuh``), in CTAs of 32
columns: their last stage holds fewer steps than the others when the step
count is no multiple of the stage's, and their last CTA fewer columns than
32 when the (block, lane) columns are no multiple of 32.  So
``_smoother_batch_rows_plain`` is held to ``_smoother_kernel_batch_rows``
at 1, 2, 5 and 9 interior steps over 3 blocks of 37 lanes (111 columns),
``_fenrir_backward_plain`` with its skip (K7b's twin) to
``_fenrir_backward_kernel_batch`` at 1, 2, 5 and 9 steps over the same 111
columns, with data at some steps and at none, and
``_fenrir_backward_tan_plain`` to ``_fenrir_backward_kernel_batch_tan``
at 1, 2, 5 and 9 steps over the same 111 columns, with 1 and 3 tangent
directions (one consumer warp each), on a grid with steps with data and
without (the twins, like K7b and K11b, skip the update at the latter).  K9
runs one thread per (lane, block) in CTAs of a few lanes, the last lanes
masked; ``_filter_nn_batch_plain`` is held to ``_filter_nn_kernel_batch``
at 1 and 2 steps over 37 lanes, Lorenz63 with Gaussian data and
FitzHugh-Nagumo with Poisson counts, EK1 and EK0 each.  K10a streams x
forward through the same ring in CTAs of 32 columns, its last stage holding
the steps left over; ``_magi_batch_plain`` is held to
``_magi_kernel_batch`` at 1, 2, 5 and 9 steps over 3 blocks of 37 lanes,
n_active 1, 2 and 3, in both emits.  K10b streams K10a's adjoint
streams backward through the same ring, the last step's stage first, so
``_magi_adjoint_batch_plain`` is held to ``_magi_adjoint_kernel_batch`` at
1, 2, 5 and 9 steps over the same 3 blocks of 37 lanes, n_active 1, 2 and
3 (no G stream at 3), on the streams of K10a's twin.  K5b runs one thread
per block of its solve through n_group groups of k_group steps, storing
each group's entry state; ``_mean_boundary_plain`` is held to
``_mean_boundary_kernel`` at 1, 2 and 3 groups of 1, 5 and 64 steps,
Lorenz63 EK1 and FitzHugh-Nagumo EK0 (3 and 2 blocks).  K5c runs a
thread per (group, block), 8 groups a warp, and K5a a thread per block fed
through a ring of stages; ``_mean_recovery_plain`` is held to
``_mean_recovery_kernel`` at 1 and 3 groups of 1, 5 and 64 steps, and
``_mean_gain_plain`` to ``_mean_gain_kernel`` at 1, 2, 5, 64 and 129
steps, on both models.  K4 streams
slabs of 16 rows of the single layout (T, NB, D) through the same ring, the
top stage holding the rows left over, in CTAs of 5 blocks, each block's row
spread over 6 lanes; ``_smoother_single_plain`` is held to
``_smoother_recursion_kernel`` at 1, 2, 5, 9 and 17 rows for 1, 3 and 7
blocks (7: two CTAs, the second of 2 blocks).  K3 runs one thread per
block, the threads meeting once a step; ``_filter_single_plain`` is held to
``_filter_kernel`` at 1 and 2 steps, Lorenz63 EK1 and FitzHugh-Nagumo EK0.
The card then runs the kernels at the same shapes against these twins
(``tests/test_torch_cuda.py``).  Both sides work in float32 and round
differently (XLA contracts and reorders), so arrays are held to SCALED_TOL
= 1e-4 of their largest entry, as in ``tests/test_torch_single.py``.
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
from rodeo_tpu.ops import pallas_daltonng as jd
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.ops import pallas_kalman as pk
from rodeo_tpu.ops import pallas_magi as pm

from rodeo_tpu_torch.models import fitzhugh as tfitzhugh, lorenz as tlorenz
from rodeo_tpu_torch.models import obs as tobs
from rodeo_tpu_torch.ops import fused_daltonng as fdn
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_magi as fm

SCALED_TOL = 1e-4
JMODELS = {"lorenz": jlorenz, "fitzhugh": jfitzhugh}
TMODELS = {"lorenz": tlorenz, "fitzhugh": tfitzhugh}


def _scaled_err(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref).max() / np.abs(ref).max()


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _vmem(shape):
    return pl.BlockSpec(shape, lambda i: tuple([0] * len(shape)),
                        memory_space=pltpu.VMEM)


def _psd(rng, shape, q, scale=1.0):
    """Packed symmetric positive semi-definite matrices M M' of ``shape``,
    packed on a new last axis."""
    pairs, _ = fk._tri_idx(q)
    M = scale * rng.standard_normal(shape + (q, q))
    full = M @ np.swapaxes(M, -1, -2)
    return np.stack([full[..., i, j] for i, j in pairs], axis=-1)


@pytest.mark.parametrize("n_len", [1, 2, 5, 9])
def test_smoother_rows_twin_matches_pallas_at_ragged_shapes(n_len):
    """Seeded gains, 3 blocks x 37 lanes; n_len interior rows."""
    rng = np.random.default_rng(20 + n_len)
    q, nb, B = 3, 3, 37
    pairs, _ = fk._tri_idx(q)
    G = 0.3 * rng.standard_normal((n_len, q * q, nb, B))
    M = rng.standard_normal((n_len, nb, B, q, q))
    Lfull = M @ np.swapaxes(M, -1, -2)
    Mp = rng.standard_normal((nb, B, q, q))
    Pfull = Mp @ np.swapaxes(Mp, -1, -2)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    args = [f32(a) for a in (
        rng.standard_normal((n_len, q, nb, B)), G,
        np.stack([Lfull[..., i, j] for i, j in pairs], axis=1),
        rng.standard_normal((q, nb, B)),
        np.stack([Pfull[..., i, j] for i, j in pairs]),
        rng.standard_normal((q, nb, B)))]
    m_scales = f32([0.5, 0.25, 0.125])
    p_scales = f32([m_scales[i] * m_scales[j] for i, j in pairs])
    mean_j, cov_j = pk.smoother_recursion_batch_rows(
        *map(jnp.asarray, args), 1, m_scales, p_scales, interpret=True)
    mean_t, cov_t = fk._smoother_batch_rows_plain(
        *map(torch.from_numpy, args), torch.from_numpy(m_scales),
        torch.from_numpy(p_scales))
    assert mean_t.shape == mean_j.shape == (n_len + 2, nb, q, B)
    assert cov_t.shape == cov_j.shape == (n_len + 2, nb, len(pairs), B)
    assert _scaled_err(mean_t, mean_j) <= SCALED_TOL
    assert _scaled_err(cov_t, cov_j) <= SCALED_TOL


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.02),
                                              ("fitzhugh", "rodeo", 0.1)])
def test_filter_single_twin_matches_pallas_at_few_steps(model, mode, t_max,
                                                        n_steps):
    """One solve at the model's theta perturbed by 1 %, 1 and 2 steps."""
    jmod = JMODELS[model]
    jcfg = jmod.setup(n_steps=n_steps, t_max=t_max, dtype=jnp.float32)
    rng = np.random.default_rng(30 + n_steps)
    theta = np.asarray(jcfg["theta"])
    theta = (theta * (1 + 0.01 * rng.standard_normal(3))).astype(np.float32)
    tcfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                                dtype=torch.float32, device="cpu")
    ops, _ = fk._single_operands(torch.from_numpy(theta),
                                 tcfg["ode_weight"], tcfg["ode_init"], 0.0,
                                 t_max, n_steps, tcfg["prior_pars"])
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    run = jax.jit(lambda Qs, R, W, x0, th, tg, tv: pk.fused_filter(
        getattr(jmod, f"{model}_flat"), jac, n_steps, Qs, R, W, x0,
        th[:, None], tg, tv, raw_q_const=ops["q_const"], mode=mode,
        interpret=True))
    Qs = np.broadcast_to(np.asarray(ops["q_const"], np.float32),
                         (jmod.N_VARS, 3, 3))
    ref = run(Qs, *(np.asarray(ops[k]) for k in (
        "prior_var", "ode_weight", "x0", "theta", "tgrid", "t_vec")))
    port = fk._filter_single_plain(fk.resolve_model(model), n_steps, **ops,
                                   mode=mode)
    for name, a, b in zip(["mf", "pf", "mp", "pp"], port, ref):
        assert a.shape == b.shape == (n_steps, jmod.N_VARS, a.shape[-1]), name
        assert torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= SCALED_TOL, name


@pytest.mark.parametrize("n_block", [1, 3, 7])
@pytest.mark.parametrize("n_len", [1, 2, 5, 9, 17])
def test_smoother_single_twin_matches_pallas_at_ragged_shapes(n_len,
                                                              n_block):
    """Seeded gains in the single layout (T, NB, D); n_len rows."""
    rng = np.random.default_rng(50 + 3 * n_len + n_block)
    q = 3
    n_tri = q * (q + 1) // 2
    G = np.eye(q).reshape(1, 1, q * q) * 0.5 + \
        0.1 * rng.standard_normal((n_len, n_block, q * q))
    args = [_f32(a) for a in (
        rng.standard_normal((n_len, n_block, q)), G,
        _psd(rng, (n_len, n_block), q), rng.standard_normal((n_block, q)),
        _psd(rng, (n_block,), q))]
    kern = functools.partial(pk._smoother_recursion_kernel, n_len, q,
                             n_block, n_tri)
    ms_j, ps_j = pl.pallas_call(
        kern, out_shape=[
            jax.ShapeDtypeStruct((n_len, n_block, q), jnp.float32),
            jax.ShapeDtypeStruct((n_len, n_block, n_tri), jnp.float32)],
        grid=(1,), in_specs=[_vmem(a.shape) for a in args],
        out_specs=[_vmem((n_len, n_block, q)),
                   _vmem((n_len, n_block, n_tri))],
        scratch_shapes=[pltpu.VMEM((n_block, q), jnp.float32),
                        pltpu.VMEM((n_block, n_tri), jnp.float32)],
        interpret=True)(*args)
    fk.LAUNCHES["smoother_single"] = 0
    ms_t, ps_t = fk.smoother_recursion(*map(torch.from_numpy, args))
    assert fk.LAUNCHES["smoother_single"] == 0    # the CPU takes the twin
    assert ms_t.shape == ms_j.shape and ps_t.shape == ps_j.shape
    assert torch.isfinite(ms_t).all() and torch.isfinite(ps_t).all()
    assert _scaled_err(ms_t, ms_j) <= SCALED_TOL
    assert _scaled_err(ps_t, ps_j) <= SCALED_TOL


@pytest.mark.parametrize("n_tan", [1, 3])
@pytest.mark.parametrize("n_steps", [1, 2, 5, 9])
def test_fenrir_backward_tan_twin_matches_pallas_at_ragged_shapes(n_steps,
                                                                  n_tan):
    """A seeded augmented chain over 3 blocks x 37 lanes, data at steps 0,
    3, 6, ..; the values and each tangent direction on their own."""
    rng = np.random.default_rng(70 + 2 * n_steps + n_tan)
    q, nb, B = 3, 3, 37
    n_tri = q * (q + 1) // 2
    n_aug = 1 + n_tan

    def aug(v, axis):
        return np.concatenate(
            [v] + [0.1 * rng.standard_normal(v.shape) for _ in range(n_tan)],
            axis=axis)

    mask = (np.arange(n_steps) % 3 == 0).astype(np.float64)
    A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
        0.1 * rng.standard_normal((n_steps, q * q, nb, B))
    ch = dict(
        A=aug(A, 1), b=aug(rng.standard_normal((n_steps, q, nb, B)), 1),
        C=aug(np.moveaxis(_psd(rng, (n_steps, nb, B), q, 0.3), -1, 1), 1),
        d=rng.standard_normal((n_steps, q, nb)) * mask[:, None, None],
        y=rng.standard_normal((n_steps, nb)) * mask[:, None],
        om=np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)),
                    1.0),
        mask=mask, m_seed=aug(rng.standard_normal((q, nb, B)), 0),
        p_seed=aug(np.moveaxis(_psd(rng, (nb, B), q), -1, 0), 0),
        ld0=rng.standard_normal((n_aug, B)))
    ch = {k: _f32(v) for k, v in ch.items()}
    kern = functools.partial(pf._fenrir_backward_kernel_batch_tan, n_tan,
                             n_steps, q, nb, n_tri, B)
    ref = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n_aug, B), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_steps, n_aug * q * q, nb, B)),
                  _vmem((n_steps, n_aug * q, nb, B)),
                  _vmem((n_steps, n_aug * n_tri, nb, B)),
                  _vmem((n_steps, q, nb, 1)), _vmem((n_steps, 1, nb, 1)),
                  _vmem((n_steps, 1, nb, 1)), _vmem((n_steps, 1)),
                  _vmem((n_aug * q, nb, B)), _vmem((n_aug * n_tri, nb, B)),
                  _vmem((n_aug, B))],
        out_specs=_vmem((n_aug, B)),
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
        assert _scaled_err(port[a], ref[a]) <= SCALED_TOL, a


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("n_steps", [1, 2, 5, 9])
def test_fenrir_backward_twin_matches_pallas_at_ragged_shapes(n_steps,
                                                              with_obs):
    """K7b's twin, which skips the update at steps without data as K7b does,
    on a seeded chain over 3 blocks x 37 lanes, data at steps 0, 3, 6, ..
    or at none."""
    rng = np.random.default_rng(90 + 2 * n_steps + with_obs)
    q, nb, B = 3, 3, 37
    n_tri = q * (q + 1) // 2
    mask = (np.arange(n_steps) % 3 == 0).astype(np.float64) * with_obs
    A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
        0.1 * rng.standard_normal((n_steps, q * q, nb, B))
    ch = dict(
        A=A, b=rng.standard_normal((n_steps, q, nb, B)),
        C=np.moveaxis(_psd(rng, (n_steps, nb, B), q, 0.3), -1, 1),
        d=rng.standard_normal((n_steps, q, nb)) * mask[:, None, None],
        y=rng.standard_normal((n_steps, nb)) * mask[:, None],
        om=np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)),
                    1.0),
        mask=mask, m_seed=rng.standard_normal((q, nb, B)),
        p_seed=np.moveaxis(_psd(rng, (nb, B), q), -1, 0),
        ld0=rng.standard_normal(B))
    ch = {k: _f32(v) for k, v in ch.items()}
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
    ff.LAUNCHES["fenrir_backward_batch"] = 0
    port = ff.fenrir_backward_batch(*[torch.from_numpy(ch[k]) for k in (
        "A", "b", "C", "d", "y", "om", "mask", "m_seed", "p_seed", "ld0")])
    assert ff.LAUNCHES["fenrir_backward_batch"] == 0
    assert port.shape == (B,) and torch.isfinite(port).all()
    if not with_obs:
        # no data, no log-density: the seed's term alone
        assert torch.equal(port, torch.from_numpy(ch["ld0"]))
    assert _scaled_err(port, ref) <= SCALED_TOL


@pytest.mark.parametrize("emit", ["ld", "adjoint"])
@pytest.mark.parametrize("act", [1, 2, 3])
@pytest.mark.parametrize("n_steps", [1, 2, 5, 9])
def test_magi_twin_matches_pallas_at_ragged_shapes(n_steps, act, emit):
    """K10a's twin on seeded paths over 3 blocks x 37 lanes (the Lorenz63
    prior's process noise x 1e-5, dt = 0.005, as in the MAGI tests), each
    block's log-density sum added in block order by the wrapper against the
    Pallas kernel's blocks added at every step, and in the adjoint emit its
    streams z, S^{-1} and G, each within SCALED_TOL."""
    rng = np.random.default_rng(170 + 10 * n_steps + act)
    q, nb, B, dt = 3, 3, 37, 0.005
    n_tri, n_tri_a = q * (q + 1) // 2, act * (act + 1) // 2
    wgt, var = tlorenz.setup(n_steps=n_steps, t_max=dt * n_steps,
                             dtype=torch.float32, device="cpu")["prior_pars"]
    paths = torch.tensor(rng.standard_normal((B, n_steps + 1, nb, q)),
                         dtype=torch.float32)
    q_const, _, R, x, m0 = fm._magi_operands(paths, act, (wgt, var * 1e-5),
                                             dt, None)
    kern = functools.partial(pm._magi_kernel_batch, n_steps, q, act, nb,
                             n_tri, q_const, emit, 1)
    dims = (act, n_tri_a) + (((q - act) * act,) if q > act else ())
    streams = dims if emit == "adjoint" else ()
    ref = pl.pallas_call(
        kern,
        out_shape=[jax.ShapeDtypeStruct((1, B), jnp.float32)] + [
            jax.ShapeDtypeStruct((n_steps, d, nb, B), jnp.float32)
            for d in streams],
        grid=(1,),
        in_specs=[_vmem((n_steps, act, nb, B)), _vmem((n_tri, nb, 1)),
                  _vmem((q, nb, B))],
        out_specs=[_vmem((1, B))] + [_vmem((n_steps, d, nb, B))
                                     for d in streams],
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32),
                        pltpu.VMEM((n_tri, nb, B), jnp.float32),
                        pltpu.VMEM((1, B), jnp.float32)],
        interpret=True,
    )(x.numpy(), R.numpy(), m0.numpy())
    fm.LAUNCHES["magi_batch"] = 0
    port = fm.magi_filter_batch(x, R, m0, q_const, emit=emit)
    assert fm.LAUNCHES["magi_batch"] == 0
    port = (port,) if emit == "ld" else port
    assert len(port) == 1 + len(streams)
    assert port[0].shape == (B,) and torch.isfinite(port[0]).all()
    assert _scaled_err(port[0], ref[0][0]) <= SCALED_TOL
    for a, b in zip(port[1:], ref[1:]):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _scaled_err(a, b) <= SCALED_TOL


@pytest.mark.parametrize("act", [1, 2, 3])
@pytest.mark.parametrize("n_steps", [1, 2, 5, 9])
def test_magi_adjoint_twin_matches_pallas_at_ragged_shapes(n_steps, act):
    """K10b's twin on the streams of K10a's twin (seeded paths over 3
    blocks x 37 lanes, the Lorenz63 prior's process noise x 1e-5, dt =
    0.005), against the Pallas adjoint kernel on the same streams: the
    gradient in the active rows of every step and in the seed row, each
    within SCALED_TOL."""
    rng = np.random.default_rng(230 + 10 * n_steps + act)
    q, nb, B, dt = 3, 3, 37, 0.005
    wgt, var = tlorenz.setup(n_steps=n_steps, t_max=dt * n_steps,
                             dtype=torch.float32, device="cpu")["prior_pars"]
    paths = torch.tensor(rng.standard_normal((B, n_steps + 1, nb, q)),
                         dtype=torch.float32)
    q_const, _, R, x, m0 = fm._magi_operands(paths, act, (wgt, var * 1e-5),
                                             dt, None)
    _, *streams = fm.magi_filter_batch(x, R, m0, q_const, emit="adjoint")
    if act == q:
        streams.append(None)
    present = [t.numpy() for t in streams if t is not None]
    ref = pl.pallas_call(
        functools.partial(pm._magi_adjoint_kernel_batch, n_steps, q, act, nb,
                          q_const),
        out_shape=[jax.ShapeDtypeStruct((n_steps, act, nb, B), jnp.float32),
                   jax.ShapeDtypeStruct((q, nb, B), jnp.float32)],
        grid=(1,),
        in_specs=[_vmem(a.shape) for a in present],
        out_specs=[_vmem((n_steps, act, nb, B)), _vmem((q, nb, B))],
        scratch_shapes=[pltpu.VMEM((q, nb, B), jnp.float32)],
        interpret=True,
    )(*present)
    fm.LAUNCHES["magi_adjoint_batch"] = 0
    port = fm.magi_adjoint_batch(*streams, q_const)
    assert fm.LAUNCHES["magi_adjoint_batch"] == 0
    for name, a, b in zip(["gx", "lam0"], port, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= SCALED_TOL, name


@functools.lru_cache(maxsize=None)
def _mean_chain_operands(model, mode, dt):
    """The mean chain's operands as the stationary path builds them (the
    port's CPU path): a 64-step exact prefix through K3's twin, its frozen
    gain, and a 192-step tail after it."""
    n = 64 + 192
    cfg = TMODELS[model].setup(n_steps=n, t_max=dt * n, dtype=torch.float32,
                               device="cpu")
    ops, _ = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                 cfg["ode_init"], 0.0, dt * n, n,
                                 cfg["prior_pars"])
    fused = fk.resolve_model(model)
    mfw, _, _, ppw = fk.fused_filter(
        fused, 64, **{**ops, "tgrid": ops["tgrid"][:64]}, mode=mode)
    k_star = fk._stationary_gains(fused, ops, ppw, mode, 0.0)[-1]
    return fused, ops, mfw[-1], k_star, ops["tgrid"][64:]


@pytest.mark.parametrize("k_group", [1, 5, 64])
@pytest.mark.parametrize("n_group", [1, 2, 3])
@pytest.mark.parametrize("model,mode,dt", [("lorenz", "kramer", 0.01),
                                           ("fitzhugh", "rodeo", 0.05)])
def test_mean_boundary_twin_matches_pallas_at_group_shapes(model, mode, dt,
                                                           n_group, k_group):
    """K5b's twin against the Pallas boundary kernel (a grid step a group)
    on n_group groups of k_group steps of the stationary path's tail,
    Lorenz63 EK1 (3 blocks) and FitzHugh-Nagumo EK0 (2): each group's entry
    state within SCALED_TOL, the first the chain's start exactly."""
    fused, ops, m0, k_star, tail = _mean_chain_operands(model, mode, dt)
    tgrid = tail[:n_group * k_group]
    n_block, q = m0.shape
    th = ops["theta"][:, None].numpy()
    ref = pl.pallas_call(
        functools.partial(pk._mean_boundary_kernel,
                          getattr(JMODELS[model], f"{model}_flat"), k_group,
                          q, n_block, ops["q_const"]),
        out_shape=jax.ShapeDtypeStruct((n_group, n_block, q), jnp.float32),
        grid=(n_group,),
        in_specs=[_vmem((n_block, q)), _vmem((n_block, q)),
                  _vmem((n_block, q)), _vmem(th.shape),
                  _vmem((n_group * k_group, 1)), _vmem((1, q))],
        out_specs=pl.BlockSpec((1, n_block, q), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((n_block, q), jnp.float32)],
        interpret=True,
    )(_f32(ops["ode_weight"]), _f32(k_star), _f32(m0), th,
      _f32(tgrid)[:, None], _f32(ops["t_vec"])[None])
    port = fk._mean_boundary_plain(fused, ops["q_const"], ops["ode_weight"],
                                   ops["t_vec"], m0, ops["theta"], tgrid,
                                   k_star, k_group)
    assert port.shape == ref.shape == (n_group, n_block, q)
    assert torch.isfinite(port).all() and torch.equal(port[0], m0)
    assert _scaled_err(port, ref) <= SCALED_TOL


@pytest.mark.parametrize("k_group", [1, 5, 64])
@pytest.mark.parametrize("n_group", [1, 3])
@pytest.mark.parametrize("model,mode,dt", [("lorenz", "kramer", 0.01),
                                           ("fitzhugh", "rodeo", 0.05)])
def test_mean_recovery_twin_matches_pallas_at_group_shapes(model, mode, dt,
                                                           n_group, k_group):
    """K5c's twin against the Pallas recovery kernel (the groups on its
    lanes) on n_group groups of k_group steps of the stationary path's
    tail from K5b's twin's entry states, Lorenz63 EK1 (3 blocks) and
    FitzHugh-Nagumo EK0 (2): every mean within SCALED_TOL, transposed from
    the TPU's (k, q, NB, G) layout."""
    fused, ops, m0, k_star, tail = _mean_chain_operands(model, mode, dt)
    tgrid = tail[:n_group * k_group]
    n_block, q = m0.shape
    chain = (fused, ops["q_const"], ops["ode_weight"], ops["t_vec"])
    bnd = fk._mean_boundary_plain(*chain, m0, ops["theta"], tgrid, k_star,
                                  k_group)
    th = ops["theta"][:, None].numpy()
    ref = pl.pallas_call(
        functools.partial(pk._mean_recovery_kernel,
                          getattr(JMODELS[model], f"{model}_flat"), k_group,
                          q, n_block, n_group, ops["q_const"]),
        out_shape=jax.ShapeDtypeStruct((k_group, q, n_block, n_group),
                                       jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_block, q)), _vmem((n_block, q)),
                  _vmem((q, n_block, n_group)), _vmem(th.shape),
                  _vmem((k_group, 1, n_group)), _vmem((1, q))],
        out_specs=_vmem((k_group, q, n_block, n_group)),
        interpret=True,
    )(_f32(ops["ode_weight"]), _f32(k_star), _f32(bnd.permute(2, 1, 0)), th,
      _f32(tgrid.reshape(n_group, k_group).T)[:, None, :],
      _f32(ops["t_vec"])[None])
    ref = np.transpose(np.asarray(ref), (3, 0, 2, 1)).reshape(
        n_group * k_group, n_block, q)
    port = fk._mean_recovery_plain(*chain, bnd, ops["theta"], tgrid, k_star)
    assert port.shape == ref.shape and torch.isfinite(port).all()
    assert _scaled_err(port, ref) <= SCALED_TOL


@pytest.mark.parametrize("n_steps", [1, 2, 5, 64, 129])
@pytest.mark.parametrize("model,mode,dt", [("lorenz", "kramer", 0.01),
                                           ("fitzhugh", "rodeo", 0.05)])
def test_mean_gain_twin_matches_pallas_at_ragged_steps(model, mode, dt,
                                                       n_steps):
    """K5a's twin against the Pallas gain-chain kernel (one grid step of
    n_steps) on the stationary path's tail from the prefix's end, with a
    gain row per step (the frozen gain, each step's scaled by a seeded 1
    %), Lorenz63 EK1 and FitzHugh-Nagumo EK0: every mean within
    SCALED_TOL."""
    fused, ops, m0, k_star, tail = _mean_chain_operands(model, mode, dt)
    tgrid = tail[:n_steps]
    n_block, q = m0.shape
    rng = np.random.default_rng(n_steps)
    gains = k_star * (1 + 0.01 * torch.tensor(
        rng.standard_normal((n_steps, 1, 1)), dtype=torch.float32))
    th = ops["theta"][:, None].numpy()
    ref = pl.pallas_call(
        functools.partial(pk._mean_gain_kernel,
                          getattr(JMODELS[model], f"{model}_flat"), n_steps,
                          q, n_block, ops["q_const"], False),
        out_shape=jax.ShapeDtypeStruct((n_steps, n_block, q), jnp.float32),
        grid=(1,),
        in_specs=[_vmem((n_block, q)), _vmem((n_steps, n_block, q)),
                  _vmem((n_block, q)), _vmem(th.shape),
                  _vmem((n_steps, 1)), _vmem((1, q))],
        out_specs=_vmem((n_steps, n_block, q)),
        scratch_shapes=[pltpu.VMEM((n_block, q), jnp.float32)],
        interpret=True,
    )(_f32(ops["ode_weight"]), _f32(gains), _f32(m0), th,
      _f32(tgrid)[:, None], _f32(ops["t_vec"])[None])
    port = fk._mean_gain_plain(fused, ops["q_const"], ops["ode_weight"],
                               ops["t_vec"], m0, ops["theta"], tgrid, gains)
    assert port.shape == ref.shape == (n_steps, n_block, q)
    assert torch.isfinite(port).all()
    assert _scaled_err(port, ref) <= SCALED_TOL


# non-Gaussian DALTON's observation models: the port's and the JAX
# package's log-likelihood of one component
_NN_VAR, _NN_B0, _NN_B1 = 0.005, 0.1, 0.05
_NN_OBS = {
    "lorenz": (tobs.gauss(_NN_VAR),
               lambda y, x, j, th, i: -0.5 * (y[0] - x) ** 2 / _NN_VAR),
    "fitzhugh": (tobs.poisson(_NN_B0, _NN_B1),
                 lambda y, x, j, th, i: y[0] * (_NN_B0 + _NN_B1 * x)
                 - jnp.exp(_NN_B0 + _NN_B1 * x)),
}


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("mode", ["kramer", "rodeo"])
@pytest.mark.parametrize("model,t_max", [("lorenz", 0.02),
                                         ("fitzhugh", 0.1)])
def test_filter_nn_twin_matches_pallas_at_few_steps(model, t_max, mode,
                                                    n_steps):
    """K9's twin over 37 lanes of the model's theta perturbed by 1 %, data
    at the last step (so at 2 steps one step without data and one with)."""
    jmod = JMODELS[model]
    obs, comp = _NN_OBS[model]
    cfg = TMODELS[model].setup(n_steps=n_steps, t_max=t_max,
                               dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(100 + n_steps)
    n_lane, nb = 37, jmod.N_VARS
    thetas = cfg["theta"] * (1 + 0.01 * torch.tensor(
        rng.standard_normal((n_lane, 3)), dtype=torch.float32))
    inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    mask = torch.zeros(n_steps)
    mask[-1] = 1.0
    y = (rng.normal(size=(n_steps, nb)) * 5 if model == "lorenz"
         else rng.poisson(2.0, size=(n_steps, nb)))
    grid = dict(y=torch.tensor(y, dtype=torch.float32) * mask[:, None],
                iobs=torch.cumsum(mask, 0) * mask, mask=mask)
    j = {k: jnp.asarray(v.numpy()) for k, v in {**ops, **grid}.items()
         if isinstance(v, torch.Tensor)}
    jac = getattr(jmod, f"{model}_jac_flat") if mode == "kramer" else None
    ref = jd._filter_nn_batch(
        getattr(jmod, f"{model}_flat"), jac, comp, (0,), mode, n_steps, None,
        j["prior_var"], j["ode_weight"], j["x0_lanes"], j["theta_lanes"],
        j["tgrid"], j["t_vec"], j["y"][:, None, :, None], j["iobs"][:, None],
        j["mask"][:, None], ops["q_const"], interpret=True)
    fdn.LAUNCHES["filter_nn_batch"] = 0
    port = fdn.filter_nn_batch(model, obs, (0,), n_steps, **ops, **grid,
                               mode=mode)
    assert fdn.LAUNCHES["filter_nn_batch"] == 0
    for name, a, b in zip(["mf", "pf", "mp", "pp"], port, ref):
        assert a.shape == b.shape == (n_steps, a.shape[1], nb, n_lane), name
        assert torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= SCALED_TOL, name
