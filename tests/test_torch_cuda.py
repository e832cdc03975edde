"""
The port's CUDA kernels on the card: K1 (filter_batch), K2r
(smoother_batch_rows), K6 (sampler_batch), K7b
(fenrir_backward_batch), K8 (dalton_filter_batch), the tangent kernels K11a
(filter_batch_tan), K11b (fenrir_backward_batch_tan), K11c
(dalton_filter_batch_tan) and K11e (smoother_mean_batch_tan), and the
single-solve kernels K3 (filter_single), K4 (smoother_single) and K7a
(fenrir_backward_single), the stationary solve's mean chain K5a
(mean_gain_single), K5b (mean_boundary_single) and K5c
(mean_recovery_single), the MAGI kernels K10a (magi_batch) and K10b
(magi_adjoint_batch), and non-Gaussian DALTON's K9 (filter_nn_batch) and
K11d (filter_nn_batch_tan) against their plain PyTorch twins on the same
CUDA inputs, the launch contract of each fused entry point, and the launch
geometry of K1, K8 and K9, which run one thread per (lane, block), of K3
and K5b, which run one thread per block of their one solve, of K5c, one
thread per (group, block), of K11a, K11c and K11d, which run one thread
per (lane, direction, block), and of K6, K2r, K7b, K11b, K10a, K10b, K4,
K7a and K5a, streams through a ring of shared-memory stages
(``csrc/stream_ring.cuh``).  The square-root form of the fused entries,
and the stationary solve on a prior that is not IBM, run on the card too,
and so does the float64 torch-op surface: the likelihoods of
``ops.precond`` with their gradients, ``ops.precond.solve_sim`` and the
fast-linalg closed forms.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so that it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""
import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rodeo_tpu_torch.models import fitzhugh, lorenz
from rodeo_tpu_torch.models import obs as obs_models
from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_daltonng as fdn
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_magi as fm
from rodeo_tpu_torch.ops import fused_sim as fs

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_coverage_reference as cov_ref  # noqa: E402

pytestmark = pytest.mark.cuda

MODELS = {"lorenz": lorenz, "fitzhugh": fitzhugh}
# non-Gaussian DALTON's fixtures: interrogation, horizon and observation
# model
_NN_MODELS = {"lorenz": ("kramer", 2.0, obs_models.gauss(0.005)),
              "fitzhugh": ("rodeo", 10.0, obs_models.poisson(0.1, 0.05))}
# Built without multiply-add contraction, a kernel does its twin's float32
# operations in the same order, a tangent kernel's Dual rules included; the
# tolerance allows for a library function (PyTorch's CUDA log against logf)
# rounding differently.  Bound on the scaled error per output and per
# tangent direction.
TWIN_TOL = 1e-5
# Lanes per CTA of K9 (kNnLanes of csrc/filter_nn_batch.cu).
K9_LANES = 32
# An entry point on the card against the same call on the CPU, where the
# dense products of the single-solve path's gains are cuBLAS's on one side
# and the CPU's on the other, summed in other orders.
ENTRY_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    return torch.device("cuda")


def _scaled_err(port, ref):
    port, ref = port.double().cpu(), ref.double().cpu()
    return ((port - ref).abs().max() / ref.abs().max()).item()


def _lanes(model, n_steps, t_max, n_lane, seed, device):
    """A seeded lane batch of ``model``: thetas and initial states perturbed
    by 1% per lane."""
    cfg = MODELS[model].setup(n_steps=n_steps, t_max=t_max,
                              dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    noise = torch.tensor(rng.standard_normal((n_lane, 3)),
                         dtype=torch.float32, device=device)
    thetas = cfg["theta"] * (1 + 0.01 * noise)
    inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
    return cfg, thetas.contiguous(), inits.contiguous()


@pytest.mark.parametrize("n_lane", [96, 37, 100])
@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.6),
                                              ("fitzhugh", "rodeo", 3.0)])
def test_kernels_match_their_twins_on_the_card(cuda_device, model, mode,
                                               t_max, n_lane):
    """K1 against its twin, bitwise (one thread per (lane, block) with a
    barrier a step), also where the lanes end inside a CTA of 16 (37 and
    100 lanes); and K2r on its gains, bitwise."""
    n_steps = 300
    cfg, thetas, inits = _lanes(model, n_steps, t_max, n_lane, 4,
                                cuda_device)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    fused = fk.resolve_model(model)
    out_k = fk.fused_filter_batch(fused, n_steps, **ops, mode=mode)
    out_p = fk._filter_batch_plain(fused, n_steps, **ops, mode=mode)
    for name, a, b in zip(["G", "g", "L", "m_last", "p_last"], out_k, out_p):
        assert a.is_cuda and torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= TWIN_TOL, name
        assert torch.equal(a, b), name
    G, g, L, mN, pN = out_k
    rows_args = (g[1:], G[1:], L[1:], mN, pN, ops["x0_lanes"],
                 ops["t_vec"], fk._tri_scale(ops["t_vec"]))
    sm_k = fk.smoother_recursion_batch_rows(*rows_args)
    sm_p = fk._smoother_batch_rows_plain(*rows_args)
    for name, a, b in zip(["mean", "cov"], sm_k, sm_p):
        assert _scaled_err(a, b) <= TWIN_TOL, name
        assert torch.equal(a, b), name


def _rows_operands(n_len, n_block, n_lane, seed, device, offset=0):
    """Seeded operands of K2r, each in a buffer of its own that starts
    ``offset`` floats past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    q = 3
    pairs, _ = fk._tri_idx(q)
    G = np.eye(q).reshape(1, q * q, 1, 1) * 0.5 + \
        0.1 * rng.standard_normal((n_len, q * q, n_block, n_lane))
    A = rng.standard_normal((n_len, n_block, n_lane, q, q))
    Lfull = A @ np.swapaxes(A, -1, -2)
    m_sc = np.array([1.0, 0.5, 0.25])

    def put(a):
        a = np.asarray(a, np.float32)
        buf = torch.empty(a.size + offset, dtype=torch.float32,
                          device=device)
        t = buf[offset:].view(a.shape)
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return t

    return [put(a) for a in (
        rng.standard_normal((n_len, q, n_block, n_lane)), G,
        np.stack([Lfull[..., i, j] for i, j in pairs], axis=1),
        rng.standard_normal((q, n_block, n_lane)),
        np.abs(rng.standard_normal((len(pairs), n_block, n_lane))),
        rng.standard_normal((q, n_block, n_lane)), m_sc,
        [m_sc[i] * m_sc[j] for i, j in pairs])]


@pytest.mark.parametrize("n_lane,offset", [(64, 0), (37, 0), (100, 0),
                                           (64, 1)])
def test_smoother_rows_stream_matches_its_twin_on_the_card(cuda_device,
                                                           n_lane, offset):
    """K2r, a stream through a ring of shared-memory stages, bitwise
    against its twin over step counts that are no multiple of its stage (no
    interior step, one, two stages and one step, the ring and one step,
    300), where the columns end inside a CTA of 32 (37 and 100 lanes of 3
    blocks), where n_lane is no multiple of 4 (37) and where every operand
    starts 4 bytes past a 16-byte boundary (offset 1): the last two run its
    4-byte copies and stores.  Its launch as the card reports it: CTAs of
    32 columns (a consumer and a producer warp), all resident, no local
    memory."""
    n_block = 3
    geo = fk._smoother_batch_rows_geometry(n_block, n_lane,
                                           device=cuda_device)
    n_col = n_block * n_lane
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
    assert geo["grid_x"] == -(-n_col // 32), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    assert geo["shared_bytes"] > 48 * 1024, geo
    assert fk._smoother_batch_rows_geometry(
        n_block, 2048, device=cuda_device)["ctas_at_least_sms"]
    step, stages = geo["steps_per_stage"], geo["stages"]
    for n_len in (0, 1, 2 * step + 1, stages * step + 1, 300):
        args = _rows_operands(n_len, n_block, n_lane, 40 + n_len,
                              cuda_device, offset)
        _reset_launches()
        out_k = fk.smoother_recursion_batch_rows(*args)
        assert _launched() == {"smoother_batch_rows": 1}, n_len
        out_p = fk._smoother_batch_rows_plain(*args)
        for name, a, b in zip(["mean", "cov"], out_k, out_p):
            assert a.shape[0] == n_len + 2, name
            assert torch.isfinite(a).all(), (name, n_len)
            assert torch.equal(a, b), (name, n_len)


def test_fused_solve_launches_each_kernel_once(cuda_device):
    """One solve on CUDA tensors is one launch of each kernel, and agrees
    with the same solve on CPU tensors, which runs the plain twins."""
    n_steps, t_max = 200, 2.0

    def solve(device):
        cfg, thetas, inits = _lanes("lorenz", n_steps, t_max, 64, 5, device)
        return fk.solve_mv_fused_batch(
            thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
            cfg["prior_pars"], model="lorenz", device=device)

    _reset_launches()
    mean, var = solve(cuda_device)
    torch.cuda.synchronize()
    assert _launched() == {"filter_batch": 1, "smoother_batch_rows": 1}
    assert mean.shape == (n_steps + 1, 3, 3, 64) and mean.is_cuda
    assert var.shape == (n_steps + 1, 3, 6, 64)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    mean_c, var_c = solve(torch.device("cpu"))
    assert _launched() == {"filter_batch": 1, "smoother_batch_rows": 1}
    for d in range(3):
        assert _scaled_err(mean[..., d, :], mean_c[..., d, :]) <= TWIN_TOL, d
    assert _scaled_err(var, var_c) <= TWIN_TOL


def test_cuda_tensors_never_take_the_twin(cuda_device):
    """A CUDA operand the kernels cannot take raises; it is not handed to
    the plain twin."""
    rng = np.random.default_rng(6)
    T, q, nb, B = 5, 6, 2, 3           # q = 6: no kernel instantiated
    n_tri = q * (q + 1) // 2

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device)

    _reset_launches()
    with pytest.raises(NotImplementedError):
        fk.smoother_recursion_batch_rows(
            t(T, q, nb, B), t(T, q * q, nb, B), t(T, n_tri, nb, B),
            t(q, nb, B), t(n_tri, nb, B), t(q, nb, B), t(q), t(n_tri))
    with pytest.raises(ValueError):    # operands on two devices
        fk.smoother_recursion_batch_rows(
            t(T, 3, nb, B), t(T, 9, nb, B).cpu(), t(T, 6, nb, B),
            t(3, nb, B), t(6, nb, B), t(3, nb, B), t(3), t(6))
    assert _launched() == {}


def _obs(model, n_obs, t_max, device):
    """The 0th derivative of every variable observed at n_obs evenly spaced
    times, variance 0.005, seeded data."""
    nb = MODELS[model].N_VARS
    rng = np.random.default_rng(8)
    weight = torch.zeros((n_obs, nb, 1, 3), device=device)
    weight[..., 0] = 1.0
    return dict(
        obs_data=torch.tensor(rng.standard_normal((n_obs, nb, 1)) * 5,
                              dtype=torch.float32, device=device),
        obs_times=torch.linspace(0.0, t_max, n_obs, dtype=torch.float64),
        obs_weight=weight,
        obs_var=torch.full((n_obs, nb, 1, 1), 0.005, device=device))


def _reset_launches():
    for counts in (fk.LAUNCHES, ff.LAUNCHES, fd.LAUNCHES, fs.LAUNCHES,
                   fm.LAUNCHES, fdn.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _launches():
    return {**fk.LAUNCHES, **ff.LAUNCHES, **fd.LAUNCHES, **fs.LAUNCHES,
            **fdn.LAUNCHES,
            **fm.LAUNCHES}


def _launched():
    """The kernels launched since the last reset, with their counts."""
    return {k: v for k, v in _launches().items() if v}


@pytest.mark.parametrize("n_lane", [96, 37, 100])
@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.6),
                                              ("fitzhugh", "rodeo", 3.0)])
def test_new_kernels_match_their_twins_on_the_card(cuda_device, model, mode,
                                                   t_max, n_lane):
    """K7b, K8 (with and without data) and K6 against their twins, on the
    operands their entry points give them; K8, one thread per (lane, block)
    with a barrier a step, bitwise, also where the lanes end inside a CTA
    of 32 (37 and 100 lanes); K7b, a stream of 32 columns a CTA, bitwise
    against its twin, which skips the update at steps without data as K7b
    does.  K6 bitwise, also where its columns end
    inside a CTA and its rows are not 16-byte aligned (37 and 100 lanes:
    111 and 300 columns), and over step counts that are no multiple of its
    stage (one step, two stages and one step, the ring and one step); its
    launch as the card reports it."""
    n_steps = 300
    cfg, thetas, inits = _lanes(model, n_steps, t_max, n_lane, 4,
                                cuda_device)
    obs = _obs(model, 11, t_max, cuda_device)
    ops, obs_k, ld0 = fd._dalton_prepare(
        thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
        cfg["prior_pars"], *obs.values())
    fused = fk.resolve_model(model)
    for with_obs in (True, False):
        k8 = fd.dalton_filter_batch(fused, n_steps, **ops, **obs_k, ld0=ld0,
                                    mode=mode, with_obs=with_obs)
        p8 = fd._dalton_filter_plain(fused, n_steps, **ops, **obs_k,
                                     ld0=ld0, mode=mode, with_obs=with_obs)
        assert torch.isfinite(k8).all()
        assert _scaled_err(k8, p8) <= TWIN_TOL, with_obs
        assert torch.equal(k8, p8), with_obs
    chain = ff._fenrir_operands(fused, n_steps, 0.0, t_max, ops,
                                *obs.values(), mode)
    k7 = ff.fenrir_backward_batch(*chain)
    p7 = chain[-1] + fd._block_sum(ff._fenrir_backward_plain(
        *chain[:-1], skip_unobserved=True))
    assert torch.isfinite(k7).all()
    assert _scaled_err(k7, p7) <= TWIN_TOL
    assert torch.equal(k7, p7)
    A, b, _, _, _, _, _, m_seed, _, _ = chain
    c = b[1:] + 0.1 * torch.randn(b[1:].shape, device=cuda_device,
                                  generator=torch.Generator(cuda_device)
                                  .manual_seed(9))
    n_col = m_seed.shape[1] * n_lane
    geo = fs._sampler_batch_geometry(n_col, device=cuda_device)
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
    assert geo["grid_x"] == -(-n_col // 32), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    assert geo["stages"] >= 4, geo
    step = geo["steps_per_stage"]
    for n_len in (c.shape[0], 1, 2 * step + 1, geo["stages"] * step + 1):
        k6 = fs.sampler_batch(c[:n_len], A[1:n_len + 1], m_seed)
        p6 = fs._sampler_batch_plain(c[:n_len], A[1:n_len + 1], m_seed)
        assert torch.isfinite(k6).all(), n_len
        assert _scaled_err(k6, p6) <= TWIN_TOL, n_len
        assert torch.equal(k6, p6), n_len


def test_inference_entry_points_launch_their_kernels(cuda_device):
    """One call of each entry point on the card launches exactly its
    kernels, and agrees with the same call on the CPU (the plain twins)."""
    n_steps, t_max, B = 200, 2.0, 64
    obs = _obs("lorenz", 21, t_max, cuda_device)

    def lanes(device, model="lorenz"):
        cfg, thetas, inits = _lanes(model, n_steps, t_max, B, 5, device)
        return dict(thetas=thetas, ode_weight=cfg["ode_weight"],
                    ode_inits=inits, t_min=0.0, t_max=t_max,
                    n_steps=n_steps, prior_pars=cfg["prior_pars"],
                    model=model, device=device)

    # the sampler on FitzHugh-Nagumo: Lorenz63's per-step covariances are
    # numerically singular in float32, so its draws move by ~1e-3 under
    # rounding differences of ~1e-7 (tests/test_torch_sim.py)
    gen = np.random.default_rng(10)
    eps = torch.tensor(gen.standard_normal((n_steps - 1, 3, 2, B)),
                       dtype=torch.float32)
    eps_term = torch.tensor(gen.standard_normal((3, 2, B)),
                            dtype=torch.float32)
    calls = {
        "fenrir": (lambda dev: ff.fenrir_fused_batch(**lanes(dev), **obs),
                   {"filter_batch": 1, "fenrir_backward_batch": 1}),
        "dalton": (lambda dev: fd.dalton_fused_batch(**lanes(dev), **obs),
                   {"dalton_filter_batch": 2}),
        "basic": (lambda dev: fk.basic_fused_batch(
            **lanes(dev), obs_data=obs["obs_data"],
            obs_times=obs["obs_times"],
            obs_loglik=lambda o, x: torch.sum(-0.5 * (o[..., 0]
                                                      - x[..., 0]) ** 2))[0],
            {"filter_batch": 1, "smoother_batch_rows": 1}),
        "sim": (lambda dev: fs.solve_sim_fused_batch(
            **lanes(dev, "fitzhugh"), eps=eps, eps_term=eps_term),
            {"filter_batch": 1, "sampler_batch": 1}),
    }
    for name, (call, expected) in calls.items():
        _reset_launches()
        out = call(cuda_device)
        torch.cuda.synchronize()
        assert _launched() == expected, name
        assert out.is_cuda and torch.isfinite(out).all(), name
        cpu = call(torch.device("cpu"))
        assert _launched() == expected, name
        assert _scaled_err(out, cpu) <= TWIN_TOL, name


def _split_err(kernel, twin, k):
    """Scaled error of each of the n_aug slices of k entries on axis 1 (or
    0 for a 3-d output): the values, then each tangent direction."""
    axis = 1 if kernel.dim() == 4 else 0
    n_aug = kernel.shape[axis] // k
    return [_scaled_err(kernel.narrow(axis, a * k, k),
                        twin.narrow(axis, a * k, k)) for a in range(n_aug)]


@pytest.mark.parametrize("n_lane", [96, 37, 100])
@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.6),
                                              ("fitzhugh", "rodeo", 3.0)])
def test_tangent_kernels_match_their_twins_on_the_card(cuda_device, model,
                                                       mode, t_max, n_lane):
    """K11a, K11e, K11b and K11c against their twins, the values and each
    tangent direction on their own; and their values against the kernels
    they extend, K1, K2r, K7b and K8, which must agree bitwise.  K11a and
    K11c, one thread per (lane, direction, block) with a barrier a step,
    and K11b, a stream with a consumer warp per direction, agree with their
    twins bitwise too, also where the lanes end inside a CTA of 32 (37 and
    100 lanes)."""
    n_steps = 300
    cfg, thetas, inits = _lanes(model, n_steps, t_max, n_lane, 4,
                                cuda_device)
    obs = _obs(model, 11, t_max, cuda_device)
    ops, obs_k, ld0 = fd._dalton_prepare(
        thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
        cfg["prior_pars"], *obs.values())
    fused = fk.resolve_model(model)
    q, n_tri, n_tan = 3, 6, 3
    out_k = fk.fused_filter_batch_tan(fused, n_steps, **ops, mode=mode)
    out_p = fk._filter_batch_tan_plain(fused, n_steps, **ops, mode=mode)
    prim = fk.fused_filter_batch(fused, n_steps, **ops, mode=mode)
    for name, a, b, k, v in zip(["A", "b", "C", "m_last", "p_last"], out_k,
                                out_p, [9, 3, 6, 3, 6], prim):
        assert torch.isfinite(a).all(), name
        assert max(_split_err(a, b, k)) <= TWIN_TOL, name
        assert torch.equal(a, b), name
        assert torch.equal(a.narrow(a.dim() - 3, 0, k), v), name
    A, b, _, m_last, _ = out_k
    ms_k = fk.smoother_mean_recursion_batch_tan(b[1:], A[1:], m_last, n_tan)
    ms_p = fk._smoother_mean_tan_plain(b[1:], A[1:], m_last, n_tan)
    assert max(_split_err(ms_k, ms_p, q)) <= TWIN_TOL
    G1, g1, L1, mN, pN = prim
    ones = torch.ones(q + n_tri, device=cuda_device)
    rows = fk.smoother_recursion_batch_rows(
        g1[1:], G1[1:], L1[1:], mN, pN, ops["x0_lanes"], ones[:q],
        ones[q:])[0]
    assert torch.equal(ms_k[:, :q], rows[1:-1].permute(0, 2, 1, 3))
    chain = ff._fenrir_operands(fused, n_steps, 0.0, t_max, ops,
                                *obs.values(), mode, tangent=True)
    k7 = ff.fenrir_backward_batch_tan(*chain)
    p7 = chain[-1] + fd._block_sum(
        ff._fenrir_backward_tan_plain(*chain[:-1], n_tan).movedim(1, 0))
    assert torch.isfinite(k7).all()
    assert max(_split_err(k7, p7, 1)) <= TWIN_TOL
    assert torch.equal(k7, p7)
    chain0 = ff._fenrir_operands(fused, n_steps, 0.0, t_max, ops,
                                 *obs.values(), mode)
    assert torch.equal(k7[0], ff.fenrir_backward_batch(*chain0))
    seed = torch.cat([ld0[None], ld0.new_zeros((n_tan, ld0.shape[0]))])
    for with_obs in (True, False):
        k8 = fd.dalton_filter_batch_tan(fused, n_steps, **ops, **obs_k,
                                        ld0=seed, mode=mode,
                                        with_obs=with_obs)
        p8 = fd._dalton_filter_tan_plain(fused, n_steps, **ops, **obs_k,
                                         ld0=seed, mode=mode,
                                         with_obs=with_obs)
        assert torch.isfinite(k8).all()
        assert max(_split_err(k8, p8, 1)) <= TWIN_TOL, with_obs
        assert torch.equal(k8, p8), with_obs
        assert torch.equal(k8[0], fd.dalton_filter_batch(
            fused, n_steps, **ops, **obs_k, ld0=ld0, mode=mode,
            with_obs=with_obs)), with_obs


@pytest.mark.parametrize("n_lane", [1, 37, 2048])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_split_tangent_kernels_launch_geometry(cuda_device, model, n_lane):
    """The split kernels' launches as the card reports them: a CTA of the
    kernel's lanes (16 for K1, K9_LANES for K9, 32 for the others) x the
    model's blocks and ceil(n_lane / lanes) lane groups, nothing in local
    memory, every CTA resident at once; K11a, K11c and K11d with one grid
    row per direction, and at 2048 lanes at least one CTA per SM; K1, K8
    and K9, with no direction axis, one grid row."""
    n_block = MODELS[model].N_VARS
    tan = [fk._filter_batch_tan_geometry(model, n_lane, device=cuda_device)]
    tan += [fd._dalton_filter_batch_tan_geometry(
        model, n_lane, with_obs=w, device=cuda_device) for w in (True, False)]
    tan += [fdn._filter_nn_batch_tan_geometry(
        model, obs, n_lane, mode=mode, device=cuda_device)
        for _, _, obs in _NN_MODELS.values() for mode in ("kramer", "rodeo")]
    k8 = [fd._dalton_filter_batch_geometry(
        model, n_lane, with_obs=w, device=cuda_device) for w in (True, False)]
    k1 = [fk._filter_batch_geometry(model, n_lane, device=cuda_device)]
    k9 = [fdn._filter_nn_batch_geometry(model, obs, n_lane, mode=mode,
                                        device=cuda_device)
          for _, _, obs in _NN_MODELS.values()
          for mode in ("kramer", "rodeo")]
    for geos, lanes, n_dir in ((tan, 32, 3), (k8, 32, 1), (k1, 16, 1),
                               (k9, K9_LANES, 1)):
        for geo in geos:
            assert (geo["cta_x"], geo["cta_y"]) == (lanes, n_block), geo
            assert (geo["grid_x"], geo["grid_y"]) == (-(-n_lane // lanes),
                                                      n_dir), geo
            assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    for geo in tan:
        assert geo["ctas_at_least_sms"] == (n_lane == 2048), geo


def test_gradient_entry_points_launch_their_kernels(cuda_device):
    """One call of each gradient entry point on the card launches exactly
    its tangent kernels, returns its value entry point's values bitwise,
    and agrees with the same call on the CPU (the plain twins)."""
    n_steps, t_max, B = 200, 2.0, 64
    obs = _obs("lorenz", 21, t_max, cuda_device)

    def lanes(device):
        cfg, thetas, inits = _lanes("lorenz", n_steps, t_max, B, 5, device)
        return dict(thetas=thetas, ode_weight=cfg["ode_weight"],
                    ode_inits=inits, t_min=0.0, t_max=t_max,
                    n_steps=n_steps, prior_pars=cfg["prior_pars"],
                    model="lorenz", device=device)

    def b_loglik(o, x):
        return torch.sum(-0.5 * (o[..., 0] - x[..., 0]) ** 2)

    basic = dict(obs_data=obs["obs_data"], obs_times=obs["obs_times"],
                 obs_loglik=b_loglik)
    calls = {
        "fenrir": (lambda dev: ff.fenrir_fused_batch_grad(**lanes(dev),
                                                          **obs),
                   lambda dev: ff.fenrir_fused_batch(**lanes(dev), **obs),
                   {"filter_batch_tan": 1, "fenrir_backward_batch_tan": 1}),
        "dalton": (lambda dev: fd.dalton_fused_batch_grad(**lanes(dev),
                                                          **obs),
                   lambda dev: fd.dalton_fused_batch(**lanes(dev), **obs),
                   {"dalton_filter_batch_tan": 2}),
        "basic": (lambda dev: fk.basic_fused_batch_grad(**lanes(dev),
                                                        **basic)[:2],
                  lambda dev: fk.basic_fused_batch(**lanes(dev), **basic)[0],
                  {"filter_batch_tan": 1, "smoother_mean_batch_tan": 1}),
    }
    for name, (call, value, expected) in calls.items():
        _reset_launches()
        ll, grad = call(cuda_device)
        torch.cuda.synchronize()
        assert _launched() == expected, name
        assert ll.shape == (B,) and grad.shape == (B, 3), name
        assert torch.isfinite(ll).all() and torch.isfinite(grad).all(), name
        assert torch.equal(ll, value(cuda_device)), name
        ll_c, grad_c = call(torch.device("cpu"))
        assert _scaled_err(ll, ll_c) <= TWIN_TOL, name
        assert _scaled_err(grad, grad_c) <= TWIN_TOL, name


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.6),
                                              ("fitzhugh", "rodeo", 3.0)])
def test_single_kernels_match_their_twins_on_the_card(cuda_device, model,
                                                      mode, t_max):
    """K3, K4 (on K3's gains, over every step and over the composed
    boundary steps) and K7a (on fenrir's chain) bitwise against their
    twins."""
    n_steps = 300
    cfg = MODELS[model].setup(n_steps=n_steps, t_max=t_max,
                              dtype=torch.float32, device=cuda_device)
    ops, Qs = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                  cfg["ode_init"], 0.0, t_max, n_steps,
                                  cfg["prior_pars"])
    fused = fk.resolve_model(model)
    out_k = fk.fused_filter(fused, n_steps, **ops, mode=mode)
    out_p = fk._filter_single_plain(fused, n_steps, **ops, mode=mode)
    for name, a, b in zip(["mf", "pf", "mp", "pp"], out_k, out_p):
        assert a.is_cuda and torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= TWIN_TOL, name
        assert torch.equal(a, b), name
    mf, pf, mp, pp = out_k
    states = (mf[:-1], pf[:-1], mp[1:], pp[1:])
    comp, _ = fk._composed_suffixes(ops["q_const"], ops["prior_var"],
                                    *states, 16)
    for gains in (fk._smoother_gains(Qs, ops["prior_var"], *states),
                  fk._boundary_operands(comp)):
        args = (*gains, mf[-1], pf[-1])
        for a, b in zip(fk.smoother_recursion(*args),
                        fk._smoother_single_plain(*args)):
            assert torch.isfinite(a).all()
            assert _scaled_err(a, b) <= TWIN_TOL
            assert torch.equal(a, b)
    obs = _obs(model, 11, t_max, cuda_device)
    ops["q_const"] = ff._const_coefs(Qs)
    chain = ff._fenrir_single_operands(fused, n_steps, 0.0, t_max, ops, Qs,
                                       *obs.values(), mode)
    k7 = ff.fenrir_backward_single(*chain)
    p7 = chain[-1] + fd._block_sum(ff._fenrir_backward_single_plain(
        *chain[:-1]))
    assert torch.isfinite(k7)
    assert _scaled_err(k7, p7) <= TWIN_TOL
    assert torch.equal(k7, p7)


def _put(a, device, offset):
    """``a`` as float32 on the card, in a buffer of its own that starts
    ``offset`` floats past a 16-byte boundary."""
    a = np.ascontiguousarray(a, np.float32)
    buf = torch.empty(a.size + offset, dtype=torch.float32, device=device)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


def _packed_psd(rng, shape, q, scale=1.0):
    pairs, _ = fk._tri_idx(q)
    M = scale * rng.standard_normal(shape + (q, q))
    full = M @ np.swapaxes(M, -1, -2)
    return np.stack([full[..., i, j] for i, j in pairs], axis=-1)


@pytest.mark.parametrize("n_block", [1, 3, 7])
def test_single_smoother_stream_is_bitwise_its_twin_on_the_card(cuda_device,
                                                                n_block):
    """K4, a stream of slabs through a ring of shared-memory stages (a
    consumer and a producer warp), bitwise against its twin from 1 to 9999
    rows: within a stage, one stage, a stage and one row, the ring and one
    row, 9999; with 16-byte copies and with every operand 4 bytes past a
    16-byte boundary (4-byte copies); at 7 blocks over two CTAs (4-byte
    copies, run by run).  Its launch as the card reports it: CTAs of a
    consumer and a producer warp, each block's row over 6 lanes or one,
    all resident, no local memory."""
    q = 3
    geo = fk._smoother_single_geometry(n_block, device=cuda_device)
    per = geo["blocks_per_cta"]
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
    assert geo["grid_x"] == -(-n_block // per), geo
    assert per * geo["lanes_per_block"] <= 32, geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    rows, stages = geo["rows_per_stage"], geo["stages"]
    for offset in (0, 1):
        for n_len in (1, 2, rows - 1, rows, rows + 1, stages * rows + 1,
                      9999):
            if offset and n_len == 9999:
                continue
            rng = np.random.default_rng(60 + n_len + offset)
            G = np.eye(q).reshape(1, 1, q * q) * 0.5 + \
                0.1 * rng.standard_normal((n_len, n_block, q * q))
            args = [_put(a, cuda_device, offset) for a in (
                rng.standard_normal((n_len, n_block, q)), G,
                _packed_psd(rng, (n_len, n_block), q),
                rng.standard_normal((n_block, q)),
                _packed_psd(rng, (n_block,), q))]
            _reset_launches()
            out_k = fk.smoother_recursion(*args)
            assert _launched() == {"smoother_single": 1}, n_len
            out_p = fk._smoother_single_plain(*args)
            for name, a, b in zip(["ms", "ps"], out_k, out_p):
                assert torch.isfinite(a).all(), (name, n_len, offset)
                assert torch.equal(a, b), (name, n_len, offset)


@pytest.mark.parametrize("n_lane,offset", [(37, 0), (100, 0), (64, 1)])
@pytest.mark.parametrize("n_tan", [1, 2, 3, 4])
def test_fenrir_tangent_stream_is_bitwise_its_twin_on_the_card(cuda_device,
                                                               n_tan, n_lane,
                                                               offset):
    """K11b, a stream with a consumer warp per direction, bitwise against
    its twin (which skips the update at steps without data, as K11b does)
    over step counts that are no multiple of its stage (one step, a stage,
    a stage and one step, the ring and one step, 301), where the columns
    end inside a CTA of 32 (37 and 100 lanes of 3 blocks), where n_lane x 3
    is no multiple of 4 (37) and where every operand starts 4 bytes past a
    16-byte boundary (offset 1): the last two copy 4 bytes at a time.  Data
    at every third step.  Its launch as the card reports it: CTAs of 32
    columns, n_tan consumer warps and a producer warp, all resident, no
    local memory, at 2048 lanes at least one CTA per SM."""
    q, nb = 3, 3
    n_tri, n_aug = 6, 1 + n_tan
    geo = ff._fenrir_backward_batch_tan_geometry(nb, n_lane, n_tan,
                                                  device=cuda_device)
    n_col = nb * n_lane
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (32 * n_aug, 1,
                                                           1), geo
    assert geo["grid_x"] == -(-n_col // 32), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    assert ff._fenrir_backward_batch_tan_geometry(
        nb, 2048, n_tan, device=cuda_device)["ctas_at_least_sms"]
    step, stages = geo["steps_per_stage"], geo["stages"]
    for n_steps in (1, step, step + 1, stages * step + 1, 301):
        rng = np.random.default_rng(80 + n_steps + n_tan)

        def aug(v, axis):
            return np.concatenate([v] + [0.1 * rng.standard_normal(v.shape)
                                         for _ in range(n_tan)], axis=axis)

        mask = (np.arange(n_steps) % 3 == 0).astype(np.float64)
        A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
            0.1 * rng.standard_normal((n_steps, q * q, nb, n_lane))
        chain = [_put(a, cuda_device, offset) for a in (
            aug(A, 1), aug(rng.standard_normal((n_steps, q, nb, n_lane)), 1),
            aug(np.moveaxis(_packed_psd(rng, (n_steps, nb, n_lane), q, 0.3),
                            -1, 1), 1),
            rng.standard_normal((n_steps, q, nb)) * mask[:, None, None],
            rng.standard_normal((n_steps, nb)) * mask[:, None],
            np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)),
                     1.0),
            mask, aug(rng.standard_normal((q, nb, n_lane)), 0),
            aug(np.moveaxis(_packed_psd(rng, (nb, n_lane), q), -1, 0), 0),
            rng.standard_normal((n_aug, n_lane)))]
        _reset_launches()
        k11 = ff.fenrir_backward_batch_tan(*chain)
        assert _launched() == {"fenrir_backward_batch_tan": 1}, n_steps
        p11 = chain[-1] + fd._block_sum(ff._fenrir_backward_tan_plain(
            *chain[:-1], n_tan).movedim(1, 0))
        assert k11.shape == (n_aug, n_lane), n_steps
        assert torch.isfinite(k11).all(), n_steps
        assert torch.equal(k11, p11), n_steps


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("n_lane,offset", [(37, 0), (100, 0), (64, 1)])
def test_fenrir_stream_is_bitwise_its_twin_on_the_card(cuda_device, n_lane,
                                                       offset, with_obs):
    """K7b, a stream with one consumer warp, bitwise against its twin (which
    skips the update at steps without data, as K7b does) over step counts
    that are no multiple of its stage (one step, two, the ring and one step,
    300), where the columns end inside a CTA of 32 (37 and 100 lanes of 3
    blocks), where n_lane x 3 is no multiple of 4 (37) and where every
    operand starts 4 bytes past a 16-byte boundary (offset 1): the last two
    copy 4 bytes at a time.  Data at every third step, or at none.  Its
    launch as the card reports it: CTAs of 32 columns, a consumer and a
    producer warp, all resident, no local memory, at 2048 lanes at least
    one CTA per SM."""
    q, nb = 3, 3
    geo = ff._fenrir_backward_batch_geometry(nb, n_lane, device=cuda_device)
    n_col = nb * n_lane
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
    assert geo["grid_x"] == -(-n_col // 32), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    assert ff._fenrir_backward_batch_geometry(
        nb, 2048, device=cuda_device)["ctas_at_least_sms"]
    step, stages = geo["steps_per_stage"], geo["stages"]
    for n_steps in (1, 2, stages * step + 1, 300):
        rng = np.random.default_rng(110 + n_steps + with_obs)
        mask = (np.arange(n_steps) % 3 == 0).astype(np.float64) * with_obs
        A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
            0.1 * rng.standard_normal((n_steps, q * q, nb, n_lane))
        chain = [_put(a, cuda_device, offset) for a in (
            A, rng.standard_normal((n_steps, q, nb, n_lane)),
            np.moveaxis(_packed_psd(rng, (n_steps, nb, n_lane), q, 0.3),
                        -1, 1),
            rng.standard_normal((n_steps, q, nb)) * mask[:, None, None],
            rng.standard_normal((n_steps, nb)) * mask[:, None],
            np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, nb)),
                     1.0),
            mask, rng.standard_normal((q, nb, n_lane)),
            np.moveaxis(_packed_psd(rng, (nb, n_lane), q), -1, 0),
            rng.standard_normal(n_lane))]
        _reset_launches()
        k7 = ff.fenrir_backward_batch(*chain)
        assert _launched() == {"fenrir_backward_batch": 1}, n_steps
        p7 = chain[-1] + fd._block_sum(ff._fenrir_backward_plain(
            *chain[:-1], skip_unobserved=True))
        assert k7.shape == (n_lane,), n_steps
        assert torch.isfinite(k7).all(), n_steps
        assert torch.equal(k7, p7), n_steps
        if not with_obs:
            assert torch.equal(k7, chain[-1]), n_steps


@pytest.mark.parametrize("n_block", [1, 3, 7])
def test_fenrir_single_stream_is_bitwise_its_twin_on_the_card(cuda_device,
                                                              n_block):
    """K7a, a stream of slabs through a ring of shared-memory stages (a
    consumer and a producer warp), bitwise against its twin (which skips
    the update at steps without data, as K7a does) at 1, 2, 9, 64, 65 and
    4000 steps: within a stage, at its end and past it, and the likelihood
    fixture's length; with 16-byte copies and with every operand 4 bytes
    past a 16-byte boundary (4-byte copies); at 7 blocks over two CTAs (4-byte
    copies, run by run: 4 blocks a CTA); with no data, and with data on
    the first and last step.  Its launch as the card reports it: CTAs of a consumer and a
    producer warp, a consumer thread per block, all resident, no local
    memory."""
    q = 3
    geo = ff._fenrir_backward_single_geometry(n_block, device=cuda_device)
    per = geo["blocks_per_cta"]
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
    assert geo["grid_x"] == -(-n_block // per), geo
    assert 1 <= per <= 32, geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    for offset in (0, 1):
        for n_steps in (1, 2, 9, 64, 65, 4000):
            for with_obs in (False, True):
                rng = np.random.default_rng(140 + n_steps + offset)
                mask = np.zeros(n_steps)
                if with_obs:
                    mask[0] = mask[-1] = 1.0
                A = np.eye(q).reshape(1, 1, q * q) * 0.8 + \
                    0.1 * rng.standard_normal((n_steps, n_block, q * q))
                chain = [_put(a, cuda_device, offset) for a in (
                    A, rng.standard_normal((n_steps, n_block, q)),
                    _packed_psd(rng, (n_steps, n_block), q, 0.3),
                    rng.standard_normal((n_steps, q, n_block))
                    * mask[:, None, None],
                    rng.standard_normal((n_steps, n_block)) * mask[:, None],
                    np.where(mask[:, None] > 0,
                             0.1 + rng.random((n_steps, n_block)), 1.0),
                    mask, rng.standard_normal((n_block, q)),
                    _packed_psd(rng, (n_block,), q),
                    rng.standard_normal(1))]
                chain[-1] = chain[-1][0]    # the seed's term, a scalar
                _reset_launches()
                k7 = ff.fenrir_backward_single(*chain)
                assert _launched() == {"fenrir_backward_single": 1}
                p7 = chain[-1] + fd._block_sum(
                    ff._fenrir_backward_single_plain(*chain[:-1]))
                label = (n_steps, offset, with_obs)
                assert k7.shape == () and torch.isfinite(k7), label
                assert torch.equal(k7, p7), label
                if not with_obs:
                    assert torch.equal(k7, chain[-1]), label


@pytest.mark.parametrize("n_lane,offset,sig2", [(37, 0, False),
                                                (64, 1, True),
                                                (100, 0, True)])
@pytest.mark.parametrize("act", [1, 2, 3])
def test_magi_stream_is_bitwise_its_twin_on_the_card(cuda_device, act,
                                                     n_lane, offset, sig2):
    """K10a, a forward stream with a consumer and a producer warp, bitwise
    against its twin in both emits at 1, 5 and 300 steps (within a stage,
    past one, many stages and a ragged last one), and at 4000 at 64 lanes;
    where the columns end inside a CTA (37 and 100 lanes of 3 blocks),
    where n_lane x 3 is no multiple of 4 (37) and where every operand starts
    4 bytes past a 16-byte boundary (offset 1): the last two copy and store
    4 bytes at a time; R shared by the lanes, or one per lane (sig2).  Its
    launch as the card reports it in each emit: CTAs of 64 threads, all
    resident, no local memory, at 2048 lanes at least one CTA per SM."""
    nb = 3
    for emit in ("ld", "adjoint"):
        geo = fm._magi_batch_geometry(nb, n_lane, act, emit,
                                      device=cuda_device)
        assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
        assert geo["grid_x"] == -(-nb * n_lane // geo["columns_per_cta"]), geo
        assert geo["local_bytes"] == 0 and geo["all_resident"], geo
        assert fm._magi_batch_geometry(nb, 2048, act, emit,
                                       device=cuda_device)[
            "ctas_at_least_sms"]
    for n_steps in (1, 5, 300) + ((4000,) if n_lane == 64 else ()):
        subs, kw = _magi_lanes(n_steps, n_lane, act, cuda_device, sig2)
        q_const, _, R, x, m0 = fm._magi_operands(
            kw["ode_expand"](subs), act, kw["prior_pars"], kw["dt"],
            kw["sig2_lanes"])
        x, R, m0 = (_put(a.cpu().numpy(), cuda_device, offset)
                    for a in (x, R, m0))
        plain = fm._magi_batch_plain(x, R, m0, q_const, "adjoint")
        ld_p = fd._block_sum(plain[0])
        _reset_launches()
        ld = fm.magi_filter_batch(x, R, m0, q_const, emit="ld")
        out = fm.magi_filter_batch(x, R, m0, q_const, emit="adjoint")
        assert _launched() == {"magi_batch": 2}, n_steps
        assert torch.isfinite(ld).all(), n_steps
        assert torch.equal(ld, ld_p), n_steps
        assert torch.equal(out[0], ld_p), n_steps
        assert len(out) == len([a for a in plain if a is not None])
        for a, b in zip(out[1:], plain[1:]):
            assert torch.equal(a, b), n_steps


@pytest.mark.parametrize("n_steps", [1, 2, 37, 10000])
@pytest.mark.parametrize("model,mode", [("lorenz", "kramer"),
                                        ("lorenz", "rodeo"),
                                        ("fitzhugh", "kramer"),
                                        ("fitzhugh", "rodeo")])
def test_single_filter_is_bitwise_its_twin_on_the_card(cuda_device, model,
                                                       mode, n_steps):
    """K3, one thread per block of the solve meeting once a step, bitwise
    against its twin for both models and interrogations, from one step to
    the single-solve path's 10 000 (at the path's step, dt = 0.002 for
    Lorenz63 and 0.001 for FitzHugh-Nagumo); its launch as the card
    reports it: one CTA of a thread per block, no local memory."""
    t_max = {"lorenz": 0.002, "fitzhugh": 0.001}[model] * n_steps
    cfg = MODELS[model].setup(n_steps=n_steps, t_max=t_max,
                              dtype=torch.float32, device=cuda_device)
    ops, _ = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                 cfg["ode_init"], 0.0, t_max, n_steps,
                                 cfg["prior_pars"])
    fused = fk.resolve_model(model)
    _reset_launches()
    out_k = fk.fused_filter(fused, n_steps, **ops, mode=mode)
    assert _launched() == {"filter_single": 1}
    out_p = fk._filter_single_plain(fused, n_steps, **ops, mode=mode)
    for name, a, b in zip(["mf", "pf", "mp", "pp"], out_k, out_p):
        assert a.is_cuda and torch.isfinite(a).all(), name
        assert torch.equal(a, b), name
    geo = fk._filter_single_geometry(model, mode, device=cuda_device)
    n_block = MODELS[model].N_VARS
    assert (geo["cta_x"], geo["cta_y"], geo["grid_x"], geo["grid_y"]) == \
        (n_block, 1, 1, 1), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo


def test_single_entry_points_launch_their_kernels(cuda_device):
    """solve_mv_fused (plain smoother, the default, and composed) and
    fenrir_fused on the card launch exactly their kernels, and agree with the same calls on the
    CPU (the plain twins)."""
    n_steps, t_max = 600, 1.2
    obs = _obs("lorenz", 13, t_max, cuda_device)

    def single(device):
        cfg = lorenz.setup(n_steps=n_steps, t_max=t_max, device=device)
        return dict(theta=cfg["theta"], ode_weight=cfg["ode_weight"],
                    ode_init=cfg["ode_init"], t_min=0.0, t_max=t_max,
                    n_steps=n_steps, prior_pars=cfg["prior_pars"],
                    model="lorenz", device=device)

    calls = {
        "plain": (lambda dev: fk.solve_mv_fused(**single(dev)),
                  {"filter_single": 1, "smoother_single": 1}),
        "composed": (lambda dev: fk.solve_mv_fused(**single(dev),
                                                   k_compose=16),
                     {"filter_single": 1, "smoother_single": 1}),
        "fenrir": (lambda dev: (ff.fenrir_fused(**single(dev), **obs),),
                   {"filter_single": 1, "fenrir_backward_single": 1}),
    }
    for name, (call, expected) in calls.items():
        _reset_launches()
        out = call(cuda_device)
        torch.cuda.synchronize()
        assert _launched() == expected, name
        cpu = call(torch.device("cpu"))
        assert _launched() == expected, name
        for a, b in zip(out, cpu):
            assert a.is_cuda and torch.isfinite(a).all(), name
            assert _scaled_err(a, b) <= ENTRY_TOL, name


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 1.92),
                                              ("fitzhugh", "rodeo", 9.6)])
def test_mean_chain_kernels_match_their_twins_on_the_card(cuda_device, model,
                                                          mode, t_max):
    """K5a, K5b and K5c against their twins, bitwise, on the operands the
    stationary path builds (a 64-step K3 prefix and its gains, a 128-step
    tail of two groups); and K5b + K5c equal K5a with the frozen gain from
    the same start, bitwise."""
    n_steps = 192
    cfg = MODELS[model].setup(n_steps=n_steps, t_max=t_max,
                              dtype=torch.float32, device=cuda_device)
    ops, _ = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                 cfg["ode_init"], 0.0, t_max, n_steps,
                                 cfg["prior_pars"])
    fused = fk.resolve_model(model)
    mfw, _, _, ppw = fk.fused_filter(
        fused, 64, **{**ops, "tgrid": ops["tgrid"][:64]}, mode=mode)
    gains = fk._stationary_gains(fused, ops, ppw, mode, 0.0)
    k_star, tail = gains[-1], ops["tgrid"][64:]
    all_gains = torch.cat([gains, k_star.expand(128, *k_star.shape)])
    chain = (fused, ops["q_const"], ops["ode_weight"], ops["t_vec"])
    a = (*chain, ops["x0"], ops["theta"], ops["tgrid"], all_gains)
    b = (*chain, mfw[-1], ops["theta"], tail, k_star)
    bnd = fk.mean_boundary_chain(*b)
    c = (*chain, bnd, ops["theta"], tail, k_star)
    for kernel, twin, args in ((fk.mean_gain_chain, fk._mean_gain_plain, a),
                               (fk.mean_boundary_chain,
                                fk._mean_boundary_plain, b + (64,)),
                               (fk.mean_recovery_chain,
                                fk._mean_recovery_plain, c)):
        out = kernel(*args[:8])
        assert out.is_cuda and torch.isfinite(out).all()
        assert torch.equal(out, twin(*args)), kernel.__name__
    rows = fk.mean_recovery_chain(*c)
    ref = fk.mean_gain_chain(*chain, mfw[-1], ops["theta"], tail,
                             k_star.expand(128, *k_star.shape).contiguous())
    assert torch.equal(rows, ref)


def _boundary_at(chain, m0, theta, tgrid, k_star, k_group):
    """K5b over groups of k_group steps, launched as mean_boundary_chain
    launches it (its own groups are 64 steps)."""
    fused, q_const, ode_weight, t_vec = chain
    bnd = m0.new_empty((tgrid.shape[0] // k_group,) + m0.shape)
    qc = fk._host_qconst(q_const)
    fk._launch(fk.LAUNCHES, "mean_boundary_single", 3, m0.device,
               bnd.shape[0], k_group, ctypes.addressof(qc), ode_weight, t_vec,
               m0, theta, tgrid, k_star, bnd, model=fused.cuda_functor)
    return bnd


def _non_ibm(prior_pars):
    """A block-constant prior that is not IBM: IBM's weight with its last
    diagonal entry scaled by 0.9 in every block, so that the scaled
    transition is not unit upper-triangular."""
    w, v = prior_pars
    w = w.clone()
    w[:, 2, 2] *= 0.9
    return w, v


def _tail_operands(model, mode, dt, n_tail, device, dense):
    """The mean chain's operands as the stationary path builds them after a
    64-step K3 prefix, for n_tail more steps of ``dt``, on the scaled IBM
    transition or (``dense``) the one of :func:`_non_ibm`: the chain's
    constants, the single-solve operands, the state after the prefix and
    the prefix's gains."""
    n = 64 + n_tail
    cfg = MODELS[model].setup(n_steps=n, t_max=dt * n, dtype=torch.float32,
                              device=device)
    prior = _non_ibm(cfg["prior_pars"]) if dense else cfg["prior_pars"]
    ops, _ = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                 cfg["ode_init"], 0.0, dt * n, n, prior)
    fused = fk.resolve_model(model)
    mfw, _, _, ppw = fk.fused_filter(
        fused, 64, **{**ops, "tgrid": ops["tgrid"][:64]}, mode=mode)
    k_pre = fk._stationary_gains(fused, ops, ppw, mode, 0.0)
    chain = (fused, ops["q_const"], ops["ode_weight"], ops["t_vec"])
    return chain, ops, mfw[-1], k_pre


_TAIL_MODELS = [("lorenz", "kramer", 0.01), ("fitzhugh", "rodeo", 0.05)]


@pytest.mark.parametrize("model,mode,dt", _TAIL_MODELS)
def test_mean_boundary_split_is_bitwise_its_twin_on_the_card(cuda_device,
                                                             model, mode,
                                                             dt):
    """K5b, one thread per block of its solve meeting once a step by warp
    shuffles, bitwise against its twin at 1, 2 and 3 groups of 1, 5 and 64
    steps (64 through mean_boundary_chain) on the stationary path's tail
    after a 64-step K3 prefix, on the scaled IBM transition and on a
    block-constant one that is not unit upper-triangular; K5b + K5c bitwise
    K5a with the frozen gain from the same start, and K5a and K5c bitwise
    their twins, on both; its launch as the card reports it: one CTA of a
    thread per block, no local memory."""
    for dense in (False, True):
        chain, ops, m0, k_pre = _tail_operands(model, mode, dt, 192,
                                               cuda_device, dense)
        k_star, theta = k_pre[-1], ops["theta"]
        for n_group in (1, 2, 3):
            for k_group in (1, 5, 64):
                label = (dense, n_group, k_group)
                tgrid = ops["tgrid"][64:64 + n_group * k_group]
                _reset_launches()
                bnd = (fk.mean_boundary_chain(*chain, m0, theta, tgrid,
                                              k_star)
                       if k_group == 64 else
                       _boundary_at(chain, m0, theta, tgrid, k_star,
                                    k_group))
                assert _launched() == {"mean_boundary_single": 1}, label
                twin = fk._mean_boundary_plain(*chain, m0, theta, tgrid,
                                               k_star, k_group)
                assert bnd.is_cuda and torch.isfinite(bnd).all(), label
                assert torch.equal(bnd, twin), label
                rows = fk.mean_recovery_chain(*chain, bnd, theta, tgrid,
                                              k_star)
                assert torch.equal(rows, fk._mean_recovery_plain(
                    *chain, bnd, theta, tgrid, k_star)), label
                gains = k_star.expand(tgrid.shape[0],
                                      *k_star.shape).contiguous()
                ref = fk.mean_gain_chain(*chain, m0, theta, tgrid, gains)
                assert torch.equal(ref, fk._mean_gain_plain(
                    *chain, m0, theta, tgrid, gains)), label
                assert torch.equal(rows, ref), label
    geo = fk._mean_boundary_geometry(model, device=cuda_device)
    assert (geo["cta_x"], geo["cta_y"], geo["grid_x"], geo["grid_y"]) \
        == (MODELS[model].N_VARS, 1, 1, 1), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo


def _misaligned(t, offset):
    """A copy of t whose data starts ``offset`` floats past a fresh
    allocation, so that it is not 16-byte aligned for offset 1."""
    buf = t.new_empty(t.numel() + offset)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("model,mode,dt", _TAIL_MODELS)
def test_mean_recovery_split_is_bitwise_its_twin_on_the_card(
        cuda_device, model, mode, dt, dense):
    """K5c, a thread per (group, block), 8 groups a warp exchanging by
    shuffles, bitwise against its twin at 1, 2, 5, 8, 9, 155 and 157 groups
    (where the last CTA is full, holds one group, or holds five) of 1, 5
    and 64 steps, from K5b's entry states, on either transition, into the
    wrapper's output (16-byte stores) and into one a float off (4-byte
    ones); K5b + K5c bitwise K5a with the frozen gain where the groups are
    64 steps; groups of 65 steps refused on the card; its launch as the
    card reports it."""
    # a fifth of the step, so that 10 112 steps span what the 10 000-step
    # stationary solve spans
    chain, ops, m0, k_pre = _tail_operands(model, mode, dt / 5, 157 * 64,
                                           cuda_device, dense)
    k_star, theta = k_pre[-1], ops["theta"]
    for n_group in (1, 2, 5, 8, 9, 155, 157):
        for k_group in (1, 5, 64):
            label = (n_group, k_group)
            tgrid = ops["tgrid"][64:64 + n_group * k_group]
            bnd = _boundary_at(chain, m0, theta, tgrid, k_star, k_group)
            _reset_launches()
            rows = fk.mean_recovery_chain(*chain, bnd, theta, tgrid, k_star)
            assert _launched() == {"mean_recovery_single": 1}, label
            assert rows.is_cuda and torch.isfinite(rows).all(), label
            twin = fk._mean_recovery_plain(*chain, bnd, theta, tgrid, k_star)
            assert torch.equal(rows, twin), label
            # the wrapper's output is fresh; launch into a misaligned one
            off = _misaligned(torch.zeros_like(twin), 1)
            qc = fk._host_qconst(chain[1])
            fk._launch(fk.LAUNCHES, "mean_recovery_single", 3, m0.device,
                       n_group, k_group, ctypes.addressof(qc), chain[2],
                       chain[3], bnd, theta, tgrid, k_star, off,
                       model=chain[0].cuda_functor)
            assert torch.equal(off, twin), label
            if k_group == 64:
                ref = fk.mean_gain_chain(
                    *chain, m0, theta, tgrid,
                    k_star.expand(tgrid.shape[0], *k_star.shape)
                    .contiguous())
                assert torch.equal(rows, ref), label
        geo = fk._mean_recovery_geometry(model, n_group, device=cuda_device)
        assert (geo["cta_x"], geo["cta_y"], geo["grid_x"], geo["grid_y"]) \
            == (32, 1, -(-n_group // 8), 1), geo
        assert (geo["groups_per_cta"], geo["max_group_steps"]) == (8, 64)
        assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    tgrid = ops["tgrid"][64:64 + 2 * 65]
    bnd = _boundary_at(chain, m0, theta, tgrid, k_star, 65)
    with pytest.raises(ValueError, match="at most 64"):
        fk.mean_recovery_chain(*chain, bnd, theta, tgrid, k_star)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("model,mode,dt", _TAIL_MODELS)
def test_mean_gain_stream_is_bitwise_its_twin_on_the_card(
        cuda_device, model, mode, dt, dense):
    """K5a, a thread per block fed by a producer warp through a ring of
    two stages of 256 steps, bitwise against its twin at 1 to 4000 steps (a
    stage's edges, the ring's wrap) from the initial state, with the
    prefix's gains and then the frozen one, on either transition; with
    aligned operands (16-byte copies and stores) and with gains, times and
    means one float off (4-byte ones); its launch as the card reports
    it."""
    chain, ops, _, k_pre = _tail_operands(model, mode, dt / 5, 4000 - 64,
                                          cuda_device, dense)
    gains_all = torch.cat([k_pre, k_pre[-1].expand(4000 - 64,
                                                   *k_pre[-1].shape)])
    x0, theta = ops["x0"], ops["theta"]
    for n_steps in (1, 2, 63, 64, 65, 150, 255, 256, 257, 511, 512, 513,
                    4000):
        tgrid = ops["tgrid"][:n_steps].contiguous()
        gains = gains_all[:n_steps].contiguous()
        twin = fk._mean_gain_plain(*chain, x0, theta, tgrid, gains)
        for offset in (0, 1):
            label = (n_steps, offset)
            t_k, g_k = _misaligned(tgrid, offset), _misaligned(gains, offset)
            _reset_launches()
            if offset:
                # the wrapper's output is fresh; launch into a misaligned one
                mf = _misaligned(torch.zeros_like(twin), offset)
                qc = fk._host_qconst(chain[1])
                fk._launch(fk.LAUNCHES, "mean_gain_single", 3, x0.device,
                           n_steps, ctypes.addressof(qc), chain[2], chain[3],
                           x0, theta, t_k, g_k, mf,
                           model=chain[0].cuda_functor)
            else:
                mf = fk.mean_gain_chain(*chain, x0, theta, t_k, g_k)
            assert _launched() == {"mean_gain_single": 1}, label
            assert mf.is_cuda and torch.isfinite(mf).all(), label
            assert torch.equal(mf, twin), label
    geo = fk._mean_gain_geometry(model, device=cuda_device)
    assert (geo["cta_x"], geo["cta_y"], geo["grid_x"], geo["grid_y"]) == \
        (64, 1, 1, 1), geo
    assert (geo["stages"], geo["rows_per_stage"]) == (2, 256), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo


def test_stationary_solve_with_a_non_ibm_prior_on_the_card(cuda_device):
    """solve_mv_fused_stationary with a block-constant prior that is not
    IBM, two-phase (K3, K5b, K5c, K4) and on K5a, runs on the card and
    agrees with the same call on the CPU (the twins)."""
    for n_steps, expected in (
            (600, {"filter_single": 1, "mean_boundary_single": 1,
                   "mean_recovery_single": 1, "smoother_single": 1}),
            (150, {"filter_single": 1, "mean_gain_single": 1,
                   "smoother_single": 1})):
        def call(device):
            cfg = lorenz.setup(n_steps=n_steps, t_max=0.002 * n_steps,
                               device=device)
            return fk.solve_mv_fused_stationary(
                cfg["theta"], cfg["ode_weight"], cfg["ode_init"], 0.0,
                0.002 * n_steps, n_steps, _non_ibm(cfg["prior_pars"]),
                model="lorenz", device=device)

        _reset_launches()
        out = call(cuda_device)
        torch.cuda.synchronize()
        assert _launched() == expected, n_steps
        cpu = call(torch.device("cpu"))
        for a, b in zip(out, cpu):
            assert a.is_cuda and torch.isfinite(a).all(), n_steps
            assert _scaled_err(a, b) <= ENTRY_TOL, n_steps


def test_square_root_form_on_the_card(cuda_device):
    """The square-root form on the card: the batched solve's packed factors
    and the stationary solve's dense ones square to the standard form's
    covariances (given the squared prior) within 1e-5 of the largest, and
    a batched likelihood's value is the standard form's bitwise."""
    cfg, thetas, inits = _lanes("lorenz", 200, 2.0, 4, 9, cuda_device)
    w, v = cfg["prior_pars"]
    factor = torch.linalg.cholesky(v.double()).float()
    squared = (w, fk.normalize_prior_pars("sqrt", (w, factor))[1])
    batch = dict(thetas=thetas, ode_weight=cfg["ode_weight"],
                 ode_inits=inits, t_min=0.0, t_max=2.0, n_steps=200,
                 model="lorenz")
    mean_s, var_s = fk.solve_mv_fused_batch(prior_pars=squared, **batch)
    mean_q, fac_q = fk.solve_mv_fused_batch(prior_pars=(w, factor),
                                            kalman_type="sqrt", **batch)
    assert torch.equal(mean_q, mean_s)
    for b in range(thetas.shape[0]):
        L = fk.unpack_chol(fac_q[..., b])
        gram = L @ L.mT
        ref = fk.unpack_cov(var_s[..., b])
        assert (gram - ref).abs().max() <= 1e-5 * ref.abs().max(), b
    single = dict(theta=cfg["theta"], ode_weight=cfg["ode_weight"],
                  ode_init=cfg["ode_init"], t_min=0.0, t_max=2.0,
                  n_steps=200, model="lorenz")
    mean_s, var_s = fk.solve_mv_fused_stationary(prior_pars=squared,
                                                 **single)
    mean_q, fac_q = fk.solve_mv_fused_stationary(prior_pars=(w, factor),
                                                 kalman_type="sqrt", **single)
    assert torch.equal(mean_q, mean_s)
    assert (fac_q @ fac_q.mT - var_s).abs().max() \
        <= 1e-5 * var_s.abs().max()
    obs = dict(obs_data=torch.ones(5, 3, 1, device=cuda_device),
               obs_times=torch.linspace(0.0, 2.0, 5, device=cuda_device),
               obs_weight=torch.zeros(5, 3, 1, 3, device=cuda_device)
               .index_fill_(-1, torch.tensor([0], device=cuda_device), 1.0))
    var = torch.full((5, 3, 1, 1), 0.1, device=cuda_device)
    ll_s = fd.dalton_fused_batch(prior_pars=squared, obs_var=var * var,
                                 **batch, **obs)
    ll_q = fd.dalton_fused_batch(prior_pars=(w, factor), obs_var=var,
                                 kalman_type="sqrt", **batch, **obs)
    assert torch.equal(ll_q, ll_s)


def test_stationary_entry_point_launches_its_kernels(cuda_device):
    """solve_mv_fused_stationary on both schedules launches exactly its
    kernels, and agrees with the same call on the CPU (the twins)."""
    for n_steps, expected in (
            (600, {"filter_single": 1, "mean_boundary_single": 1,
                   "mean_recovery_single": 1, "smoother_single": 1}),
            (150, {"filter_single": 1, "mean_gain_single": 1,
                   "smoother_single": 1})):
        def call(device):
            cfg = lorenz.setup(n_steps=n_steps, t_max=0.002 * n_steps,
                               device=device)
            return fk.solve_mv_fused_stationary(
                cfg["theta"], cfg["ode_weight"], cfg["ode_init"], 0.0,
                0.002 * n_steps, n_steps, cfg["prior_pars"], model="lorenz",
                device=device)

        _reset_launches()
        out = call(cuda_device)
        torch.cuda.synchronize()
        assert _launched() == expected, n_steps
        cpu = call(torch.device("cpu"))
        assert _launched() == expected, n_steps
        for a, b in zip(out, cpu):
            assert a.is_cuda and torch.isfinite(a).all(), n_steps
            assert _scaled_err(a, b) <= ENTRY_TOL, n_steps


def _magi_lanes(n_steps, n_lane, act, device, sig2=False):
    """MAGI's operands on the cached Lorenz63 truth path plus seeded
    roughness, its prior's process noise scaled by 1e-5 (a discriminating
    density), dt = 0.005: the lane-batched subsets and the call's
    arguments."""
    truth = np.load(Path(__file__).resolve().parents[1]
                    / ".bench_ref_v8.npz")["solve_mu_4k"][:n_steps + 1]
    rng = np.random.default_rng(12)
    base = truth[:, :, :2]
    subs = np.stack([base + 0.1 * rng.standard_normal(base.shape)
                     for _ in range(n_lane)])
    cfg = lorenz.setup(n_steps=n_steps, t_max=0.005 * n_steps,
                       dtype=torch.float32, device=device)
    wgt, var = cfg["prior_pars"]
    sig2_lanes = torch.tensor(rng.uniform(0.5, 2.0, n_lane),
                              dtype=torch.float32) if sig2 else None
    return torch.tensor(subs, dtype=torch.float32, device=device), dict(
        ode_expand=lambda u: torch.cat([u, torch.zeros_like(u[..., :1])],
                                       -1),
        n_active=act, prior_pars=(wgt, var * 1e-5), dt=0.005,
        sig2_lanes=sig2_lanes)


@pytest.mark.parametrize("act,sig2", [(1, False), (2, False), (3, False),
                                      (2, True)])
def test_magi_kernels_match_their_twins_on_the_card(cuda_device, act, sig2):
    """K10a (both emits, bitwise) and K10b on K10a's streams against their
    twins."""
    subs, kw = _magi_lanes(300, 96, act, cuda_device, sig2)
    paths = kw["ode_expand"](subs)
    q_const, _, R, x, m0 = fm._magi_operands(
        paths, act, kw["prior_pars"], kw["dt"], kw["sig2_lanes"])
    ld = fm.magi_filter_batch(x, R, m0, q_const, emit="ld")
    out = fm.magi_filter_batch(x, R, m0, q_const, emit="adjoint")
    plain = fm._magi_batch_plain(x, R, m0, q_const, "adjoint")
    assert torch.isfinite(ld).all()
    assert torch.equal(ld, out[0])
    assert _scaled_err(ld, fd._block_sum(plain[0])) <= TWIN_TOL
    assert torch.equal(ld, fd._block_sum(plain[0]))
    for a, b in zip(out[1:], plain[1:]):
        assert _scaled_err(a, b) <= TWIN_TOL
        assert torch.equal(a, b)
    streams = out[1:] if act < 3 else (*out[1:], None)
    for a, b in zip(fm.magi_adjoint_batch(*streams, q_const),
                    fm._magi_adjoint_batch_plain(*streams, q_const)):
        assert torch.isfinite(a).all()
        assert _scaled_err(a, b) <= TWIN_TOL


@pytest.mark.parametrize("n_lane,offset", [(37, 0), (64, 1), (100, 0)])
@pytest.mark.parametrize("act", [1, 2, 3])
def test_magi_adjoint_stream_is_bitwise_its_twin_on_the_card(cuda_device,
                                                             act, n_lane,
                                                             offset):
    """K10b, a reverse stream with a consumer and a producer warp, bitwise
    against its twin on K10a's streams at 1, 2, 5, 9, 25, 49 and 300 steps
    (within a stage of 24 steps, one step past one and past two, many
    stages with a ragged last one), and at 4000 at 64 and 100 lanes; where the columns end inside a CTA (37 and 100 lanes of
    3 blocks), where n_lane x 3 is no multiple of 4 (37) and where every
    operand starts 4 bytes past a 16-byte boundary (offset 1): the last two
    copy and store 4 bytes at a time.  Its launch as the card reports it:
    CTAs of 64 threads, all resident, no local memory, at 2048 lanes at
    least one CTA per SM."""
    nb = 3
    geo = fm._magi_adjoint_batch_geometry(nb, n_lane, act,
                                          device=cuda_device)
    assert (geo["cta_x"], geo["cta_y"], geo["grid_y"]) == (64, 1, 1), geo
    assert geo["grid_x"] == -(-nb * n_lane // geo["columns_per_cta"]), geo
    assert geo["local_bytes"] == 0 and geo["all_resident"], geo
    assert fm._magi_adjoint_batch_geometry(nb, 2048, act,
                                           device=cuda_device)[
        "ctas_at_least_sms"]
    for n_steps in (1, 2, 5, 9, 25, 49, 300) + ((4000,) if n_lane != 37
                                                else ()):
        subs, kw = _magi_lanes(n_steps, n_lane, act, cuda_device)
        q_const, _, R, x, m0 = fm._magi_operands(
            kw["ode_expand"](subs), act, kw["prior_pars"], kw["dt"], None)
        _, *streams = fm.magi_filter_batch(x, R, m0, q_const, emit="adjoint")
        streams = [_put(t.cpu().numpy(), cuda_device, offset)
                   for t in streams] + ([None] if act == 3 else [])
        _reset_launches()
        out = fm.magi_adjoint_batch(*streams, q_const)
        assert _launched() == {"magi_adjoint_batch": 1}, n_steps
        plain = fm._magi_adjoint_batch_plain(*streams, q_const)
        for name, a, b in zip(["gx", "lam0"], out, plain):
            assert torch.isfinite(a).all(), (name, n_steps)
            assert torch.equal(a, b), (name, n_steps)


def test_magi_entry_points_launch_their_kernels(cuda_device):
    """magi_fused_batch launches K10a once and magi_fused_batch_grad K10a and
    K10b once each, with the value call's values bitwise; both agree with
    the same calls on the CPU (the plain twins)."""
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        subs, kw = _magi_lanes(300, 64, 2, device)
        _reset_launches()
        ld = fm.magi_fused_batch(subs, **kw, device=device)
        torch.cuda.synchronize()
        assert _launched() == ({"magi_batch": 1} if device.type == "cuda"
                               else {})
        _reset_launches()
        ld_g, g = fm.magi_fused_batch_grad(subs, **kw, device=device)
        torch.cuda.synchronize()
        assert _launched() == ({"magi_batch": 1, "magi_adjoint_batch": 1}
                               if device.type == "cuda" else {})
        assert torch.equal(ld, ld_g)
        assert torch.isfinite(g).all() and g.shape == subs.shape
        out[device.type] = (ld, g)
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.is_cuda
        assert _scaled_err(a, b) <= TWIN_TOL


@pytest.mark.parametrize("n_lane", [64, 37, 100])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_daltonng_kernels_match_their_twins_on_the_card(cuda_device, model,
                                                        n_lane):
    """K9 and K11d (Lorenz63 EK1 with Gaussian data, FitzHugh-Nagumo EK0
    with Poisson counts, data every 10th step) against their twins on the
    same CUDA inputs, per output and tangent direction; K9, one thread per
    (lane, block), and K11d, one thread per (lane, direction, block), with
    a barrier a step, bitwise, also where the lanes end inside a CTA (37
    and 100 lanes), and K11d's values K9's bitwise."""
    mode, t_max, obs = _NN_MODELS[model]
    n_steps = 300
    cfg, thetas, inits = _lanes(model, n_steps, t_max, n_lane, 6,
                                cuda_device)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    n_block = cfg["ode_weight"].shape[0]
    rng = np.random.default_rng(7)
    mask = torch.zeros(n_steps, device=cuda_device)
    mask[9::10] = 1.0
    y = torch.tensor(rng.poisson(3.0, size=(n_steps, n_block)),
                     dtype=torch.float32, device=cuda_device)
    grid = dict(y=y * mask[:, None], iobs=torch.cumsum(mask, 0) * mask,
                mask=mask)
    fused = fk.resolve_model(model)
    value = fdn.filter_nn_batch(fused, obs, (0,), n_steps, **ops, **grid,
                                mode=mode)
    twin = fdn._filter_nn_batch_plain(fused, obs, (0,), n_steps, **ops,
                                      **grid, mode=mode)
    for a, b in zip(value, twin):
        assert a.is_cuda and torch.isfinite(a).all()
        assert _scaled_err(a, b) <= TWIN_TOL
        assert torch.equal(a, b)
    tan = fdn.filter_nn_batch_tan(fused, obs, (0,), n_steps, **ops, **grid,
                                  mode=mode)
    tan_twin = fdn._filter_nn_batch_tan_plain(fused, obs, (0,), n_steps,
                                              **ops, **grid, mode=mode)
    for a, b, v, k in zip(tan, tan_twin, value, (3, 6, 3, 6)):
        assert torch.equal(a[:, :k], v)
        assert max(_split_err(a, b, k)) <= TWIN_TOL
        assert torch.equal(a, b)


def test_daltonng_entry_points_launch_their_kernels(cuda_device):
    """daltonng_fused_batch launches K9, K2r and K1 once each, and its
    gradient K11d, K11e and K11a once each, with the value call's values
    bitwise; both agree with the same calls on the CPU (the plain twins)
    by the JAX package's rules for its fused float32 path (value 5e-3
    relative; gradient cosine > 0.99, norm ratio 0.9-1.1).  The kernels
    match their twins bitwise, but the masked log-densities' keep rule
    turns the different rounding of PyTorch's elementwise functions on the
    two devices into whole flipped directions (measured 2.9e-4 in value)."""
    n_steps, t_max, B = 200, 2.0, 32
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        cfg, thetas, inits = _lanes("lorenz", n_steps, t_max, B, 8, device)
        rng = np.random.default_rng(9)
        args = (thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
                cfg["prior_pars"],
                torch.tensor(rng.normal(size=(5, 3, 1)) * 5,
                             dtype=torch.float32),
                torch.linspace(0.0, t_max, 5), obs_models.gauss(0.005), (0,),
                "lorenz")
        cuda = device.type == "cuda"
        _reset_launches()
        ll = fdn.daltonng_fused_batch(*args, device=device)
        torch.cuda.synchronize()
        assert _launched() == ({"filter_nn_batch": 1, "smoother_batch_rows": 1,
                                "filter_batch": 1} if cuda else {})
        _reset_launches()
        ll_g, grad = fdn.daltonng_fused_batch_grad(*args, device=device)
        torch.cuda.synchronize()
        assert _launched() == ({"filter_nn_batch_tan": 1,
                                "smoother_mean_batch_tan": 1,
                                "filter_batch_tan": 1} if cuda else {})
        assert torch.equal(ll, ll_g)
        assert torch.isfinite(grad).all() and grad.shape == (B, 3)
        out[device.type] = (ll.double().cpu(), grad.double().cpu())
    (ll, grad), (ll_c, grad_c) = out["cuda"], out["cpu"]
    assert ((ll - ll_c).abs() / ll_c.abs()).max() <= 5e-3
    cos = (grad * grad_c).sum(1) / (grad.norm(dim=1) * grad_c.norm(dim=1))
    ratio = grad.norm(dim=1) / grad_c.norm(dim=1)
    assert (cos > 0.99).all() and ((ratio > 0.9) & (ratio < 1.1)).all()


# --- the torch-op surface on the card, float64 ------------------------------


def _torch_op_fixture(device, n_steps=100, t_max=1.0):
    """Lorenz63 EK1 in float64 with 6 observations of x, y and z."""
    cfg = lorenz.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float64,
                       device=device)
    theta = cfg.pop("theta")
    n_obs = 6
    weight = torch.zeros((n_obs, 3, 1, 3), dtype=torch.float64,
                         device=device)
    weight[..., 0] = 1.0
    data = np.random.default_rng(0).normal(size=(n_obs, 3, 1)) * 5
    obs = dict(obs_data=torch.tensor(data, device=device),
               obs_times=torch.tensor(np.arange(n_obs) * (t_max / 5)),
               obs_weight=weight,
               obs_var=torch.full((n_obs, 3, 1, 1), 0.005,
                                  dtype=torch.float64, device=device))
    return cfg, theta, obs


def _b_loglik(obs_data, ode_data, **params):
    return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


@pytest.mark.parametrize("name", ["fenrir", "dalton", "basic"])
def test_torch_op_likelihoods_on_the_card(cuda_device, name):
    """ops.precond.fenrir, dalton and basic in float64 on CUDA tensors
    return CUDA tensors, and their values and torch.autograd gradients are
    the CPU's to 1e-9 relative (the same float64 operations, cuBLAS's
    sums against the CPU's)."""
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.ops import precond
    out = {}
    for device in ("cpu", cuda_device):
        cfg, theta, obs = _torch_op_fixture(device)
        th = theta.clone().requires_grad_(True)
        if name == "basic":
            val = precond.basic(key=None, interrogate=interrogate_kramer,
                                theta=th, obs_data=obs["obs_data"],
                                obs_times=obs["obs_times"],
                                obs_loglik=_b_loglik, **cfg)[0]
        else:
            val = getattr(precond, name)(key=None,
                                         interrogate=interrogate_kramer,
                                         theta=th, **obs, **cfg)
        (grad,) = torch.autograd.grad(val, th)
        assert val.device.type == grad.device.type == torch.device(
            device).type
        out[str(device)] = (val.item(), grad.cpu())
    (v_cpu, g_cpu), (v_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    assert abs(v_gpu - v_cpu) <= 1e-9 * abs(v_cpu)
    assert torch.linalg.norm(g_gpu - g_cpu) <= 1e-9 * torch.linalg.norm(
        g_cpu)


@pytest.mark.parametrize("method", ["svd", "eigh"])
def test_torch_op_solve_sim_on_the_card(cuda_device, method):
    """ops.precond.solve_sim in float64 with a CUDA generator: a CUDA path,
    finite, starting at x0; the same normals as a tensor give the same
    path."""
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.ops import precond
    cfg, theta, _ = _torch_op_fixture(cuda_device)
    x = precond.solve_sim(key=torch.Generator(cuda_device).manual_seed(0),
                          interrogate=interrogate_kramer, theta=theta,
                          method=method, **cfg)
    assert x.is_cuda and torch.isfinite(x).all()
    assert torch.allclose(x[0], cfg["ode_init"], rtol=1e-15, atol=0)
    z = torch.randn((100, 3, 3), dtype=torch.float64, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(0))
    y = precond.solve_sim(key=z, interrogate=interrogate_kramer, theta=theta,
                          method=method, **cfg)
    assert torch.equal(x, y)


def test_torch_op_linalg_on_the_card(cuda_device):
    """The switch's closed forms and the eigen factor on CUDA tensors
    against the same calls on the CPU."""
    from rodeo_tpu_torch.ops import linalg
    rng = np.random.default_rng(1)
    a = rng.standard_normal((50, 7, 7))
    cov = a @ np.swapaxes(a, -1, -2) + 7 * np.eye(7)
    b = rng.standard_normal((50, 7, 2))
    for n in (3, 7):
        args = [torch.tensor(cov[:, :n, :n]), torch.tensor(b[:, :n])]
        with linalg.fast_linalg():
            ref = linalg.solve_psd(*args)
            got = linalg.solve_psd(*(x.to(cuda_device) for x in args))
        assert got.is_cuda and _scaled_err(got, ref) <= 1e-12
    c = torch.tensor(cov[:, :3, :3], device=cuda_device, requires_grad=True)
    f = linalg.psd_factor_eigh(c)
    assert _scaled_err(f @ f.mT, c) <= 1e-12
    (g,) = torch.autograd.grad(f.sum(), c)
    assert g.is_cuda and torch.isfinite(g).all()


# --- the instances taken last: schober, chkrebtii, q = 4, 5, Chkrebtii's ODE,
# Hes1 and SEIRAH ---------------------------------------------------------------

_NEW_INSTANCES = cov_ref.new_filter_instances()


@pytest.mark.parametrize("functor,mode,q", _NEW_INSTANCES,
                         ids=["-".join(map(str, k)) for k in _NEW_INSTANCES])
def test_new_filter_instances_are_bitwise_their_twins(cuda_device, functor,
                                                      mode, q):
    """Each instance of K1 and K3 that this slice added, bitwise against its
    twin: K1 on 37 lanes (a ragged lane group), K3 on lane 0
    (tools/torch_coverage_reference.py's INSTANCE_CHECKS)."""
    case = cov_ref.instance_case(functor, mode, q, 37, cuda_device, seed=7)
    outs = cov_ref.filter_instance_outputs(case, mode)
    torch.cuda.synchronize()
    for kernel_out, twin_out in outs:
        for k, p in zip(kernel_out, twin_out):
            assert torch.isfinite(p).all()
            assert torch.equal(k, p)


@pytest.mark.parametrize("q", [4, 5])
def test_smoothers_at_q45_are_bitwise_their_twins(cuda_device, q):
    """K2r and K4 at q = 4 and 5 on seeded rows, bitwise; their C entries
    refuse q = 2 and 6, and K1's and K3's an instance they do not hold."""
    rng = np.random.default_rng(q)
    pairs, _ = fk._tri_idx(q)
    T, nb, B = 200, 3, 37

    def t(a):
        return torch.tensor(a, dtype=torch.float32,
                            device=cuda_device).contiguous()

    A = rng.standard_normal((T, nb, B, q, q))
    Lf = A @ np.swapaxes(A, -1, -2)
    sc = np.linspace(1.0, 0.1, q)
    rows = [t(rng.standard_normal((T, q, nb, B))),
            t(np.eye(q).reshape(1, q * q, 1, 1) * 0.5
              + 0.1 * rng.standard_normal((T, q * q, nb, B))),
            t(np.stack([Lf[..., i, j] for i, j in pairs], axis=1)),
            t(rng.standard_normal((q, nb, B))),
            t(np.abs(rng.standard_normal((len(pairs), nb, B)))),
            t(rng.standard_normal((q, nb, B))), t(sc),
            t([sc[i] * sc[j] for i, j in pairs])]
    for a, b in zip(fk.smoother_recursion_batch_rows(*rows),
                    fk._smoother_batch_rows_plain(*rows)):
        assert torch.equal(a, b)
    for n_block in (1, 3, 7):
        single = [t(rng.standard_normal((T, n_block, q))),
                  t(np.eye(q).reshape(1, 1, q * q) * 0.5
                    + 0.1 * rng.standard_normal((T, n_block, q * q))),
                  t(np.abs(rng.standard_normal((T, n_block, len(pairs))))),
                  t(rng.standard_normal((n_block, q))),
                  t(np.abs(rng.standard_normal((n_block, len(pairs)))))]
        for a, b in zip(fk.smoother_recursion(*single),
                        fk._smoother_single_plain(*single)):
            assert torch.equal(a, b)
    lib = fk._build.load()
    qc = fk._host_qconst([[1.0] * 5] * 5)
    for q_bad in (2, 6):
        assert lib.rodeo_smoother_batch_rows(q_bad, 4, 1, 1, *([None] * 9),
                                             None) != 0
        assert lib.rodeo_smoother_single(q_bad, 4, 1, *([None] * 7),
                                         None) != 0
    for model, mode, q_k in ((0, 0, 4), (2, 0, 3), (5, 0, 3), (0, 4, 3),
                             (3, 0, 5), (0, 3, 3)):
        assert lib.rodeo_filter_batch(model, mode, q_k, 4, 2,
                                      ctypes.addressof(qc), *([None] * 12),
                                      None) != 0
        assert lib.rodeo_filter_single(model, mode, q_k, 4,
                                       ctypes.addressof(qc), *([None] * 11),
                                       None) != 0


@pytest.mark.parametrize("mode", ["schober", "chkrebtii"])
def test_new_modes_launch_their_kernels(cuda_device, mode):
    """solve_mv_fused_batch, solve_mv_fused, fenrir_fused_batch and
    fenrir_fused under schober and chkrebtii launch K1 and K2r, K3 and K4,
    K1 and K7b, K3 and K7a, once each, and agree with the same call on the
    CPU given the same normals (ENTRY_TOL)."""
    sigma = 10.0 if mode == "chkrebtii" else 5e7
    cfg = lorenz.setup(n_steps=100, t_max=1.0, prior_sigma=sigma,
                       dtype=torch.float32, device="cpu")
    thetas = cfg["theta"].expand(5, 3).contiguous()
    inits = cfg["ode_init"].expand(5, 3, 3).contiguous()
    g = torch.Generator().manual_seed(3)
    eps = torch.randn((100, 3, 3, 5), generator=g)
    eps_one = eps[..., 0].permute(0, 2, 1).contiguous()
    batch = (thetas, cfg["ode_weight"], inits, 0.0, 1.0, 100,
             cfg["prior_pars"])
    one = (cfg["theta"], cfg["ode_weight"], cfg["ode_init"], 0.0, 1.0, 100,
           cfg["prior_pars"])
    calls = {
        "solve_mv_fused_batch": (
            lambda dev: fk.solve_mv_fused_batch(
                *batch, "lorenz", interrogation=mode, device=dev, eps=eps),
            {"filter_batch": 1, "smoother_batch_rows": 1}),
        "solve_mv_fused": (
            lambda dev: fk.solve_mv_fused(
                *one, "lorenz", interrogation=mode, device=dev, eps=eps_one),
            {"filter_single": 1, "smoother_single": 1}),
        "fenrir_fused_batch": (
            lambda dev: (ff.fenrir_fused_batch(
                *batch, **_obs("lorenz", 11, 1.0, dev), model="lorenz",
                interrogation=mode, device=dev, eps=eps),),
            {"filter_batch": 1, "fenrir_backward_batch": 1}),
        "fenrir_fused": (
            lambda dev: (ff.fenrir_fused(
                *one, **_obs("lorenz", 11, 1.0, dev), model="lorenz",
                interrogation=mode, device=dev, eps=eps_one),),
            {"filter_single": 1, "fenrir_backward_single": 1})}
    for name, (call, launched) in calls.items():
        _reset_launches()
        card = call(cuda_device)
        torch.cuda.synchronize()
        assert _launched() == launched, name
        _reset_launches()
        cpu = call("cpu")
        assert not _launched(), name
        for a, b in zip(card, cpu):
            assert a.is_cuda and torch.isfinite(a).all(), name
            assert _scaled_err(a, b) <= ENTRY_TOL, name


# --- the value path's instances taken last: K6, K7a, K7b and K8 at q = 4, 5
# and on Hes1, SEIRAH and Chkrebtii's ODE -------------------------------------

def _spills(*parts):
    """ptxas' (spill stores, spill loads) in bytes of each instantiation
    whose mangled name holds every one of ``parts``, from the build's log."""
    import re
    rows, hit = [], False
    for line in (fk._build.build_log() or "").splitlines():
        if "Compiling entry function" in line:
            hit = all(p in line for p in parts)
        elif hit and "spill stores" in line:
            rows.append(tuple(int(v) for v in
                              re.findall(r"(\d+) bytes spill", line)))
    return rows


@pytest.mark.parametrize("q", [4, 5])
def test_value_streams_at_q45_are_bitwise_their_twins(cuda_device, q):
    """K6, K7b and K7a at q = 4 and 5, bitwise against their twins on
    seeded operands: K6 and K7b over 3 blocks x 37 lanes (the columns end
    inside a CTA of 32, and 111 columns copy 4 bytes at a time) and 64
    lanes with every operand 4 bytes past a 16-byte boundary, at 1, 2, the
    ring and one, and 300 steps, K7b with data at every third step; K7a
    at 1, 3 and 7 blocks (two CTAs) over 1, 2, 129 and 300 steps, across
    its 128-step stages.  Their launches as the card reports them: all
    resident, K6's and K7a's ring in dynamic shared memory sized from q,
    no spills; the C entries refuse q = 2 and 6."""
    rng = np.random.default_rng(200 + q)
    nt = q * (q + 1) // 2
    geo6 = fs._sampler_batch_geometry(3 * 2048, q, device=cuda_device)
    geo7 = ff._fenrir_backward_batch_geometry(3, 2048, q, device=cuda_device)
    for geo in (geo6, geo7):
        assert (geo["cta_x"], geo["cta_y"]) == (64, 1), geo
        assert geo["all_resident"] and geo["ctas_at_least_sms"], geo
    assert geo6["shared_bytes"] == 4 * 32 * geo6["steps_per_stage"] * (
        geo6["stages"] * (q + q * q) + 2 * q), geo6
    for n_lane, offset in ((37, 0), (64, 1)):
        step = geo6["steps_per_stage"]
        for n_len in (1, 2, geo6["stages"] * step + 1, 300):
            args = [_put(a, cuda_device, offset) for a in (
                rng.standard_normal((n_len, q, 3, n_lane)),
                np.eye(q).reshape(1, q * q, 1, 1) * 0.8
                + 0.1 * rng.standard_normal((n_len, q * q, 3, n_lane)),
                rng.standard_normal((q, 3, n_lane)))]
            _reset_launches()
            k6 = fs.sampler_batch(*args)
            assert _launched() == {"sampler_batch": 1}
            assert torch.equal(k6, fs._sampler_batch_plain(*args)), n_len
        step = geo7["steps_per_stage"]
        for n_steps in (1, 2, geo7["stages"] * step + 1, 300):
            mask = (np.arange(n_steps) % 3 == 0).astype(np.float64)
            chain = [_put(a, cuda_device, offset) for a in (
                np.eye(q).reshape(1, q * q, 1, 1) * 0.8
                + 0.1 * rng.standard_normal((n_steps, q * q, 3, n_lane)),
                rng.standard_normal((n_steps, q, 3, n_lane)),
                np.moveaxis(_packed_psd(rng, (n_steps, 3, n_lane), q, 0.3),
                            -1, 1),
                rng.standard_normal((n_steps, q, 3)) * mask[:, None, None],
                rng.standard_normal((n_steps, 3)) * mask[:, None],
                np.where(mask[:, None] > 0, 0.1 + rng.random((n_steps, 3)),
                         1.0),
                mask, rng.standard_normal((q, 3, n_lane)),
                np.moveaxis(_packed_psd(rng, (3, n_lane), q), -1, 0),
                rng.standard_normal(n_lane))]
            _reset_launches()
            k7 = ff.fenrir_backward_batch(*chain)
            assert _launched() == {"fenrir_backward_batch": 1}
            p7 = chain[-1] + fd._block_sum(ff._fenrir_backward_plain(
                *chain[:-1], skip_unobserved=True))
            assert torch.isfinite(k7).all() and torch.equal(k7, p7), n_steps
    for n_block in (1, 3, 7):
        geo = ff._fenrir_backward_single_geometry(n_block, q,
                                                  device=cuda_device)
        assert geo["rows_per_stage"] == 128 and geo["all_resident"], geo
        for n_steps in (1, 2, 129, 300):
            mask = (np.arange(n_steps) % 3 == 0).astype(np.float64)
            chain = [_put(a, cuda_device, 0) for a in (
                np.eye(q).reshape(1, 1, q * q) * 0.8
                + 0.1 * rng.standard_normal((n_steps, n_block, q * q)),
                rng.standard_normal((n_steps, n_block, q)),
                _packed_psd(rng, (n_steps, n_block), q, 0.3),
                rng.standard_normal((n_steps, q, n_block))
                * mask[:, None, None],
                rng.standard_normal((n_steps, n_block)) * mask[:, None],
                np.where(mask[:, None] > 0,
                         0.1 + rng.random((n_steps, n_block)), 1.0),
                mask, rng.standard_normal((n_block, q)),
                _packed_psd(rng, (n_block,), q), rng.standard_normal(1))]
            chain[-1] = chain[-1][0]
            _reset_launches()
            k7 = ff.fenrir_backward_single(*chain)
            assert _launched() == {"fenrir_backward_single": 1}
            p7 = chain[-1] + fd._block_sum(
                ff._fenrir_backward_single_plain(*chain[:-1]))
            assert torch.isfinite(k7) and torch.equal(k7, p7), n_steps
    for sym in ("20sampler_batch_kernel", "22fenrir_backward_kernel",
                "29fenrir_backward_single_kernel"):
        rows = _spills(sym, f"ILi{q}E")
        assert rows and all(r == (0, 0) for r in rows), (sym, rows)
    lib = fk._build.load()
    for q_bad in (2, 6):
        assert lib.rodeo_sampler_batch(q_bad, 4, 4, *([None] * 5)) != 0
        assert lib.rodeo_fenrir_backward_batch(q_bad, 4, 1, 4,
                                               *([None] * 11)) != 0
        assert lib.rodeo_fenrir_backward_single(q_bad, 4, 1,
                                                *([None] * 11)) != 0
    qc = fk._host_qconst([[1.0] * 5] * 5)
    for model, mode, q_k in ((0, 0, 4), (2, 0, 3), (3, 2, 3), (2, 3, 4),
                             (5, 0, 3)):
        assert lib.rodeo_dalton_filter_batch(
            model, mode, q_k, 1, 4, 2, ctypes.addressof(qc),
            *([None] * 13)) != 0


_NEW_K8 = sorted(
    fk._INSTANCES["dalton_filter_batch"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))


def _dalton_instance_case(functor, mode, q, device):
    """The K8 and K11c operands of the instance (functor, mode, q) on 37
    lanes (a ragged lane group) of the functor's INSTANCE_CHECKS setup
    (tools/torch_coverage_reference.py), observed in derivative 0 of every
    block at 5 times from t = 0 to its end, so that the launch with data
    holds steps with data: ``(case, ops, grid, ld0)``."""
    case = cov_ref.instance_case(functor, mode, q, 37, device, seed=7)
    cfg, n = case["cfg"], case["n_steps"]
    thetas = case["batch"]["theta_lanes"].T.contiguous()
    inits = cfg["ode_init"].expand((37,) + cfg["ode_init"].shape)
    nb = case["fused"].n_block
    rng = np.random.default_rng(q)
    weight = torch.zeros((5, nb, 1, q), device=device)
    weight[..., 0] = 1.0
    x0 = cfg["ode_init"][:, 0]
    obs = (x0[None, :, None] * (1 + 0.01 * torch.tensor(
               rng.standard_normal((5, nb, 1)), dtype=torch.float32,
               device=device)),
           torch.linspace(0.0, case["config"]["t_max"], 5,
                          dtype=torch.float64), weight,
           torch.full((5, nb, 1, 1), 0.005, device=device))
    ops, grid, ld0 = fd._dalton_prepare(thetas, cfg["ode_weight"], inits,
                                        0.0, case["config"]["t_max"], n,
                                        cfg["prior_pars"], *obs)
    assert (grid["mask"] != 0).any()
    return case, ops, grid, ld0


@pytest.mark.parametrize("functor,mode,q", _NEW_K8,
                         ids=["-".join(map(str, k)) for k in _NEW_K8])
def test_new_dalton_instances_are_bitwise_their_twins(cuda_device, functor,
                                                      mode, q):
    """Each instance of K8 that this slice added, with and without data,
    bitwise against its twin on 37 lanes (a ragged lane group) of the
    functor's INSTANCE_CHECKS setup (tools/torch_coverage_reference.py),
    observed in derivative 0 of every block at 5 times; at 2048 lanes all
    resident, and ptxas spills nothing in it."""
    case, ops, grid, ld0 = _dalton_instance_case(functor, mode, q,
                                                 cuda_device)
    n, nb = case["n_steps"], case["fused"].n_block
    for with_obs in (True, False):
        args = dict(**ops, **grid, mode=mode, with_obs=with_obs,
                    ld0=ld0 if with_obs else torch.zeros_like(ld0))
        _reset_launches()
        k8 = fd.dalton_filter_batch(case["fused"], n, **args)
        assert _launched() == {"dalton_filter_batch": 1}
        p8 = fd._dalton_filter_plain(case["fused"], n, **args)
        assert torch.isfinite(p8).all(), with_obs
        assert torch.equal(k8, p8), with_obs
        geo = fd._dalton_filter_batch_geometry(
            case["fused"], 2048, mode, with_obs, q, device=cuda_device)
        assert (geo["cta_x"], geo["cta_y"]) == (32, nb), geo
        assert geo["all_resident"], geo
        rows = _spills("20dalton_filter_kernel", f"{len(functor)}{functor}E",
                       f"Li{q}ELi{fk._MODES[mode]}ELb{int(with_obs)}E")
        assert rows and all(r == (0, 0) for r in rows), rows


_VALUE_CASES = [(name, mode) for name in cov_ref.VALUE_FIXTURES
                for mode in cov_ref.VALUE_MODES]


@pytest.mark.parametrize("name,mode", _VALUE_CASES)
def test_value_entries_at_new_instances_launch_their_kernels(cuda_device,
                                                             name, mode):
    """fenrir_fused_batch (K1, K7b), dalton_fused_batch (K8 twice),
    solve_sim_fused_batch (K1, K6) and fenrir_fused (K3, K7a) on each value
    fixture's model and q, at its INSTANCE_CHECKS horizon over 5 lanes:
    their launches, finite, and the same call on the CPU within ENTRY_TOL
    (DALTON at q = 5, rounding-bound, by its two sums);
    the square-root form (the prior's and the data's variances as
    factors) bitwise the standard form's on the squared factors; and on
    Chkrebtii's ODE fenrir_fused_batch and solve_sim_fused_batch under
    chkrebtii, given the interrogations' normals."""
    model, q = cov_ref.FIXTURES[name][:2]
    functor = fk.resolve_model(model).cuda_functor
    _, n, t_max, sigma = cov_ref.INSTANCE_CHECKS[functor]
    rng = np.random.default_rng(q)

    def setup(dev):
        import importlib
        mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
        cfg = mod.setup(n_steps=n, t_max=t_max, prior_sigma=sigma,
                        dtype=torch.float32, device=dev,
                        **({"n_deriv": q} if model == "chkrebtii" else {}))
        theta = cfg.pop("theta")
        theta = torch.zeros(1, device=dev) if theta is None else theta
        noise = torch.tensor(np.random.default_rng(3).standard_normal(
            (5, theta.shape[0])), dtype=torch.float32, device=dev)
        thetas = theta * (1 + 0.01 * noise)
        inits = cfg["ode_init"].expand((5,) + cfg["ode_init"].shape)
        nb = inits.shape[1]
        weight = torch.zeros((5, nb, 1, q), device=dev)
        weight[..., 0] = 1.0
        obs = dict(obs_data=cfg["ode_init"][None, :, 0:1].expand(5, nb, 1)
                   .contiguous(),
                   obs_times=torch.linspace(0.0, t_max, 5,
                                            dtype=torch.float64),
                   obs_weight=weight,
                   obs_var=torch.full((5, nb, 1, 1), 0.005, device=dev))
        return cfg, thetas, inits, obs

    eps = torch.tensor(rng.standard_normal((n - 1, q, 1, 5)),
                       dtype=torch.float32)
    eps_term = torch.tensor(rng.standard_normal((q, 1, 5)),
                            dtype=torch.float32)

    def calls(dev):
        cfg, thetas, inits, obs = setup(dev)
        nb = inits.shape[1]
        lead = (thetas, cfg["ode_weight"], inits, 0.0, t_max, n,
                cfg["prior_pars"])
        kw = dict(model=model, interrogation=mode, device=dev)
        e = eps.expand(n - 1, q, nb, 5).contiguous()
        et = eps_term.expand(q, nb, 5).contiguous()
        return {
            "fenrir_fused_batch": (lambda: ff.fenrir_fused_batch(
                *lead, **obs, **kw), {"filter_batch": 1,
                                      "fenrir_backward_batch": 1}),
            "dalton_fused_batch": (lambda: fd.dalton_fused_batch(
                *lead, **obs, **kw), {"dalton_filter_batch": 2}),
            "solve_sim_fused_batch": (lambda: fs.solve_sim_fused_batch(
                *lead, **kw, eps=e, eps_term=et), {"filter_batch": 1,
                                                   "sampler_batch": 1}),
            "fenrir_fused": (lambda: ff.fenrir_fused(
                thetas[0], cfg["ode_weight"], inits[0], 0.0, t_max, n,
                cfg["prior_pars"], **obs, **kw), {"filter_single": 1,
                                                  "fenrir_backward_single": 1})}

    def dalton_sums(dev):
        """DALTON's two K8 sums, with data and without."""
        cfg, thetas, inits, obs = setup(dev)
        ops, grid, ld0 = fd._dalton_prepare(
            thetas, cfg["ode_weight"], inits, 0.0, t_max, n,
            cfg["prior_pars"], *obs.values())
        return [fd.dalton_filter_batch(
            model, n, **ops, **grid, ld0=ld0 if w else torch.zeros_like(ld0),
            mode=mode, with_obs=w) for w in (True, False)]

    card, cpu = calls(cuda_device), calls("cpu")
    for entry, (call, launched) in card.items():
        _reset_launches()
        out = call()
        torch.cuda.synchronize()
        assert _launched() == launched, entry
        assert out.is_cuda and torch.isfinite(out).all(), entry
        _reset_launches()
        ref = cpu[entry][0]()
        assert not _launched(), entry
        if entry == "dalton_fused_batch" and q == 5:
            # the difference of two sums of ~9e5 whose float32 spacing
            # (0.0625) the card's and the CPU's roundings move it by several
            # times: each sum within ENTRY_TOL, and so the difference
            sums = [(a, b) for a, b in zip(dalton_sums(cuda_device),
                                           dalton_sums("cpu"))]
            for a, b in sums:
                assert _scaled_err(a, b) <= ENTRY_TOL, entry
            scale = max(b.abs().max().item() for _, b in sums)
            assert (out.cpu() - ref).abs().max().item() <= \
                2 * ENTRY_TOL * scale, entry
            continue
        assert _scaled_err(out, ref) <= ENTRY_TOL, entry
    # the square-root form on the squared factors
    cfg, thetas, inits, obs = setup(cuda_device)
    w, v = cfg["prior_pars"]
    factor = torch.linalg.cholesky(v.double()).float()
    squared = (w, fk._gram(factor))
    lead = (thetas, cfg["ode_weight"], inits, 0.0, t_max, n)
    sq_obs = {**obs, "obs_var": obs["obs_var"].sqrt()}
    std_obs = {**obs, "obs_var": fk._gram(sq_obs["obs_var"])}
    for fn in (ff.fenrir_fused_batch, fd.dalton_fused_batch):
        a = fn(*lead, (w, factor), **sq_obs, model=model,
               interrogation=mode, kalman_type="sqrt", device=cuda_device)
        b = fn(*lead, squared, **std_obs, model=model, interrogation=mode,
               device=cuda_device)
        assert torch.equal(a, b), fn.__name__
    if model == "chkrebtii" and mode == "kramer":
        g = torch.Generator(cuda_device).manual_seed(5)
        e_int = torch.randn((n, q, 1, 5), generator=g, device=cuda_device)
        _reset_launches()
        ll = ff.fenrir_fused_batch(*lead, cfg["prior_pars"], **obs,
                                   model=model, interrogation="chkrebtii",
                                   device=cuda_device, eps=e_int)
        path = fs.solve_sim_fused_batch(
            *lead, cfg["prior_pars"], model=model, interrogation="chkrebtii",
            device=cuda_device, eps_int=e_int,
            eps=eps.expand(n - 1, q, 1, 5).to(cuda_device),
            eps_term=eps_term.to(cuda_device))
        torch.cuda.synchronize()
        assert _launched() == {"filter_batch": 2, "fenrir_backward_batch": 1,
                               "sampler_batch": 1}
        assert torch.isfinite(ll).all() and torch.isfinite(path).all()


# --- the gradient path's instances taken last: K11a on every model of K1
# under kramer and rodeo, K11b and K11e at q = 3, 4, 5 and 1-7 directions,
# K1 and K3 on FitzHugh-Nagumo at q = 4 and 5 ---------------------------------

_NEW_K11A = sorted(
    fk._INSTANCES["filter_batch_tan"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))


@pytest.mark.parametrize("functor,mode,q", _NEW_K11A,
                         ids=["-".join(map(str, k)) for k in _NEW_K11A])
def test_new_tangent_filter_instances_are_bitwise_their_twins(cuda_device,
                                                              functor, mode,
                                                              q):
    """Each instance of K11a that this slice added (Hes1's and SEIRAH's
    Jacobian under kramer on nested Duals), bitwise against its twin on 37
    lanes (a ragged lane group) of the functor's INSTANCE_CHECKS setup
    (tools/torch_coverage_reference.py), its values K1's; its launch at
    2048 lanes (CTAs of 32 lanes x the blocks, a grid row per parameter,
    resident on the SMs in waves: SEIRAH's 384 CTAs take two an SM), and
    ptxas spills nothing in it."""
    case = cov_ref.instance_case(functor, mode, q, 37, cuda_device, seed=7)
    ops = {k: v for k, v in case["batch"].items() if k != "eps"}
    fused, n = case["fused"], case["n_steps"]
    _reset_launches()
    k11 = fk.fused_filter_batch_tan(fused, n, **ops, mode=mode)
    assert _launched() == {"filter_batch_tan": 1}
    p11 = fk._filter_batch_tan_plain(fused, n, **ops, mode=mode)
    k1 = fk.fused_filter_batch(fused, n, **ops, mode=mode)
    for a, b, v in zip(k11, p11, k1):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)
        assert torch.equal(a.narrow(a.dim() - 3, 0, v.shape[-3]), v)
    geo = fk._filter_batch_tan_geometry(fused, 2048, mode, q,
                                        device=cuda_device)
    assert (geo["cta_x"], geo["cta_y"]) == (32, fused.n_block), geo
    assert (geo["grid_x"], geo["grid_y"]) == (64, fused.n_theta), geo
    assert geo["ctas_per_sm"] >= 1, geo
    assert geo["all_resident"] == (functor != "Seirah"), geo
    rows = _spills("23filter_batch_tan_kernel", f"{len(functor)}{functor}E",
                   f"Li{q}ELi{fk._MODES[mode]}E")
    assert rows and all(r == (0, 0) for r in rows), rows


_RECURSION_INSTANCES = [(q, n_tan) for q in (3, 4, 5) for n_tan in range(1, 8)]


@pytest.mark.parametrize("q,n_tan", _RECURSION_INSTANCES)
def test_tangent_recursions_are_bitwise_their_twins(cuda_device, q, n_tan):
    """K11b and K11e at q = 3, 4, 5 and 1 to 7 directions, bitwise against
    their twins on seeded augmented chains over 3 blocks x 37 lanes (the
    columns end inside a CTA of 32, and 111 columns copy 4 bytes at a time)
    and 64 lanes with every operand 4 bytes past a 16-byte boundary, at 1
    step, a stage, a stage and one, the ring and one, and 301 steps, data
    at every third step.  Their launches: K11b n_tan consumer warps and a
    producer warp, its ring of 3 stages in dynamic shared memory sized from
    (q, n_tan) (2 steps a stage where that fits 227 KB, else 1); K11e a CTA
    of 64 columns x n_tan directions; neither spills.  The C entries refuse
    q = 2 and 6 and 0 or 8 directions."""
    rng = np.random.default_rng(300 + 10 * q + n_tan)
    nt, n_aug, nb = q * (q + 1) // 2, 1 + n_tan, 3
    geo_b = ff._fenrir_backward_batch_tan_geometry(nb, 2048, n_tan, q,
                                                    device=cuda_device)
    step, stages = geo_b["steps_per_stage"], geo_b["stages"]
    assert (geo_b["cta_x"], geo_b["grid_x"]) == (32 * n_aug, 192), geo_b
    assert stages == 3 and step in (1, 2), geo_b
    assert geo_b["shared_bytes"] == 4 * 32 * stages * step * n_aug * (
        q * q + q + nt), geo_b
    assert geo_b["shared_bytes"] <= 227 * 1024 and geo_b["ctas_per_sm"] >= 1
    geo_e = fk._smoother_mean_batch_tan_geometry(nb * 2048, n_tan, q,
                                                 device=cuda_device)
    assert (geo_e["cta_x"], geo_e["cta_y"]) == (64, n_tan), geo_e
    assert geo_e["all_resident"] and geo_e["local_bytes"] == 0, geo_e

    def aug(v, axis):
        return np.concatenate([v] + [0.1 * rng.standard_normal(v.shape)
                                     for _ in range(n_tan)], axis=axis)

    for n_lane, offset in ((37, 0), (64, 1)):
        for n_steps in (1, step, step + 1, stages * step + 1, 301):
            mask = (np.arange(n_steps) % 3 == 0).astype(np.float64)
            A = np.eye(q).reshape(1, q * q, 1, 1) * 0.8 + \
                0.1 * rng.standard_normal((n_steps, q * q, nb, n_lane))
            chain = [_put(a, cuda_device, offset) for a in (
                aug(A, 1),
                aug(rng.standard_normal((n_steps, q, nb, n_lane)), 1),
                aug(np.moveaxis(_packed_psd(rng, (n_steps, nb, n_lane), q,
                                            0.3), -1, 1), 1),
                rng.standard_normal((n_steps, q, nb)) * mask[:, None, None],
                rng.standard_normal((n_steps, nb)) * mask[:, None],
                np.where(mask[:, None] > 0,
                         0.1 + rng.random((n_steps, nb)), 1.0),
                mask, aug(rng.standard_normal((q, nb, n_lane)), 0),
                aug(np.moveaxis(_packed_psd(rng, (nb, n_lane), q), -1, 0),
                    0),
                rng.standard_normal((n_aug, n_lane)))]
            _reset_launches()
            k11b = ff.fenrir_backward_batch_tan(*chain)
            k11e = fk.smoother_mean_recursion_batch_tan(chain[1], chain[0],
                                                        chain[7], n_tan)
            assert _launched() == {"fenrir_backward_batch_tan": 1,
                                   "smoother_mean_batch_tan": 1}
            p11b = chain[-1] + fd._block_sum(ff._fenrir_backward_tan_plain(
                *chain[:-1], n_tan).movedim(1, 0))
            p11e = fk._smoother_mean_tan_plain(chain[1], chain[0], chain[7],
                                               n_tan)
            assert torch.isfinite(p11b).all() and torch.isfinite(p11e).all()
            assert torch.equal(k11b, p11b), (n_lane, n_steps)
            assert torch.equal(k11e, p11e), (n_lane, n_steps)
    for sym, part in (("26fenrir_backward_tan_kernel", f"ILi{q}ELi{n_tan}E"),
                      ("24smoother_mean_tan_kernel", f"ILi{q}EE")):
        rows = _spills(sym, part)
        assert rows and all(r == (0, 0) for r in rows), (sym, rows)
    lib = fk._build.load()
    for q_k, n_k in ((2, n_tan), (6, n_tan), (q, 0), (q, 8)):
        assert lib.rodeo_fenrir_backward_batch_tan(
            q_k, 4, 1, 4, n_k, *([None] * 11)) != 0
        assert lib.rodeo_smoother_mean_batch_tan(q_k, 4, 4, n_k,
                                                 *([None] * 5)) != 0


_GRAD_CASES = [(name, mode) for name in cov_ref.GRAD_FIXTURES
               for mode in cov_ref.VALUE_MODES]


@pytest.mark.parametrize("name,mode", _GRAD_CASES)
def test_gradient_entries_at_new_instances_launch_their_kernels(cuda_device,
                                                                name, mode):
    """fenrir_fused_batch_grad (K11a, K11b), basic_fused_batch_grad and
    solve_mv_fused_batch_grad (K11a, K11e) on each gradient fixture's model
    and q (tools/torch_coverage_reference.py's GRAD_FIXTURES) at its
    INSTANCE_CHECKS horizon over 5 lanes: their launches, finite, the
    values bitwise their value entries' (K1 + K7b, K1 + K2r) on the card,
    and within ENTRY_TOL of the same calls on the CPU."""
    model, q = cov_ref.GRAD_FIXTURES[name][:2]
    functor = fk.resolve_model(model).cuda_functor
    _, n, t_max, sigma = cov_ref.INSTANCE_CHECKS_Q.get(
        (functor, q), cov_ref.INSTANCE_CHECKS[functor])

    def calls(dev):
        import importlib
        mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
        cfg = mod.setup(n_steps=n, t_max=t_max, prior_sigma=sigma,
                        dtype=torch.float32, device=dev,
                        **({"n_deriv": q} if model in cov_ref.PADDED
                           else {}))
        theta = cfg.pop("theta")
        theta = torch.zeros(1, device=dev) if theta is None else theta
        noise = torch.tensor(np.random.default_rng(3).standard_normal(
            (5, theta.shape[0])), dtype=torch.float32, device=dev)
        thetas = theta * (1 + 0.01 * noise)
        inits = cfg["ode_init"].expand((5,) + cfg["ode_init"].shape)
        nb = inits.shape[1]
        weight = torch.zeros((5, nb, 1, q), device=dev)
        weight[..., 0] = 1.0
        obs = dict(obs_data=cfg["ode_init"][None, :, 0:1].expand(5, nb, 1)
                   .contiguous(),
                   obs_times=torch.linspace(0.0, t_max, 5,
                                            dtype=torch.float64),
                   obs_weight=weight,
                   obs_var=torch.full((5, nb, 1, 1), 0.005, device=dev))
        lead = (thetas, cfg["ode_weight"], inits, 0.0, t_max, n,
                cfg["prior_pars"])
        kw = dict(model=model, interrogation=mode, device=dev)
        basic = dict(obs_data=obs["obs_data"], obs_times=obs["obs_times"],
                     obs_loglik=cov_ref.gauss_loglik(0.005))
        tan_e = {"filter_batch_tan": 1, "smoother_mean_batch_tan": 1}
        return {
            "fenrir": (lambda: ff.fenrir_fused_batch_grad(*lead, **obs, **kw),
                       lambda: ff.fenrir_fused_batch(*lead, **obs, **kw),
                       {"filter_batch_tan": 1,
                        "fenrir_backward_batch_tan": 1}),
            "basic": (lambda: fk.basic_fused_batch_grad(*lead, **basic,
                                                        **kw),
                      lambda: fk.basic_fused_batch(*lead, **basic, **kw),
                      tan_e),
            "solve": (lambda: fk.solve_mv_fused_batch_grad(*lead, **kw),
                      lambda: fk.solve_mv_fused_batch(*lead, **kw), tan_e)}

    card, cpu = calls(cuda_device), calls("cpu")
    for entry, (call, value, launched) in card.items():
        _reset_launches()
        out = call()
        torch.cuda.synchronize()
        assert _launched() == launched, entry
        assert all(o.is_cuda and torch.isfinite(o).all() for o in out), entry
        val = value()
        assert torch.equal(out[0], val if entry == "fenrir" else val[0])
        if entry == "basic":
            assert torch.equal(out[2], val[1])
        _reset_launches()
        ref = cpu[entry][0]()
        assert not _launched(), entry
        for a, b in zip(out, ref):
            # the absolute error where the CPU's is all zero (the gradient
            # of Chkrebtii's ODE, which has no parameter)
            scale = b.abs().max().item()
            err = (a.cpu() - b).abs().max().item()
            assert err <= ENTRY_TOL * (scale if scale > 0 else 1.0), entry


def test_mala_over_fenrir_on_hes1_on_the_card(cuda_device):
    """The lockstep MALA runner over fenrir_fused_batch_grad on Hes1 under
    kramer (K11a, K11b a step, the Jacobian on nested Duals), 16 lanes x 3
    steps on the card: its launches, finite, and its carried log-density
    bitwise a fresh fenrir_fused_batch at the final positions."""
    from rodeo_tpu_torch.models import hes1
    from rodeo_tpu_torch.parallel import chains
    cfg, (thetas, _), obs, _ = cov_ref.grad_fixture("hes1", 16,
                                                    torch.float32,
                                                    cuda_device)
    solver = dict(ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
                  t_min=0.0, t_max=cfg["t_max"], n_steps=cfg["n_steps"],
                  prior_pars=cfg["prior_pars"])
    _reset_launches()
    pos, ll, acc = chains.run_chains_mala_fused(
        thetas, torch.Generator(cuda_device).manual_seed(5), 3, 1e-4,
        model=hes1, likelihood="fenrir", device=cuda_device, **solver, **obs)
    torch.cuda.synchronize()
    assert _launched() == {"filter_batch_tan": 4,
                           "fenrir_backward_batch_tan": 4}
    assert torch.isfinite(pos).all() and torch.isfinite(ll).all()
    fresh = ff.fenrir_fused_batch(
        pos[-1], cfg["ode_weight"],
        cfg["ode_init"].expand((16,) + cfg["ode_init"].shape), 0.0,
        cfg["t_max"], cfg["n_steps"], cfg["prior_pars"], **obs, model="hes1",
        device=cuda_device)
    assert torch.equal(fresh, ll)


# --- DALTON's gradient at every instance of K11a: K11c on every model of K1
# under kramer and rodeo -----------------------------------------------------

_NEW_K11C = sorted(
    fk._INSTANCES["dalton_filter_batch_tan"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))


@pytest.mark.parametrize("functor,mode,q", _NEW_K11C,
                         ids=["-".join(map(str, k)) for k in _NEW_K11C])
def test_new_dalton_tangent_instances_are_bitwise_their_twins(cuda_device,
                                                              functor, mode,
                                                              q):
    """Each instance of K11c that this slice added (Hes1's and SEIRAH's
    Jacobian under kramer on nested Duals), with and without data, bitwise
    against its twin on the operands of test_new_dalton_instances_are_
    bitwise_their_twins, every tangent seed of the log-density a nonzero
    normal, its values K8's; its launch at 2048 lanes (CTAs of 32 lanes x
    the blocks, a grid row per parameter), and ptxas spills nothing in it
    (Chkrebtii's instances keep 32 bytes of stack, as K1's and K8's
    do)."""
    case, ops, grid, ld0 = _dalton_instance_case(functor, mode, q,
                                                 cuda_device)
    fused, n = case["fused"], case["n_steps"]
    n_tan = fused.n_theta
    gen = torch.Generator(cuda_device).manual_seed(q)
    tans = torch.randn((n_tan, ld0.shape[0]), generator=gen,
                       device=cuda_device)
    for with_obs in (True, False):
        seed = ld0 if with_obs else torch.zeros_like(ld0)
        args = dict(**ops, **grid, mode=mode, with_obs=with_obs)
        _reset_launches()
        k11 = fd.dalton_filter_batch_tan(
            fused, n, **args, ld0=torch.cat([seed[None], tans]))
        assert _launched() == {"dalton_filter_batch_tan": 1}
        p11 = fd._dalton_filter_tan_plain(
            fused, n, **args, ld0=torch.cat([seed[None], tans]))
        assert torch.isfinite(p11).all(), with_obs
        assert torch.equal(k11, p11), with_obs
        assert torch.equal(k11[0], fd.dalton_filter_batch(
            fused, n, **args, ld0=seed)), with_obs
        geo = fd._dalton_filter_batch_tan_geometry(
            fused, 2048, mode, with_obs, q, device=cuda_device)
        assert (geo["cta_x"], geo["cta_y"]) == (32, fused.n_block), geo
        assert (geo["grid_x"], geo["grid_y"]) == (64, n_tan), geo
        assert geo["ctas_per_sm"] >= 1, geo
        rows = _spills("24dalton_filter_tan_kernel",
                       f"{len(functor)}{functor}E",
                       f"Li{q}ELi{fk._MODES[mode]}ELb{int(with_obs)}E")
        assert rows and all(r == (0, 0) for r in rows), rows


def test_dalton_entries_refuse_other_instances_on_the_card(cuda_device):
    """The C entries of K8 and K11c return an error for any (model, mode,
    q) that with_filter_instance and with_ek_mode do not list, and the
    Python gate refuses it first on CUDA tensors."""
    lib = fk._build.load()
    qc = fk._host_qconst([[1.0] * 5] * 5)
    for model, mode, q_k in ((0, 0, 4), (2, 0, 3), (3, 2, 3), (2, 3, 4),
                             (1, 0, 6), (4, 1, 4), (5, 0, 3)):
        for entry in (lib.rodeo_dalton_filter_batch,
                      lib.rodeo_dalton_filter_batch_tan):
            assert entry(model, mode, q_k, 1, 4, 2, ctypes.addressof(qc),
                         *([None] * 13)) != 0, (model, mode, q_k)
    cfg, thetas, inits = _lanes("lorenz", 8, 0.08, 4, 5, cuda_device)
    obs = _obs("lorenz", 3, 0.08, cuda_device)
    with pytest.raises(NotImplementedError, match="dalton_filter_batch_tan"):
        fd.dalton_fused_batch_grad(thetas, cfg["ode_weight"], inits, 0.0,
                                   0.08, 8, cfg["prior_pars"], **obs,
                                   model="lorenz", interrogation="schober",
                                   device=cuda_device)


@pytest.mark.parametrize("name,mode", _GRAD_CASES)
def test_dalton_gradient_at_new_instances_launches_its_kernels(cuda_device,
                                                               name, mode):
    """dalton_fused_batch_grad (K11c with and without data) on each
    gradient fixture's model and q (tools/torch_coverage_reference.py's
    GRAD_FIXTURES) at its INSTANCE_CHECKS horizon over 5 lanes, observed at
    5 times: two K11c launches, finite, the values bitwise
    dalton_fused_batch's on the card, the gradient exactly zero on
    Chkrebtii's ODE, and the value and gradient within ENTRY_TOL of the
    same call on the CPU; where float32 does not resolve DALTON
    (DALTON_F32_UNRESOLVED: a difference of float32 sums that a library
    function rounding otherwise on the card moves by whole ulps of the
    sums) the twins in float64 on the same operands on the card within
    ENTRY_TOL of the same on the CPU instead."""
    import importlib
    model, q = cov_ref.GRAD_FIXTURES[name][:2]
    functor = fk.resolve_model(model).cuda_functor
    _, n, t_max, sigma = cov_ref.INSTANCE_CHECKS_Q.get(
        (functor, q), cov_ref.INSTANCE_CHECKS[functor])

    def args(dev):
        mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
        cfg = mod.setup(n_steps=n, t_max=t_max, prior_sigma=sigma,
                        dtype=torch.float32, device=dev,
                        **({"n_deriv": q} if model in cov_ref.PADDED
                           else {}))
        theta = cfg.pop("theta")
        theta = torch.zeros(1, device=dev) if theta is None else theta
        noise = torch.tensor(np.random.default_rng(3).standard_normal(
            (5, theta.shape[0])), dtype=torch.float32, device=dev)
        nb = cfg["ode_init"].shape[0]
        weight = torch.zeros((5, nb, 1, q), device=dev)
        weight[..., 0] = 1.0
        return dict(thetas=theta * (1 + 0.01 * noise),
                    ode_weight=cfg["ode_weight"],
                    ode_inits=cfg["ode_init"].expand(
                        (5,) + cfg["ode_init"].shape),
                    t_min=0.0, t_max=t_max, n_steps=n,
                    prior_pars=cfg["prior_pars"],
                    obs_data=cfg["ode_init"][None, :, 0:1].expand(5, nb, 1)
                    .contiguous(),
                    obs_times=torch.linspace(0.0, t_max, 5,
                                             dtype=torch.float64),
                    obs_weight=weight,
                    obs_var=torch.full((5, nb, 1, 1), 0.005, device=dev),
                    model=model, interrogation=mode, device=dev)

    def float64_twins(dev):
        a = args(dev)
        prep = fd._dalton_prepare(*[a[k] for k in (
            "thetas", "ode_weight", "ode_inits", "t_min", "t_max", "n_steps",
            "prior_pars", "obs_data", "obs_times", "obs_weight", "obs_var")])
        return cov_ref.dalton_float64_twins(model, mode, n, *prep,
                                            tangent=model != "chkrebtii")

    _reset_launches()
    ll, grad = fd.dalton_fused_batch_grad(**args(cuda_device))
    torch.cuda.synchronize()
    assert _launched() == {"dalton_filter_batch_tan": 2}
    assert torch.isfinite(ll).all() and torch.isfinite(grad).all()
    assert torch.equal(ll, fd.dalton_fused_batch(**args(cuda_device)))
    if model == "chkrebtii":
        assert (grad == 0).all()
    _reset_launches()
    ll_c, grad_c = fd.dalton_fused_batch_grad(**args("cpu"))
    assert not _launched()
    if name in cov_ref.DALTON_F32_UNRESOLVED:
        ll, grad = float64_twins(cuda_device)
        ll_c, grad_c = float64_twins("cpu")
    assert _scaled_err(ll, ll_c) <= ENTRY_TOL
    if model != "chkrebtii":
        assert _scaled_err(grad, grad_c) <= ENTRY_TOL


def test_mala_over_dalton_on_hes1_on_the_card(cuda_device):
    """The lockstep MALA runner over dalton_fused_batch_grad on Hes1 under
    kramer (K11c a step with data and one without, the Jacobian on nested
    Duals), 16 lanes x 3 steps on the card: its launches, finite, and its
    carried log-density bitwise a fresh dalton_fused_batch at the final
    positions."""
    from rodeo_tpu_torch.models import hes1
    from rodeo_tpu_torch.parallel import chains
    cfg, (thetas, _), obs, _ = cov_ref.grad_fixture("hes1", 16,
                                                    torch.float32,
                                                    cuda_device)
    solver = dict(ode_weight=cfg["ode_weight"], ode_init=cfg["ode_init"],
                  t_min=0.0, t_max=cfg["t_max"], n_steps=cfg["n_steps"],
                  prior_pars=cfg["prior_pars"])
    _reset_launches()
    pos, ll, acc = chains.run_chains_mala_fused(
        thetas, torch.Generator(cuda_device).manual_seed(5), 3, 1e-4,
        model=hes1, likelihood="dalton", device=cuda_device, **solver, **obs)
    torch.cuda.synchronize()
    assert _launched() == {"dalton_filter_batch_tan": 8}
    assert torch.isfinite(pos).all() and torch.isfinite(ll).all()
    fresh = fd.dalton_fused_batch(
        pos[-1], cfg["ode_weight"],
        cfg["ode_init"].expand((16,) + cfg["ode_init"].shape), 0.0,
        cfg["t_max"], cfg["n_steps"], cfg["prior_pars"], **obs, model="hes1",
        device=cuda_device)
    assert torch.equal(fresh, ll)


# --- non-Gaussian DALTON at every instance of K1 under kramer and rodeo: K9
# and K11d on every model and q, each with both observation functors --------

_NEW_NN = sorted(
    fk._INSTANCES["filter_nn_batch"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))
# tests/test_torch_daltonng.py's Poisson rate exp(B0 + B1 x), B1 divided by
# the largest initial value of a model above 1 (SEIRAH's populations reach
# 6.4e7), so that the rate stays finite on every model
_NN_B0, _NN_B1 = 0.1, 0.05


def _nn_instance_case(functor, mode, q, obs_name, device):
    """K9's and K11d's operands of the instance (functor, mode, q) on 37
    lanes (a ragged lane group) of the functor's INSTANCE_CHECKS setup
    (tools/torch_coverage_reference.py), derivative 0 of every block
    observed at 5 times from t = 0 to its end, so that the run holds steps
    with data: Gaussian data of variance 0.005 about the initial value, or
    Poisson counts.  Returns ``(case, obs_model, ops, grid)``."""
    case = cov_ref.instance_case(functor, mode, q, 37, device, seed=7)
    cfg, n = case["cfg"], case["n_steps"]
    thetas = case["batch"]["theta_lanes"].T.contiguous()
    inits = cfg["ode_init"].expand((37,) + cfg["ode_init"].shape)
    nb = case["fused"].n_block
    rng = np.random.default_rng(q)
    x0 = cfg["ode_init"][:, 0]
    if obs_name == "gauss":
        obs = obs_models.gauss(0.005)
        data = x0[None, :, None] * (1 + 0.01 * torch.tensor(
            rng.standard_normal((5, nb, 1)), dtype=torch.float32,
            device=device))
    else:
        obs = obs_models.poisson(
            _NN_B0, _NN_B1 / max(1.0, x0.abs().max().item()))
        data = torch.tensor(rng.poisson(2.0, size=(5, nb, 1)),
                            dtype=torch.float32, device=device)
    ops, grid, _, _ = fdn._daltonng_prepare(
        thetas, cfg["ode_weight"], inits, 0.0, case["config"]["t_max"], n,
        cfg["prior_pars"], data,
        torch.linspace(0.0, case["config"]["t_max"], 5, dtype=torch.float64))
    assert (grid["mask"] != 0).any()
    return case, obs, ops, grid


@pytest.mark.parametrize("obs_name", ["gauss", "poisson"])
@pytest.mark.parametrize("functor,mode,q", _NEW_NN,
                         ids=["-".join(map(str, k)) for k in _NEW_NN])
def test_new_daltonng_instances_are_bitwise_their_twins(cuda_device, functor,
                                                        mode, q, obs_name):
    """Each instance of K9 and K11d that this slice added (Hes1's and
    SEIRAH's Jacobian under kramer on nested Duals in K11d), under Gauss
    and Poisson data, bitwise against its twin on 37 lanes of the functor's
    INSTANCE_CHECKS setup with 5 steps of data, every output finite and
    K11d's values K9's; their launches at 2048 lanes (CTAs of 32 lanes x
    the blocks, K11d a grid row per parameter), and ptxas spills nothing in
    either."""
    case, obs, ops, grid = _nn_instance_case(functor, mode, q, obs_name,
                                             cuda_device)
    fused, n = case["fused"], case["n_steps"]
    n_tri = q * (q + 1) // 2
    _reset_launches()
    k9 = fdn.filter_nn_batch(fused, obs, (0,), n, **ops, **grid, mode=mode)
    k11 = fdn.filter_nn_batch_tan(fused, obs, (0,), n, **ops, **grid,
                                  mode=mode)
    assert _launched() == {"filter_nn_batch": 1, "filter_nn_batch_tan": 1}
    p9 = fdn._filter_nn_batch_plain(fused, obs, (0,), n, **ops, **grid,
                                    mode=mode)
    p11 = fdn._filter_nn_batch_tan_plain(fused, obs, (0,), n, **ops, **grid,
                                         mode=mode)
    for a, b, v, k in zip(k11, p11, k9, (q, n_tri, q, n_tri)):
        assert torch.isfinite(b).all()
        assert torch.equal(a, b)
        assert torch.equal(a[:, :k], v)
    assert all(torch.equal(a, b) for a, b in zip(k9, p9))
    for geometry, kernel, n_dir in (
            (fdn._filter_nn_batch_geometry, "22filter_nn_batch_kernel", 1),
            (fdn._filter_nn_batch_tan_geometry,
             "26filter_nn_batch_tan_kernel", fused.n_theta)):
        geo = geometry(fused, obs, 2048, mode, q, device=cuda_device)
        assert (geo["cta_x"], geo["cta_y"]) == (K9_LANES, fused.n_block), geo
        assert (geo["grid_x"], geo["grid_y"]) == (2048 // K9_LANES,
                                                  n_dir), geo
        assert geo["ctas_per_sm"] >= 1, geo
        name = obs.cuda_functor
        rows = _spills(kernel, f"{len(functor)}{functor}E",
                       f"{len(name)}{name}ELi{q}ELi{fk._MODES[mode]}E")
        assert rows and all(r == (0, 0) for r in rows), rows


def test_daltonng_entries_refuse_other_instances_on_the_card(cuda_device):
    """The C entries of K9 and K11d return an error for any (model,
    observation functor, mode, q) that with_filter_instance, with_ek_mode
    and the Gauss and Poisson functors do not list, and the Python gate
    refuses q = 6 and the schober and chkrebtii interrogations first on
    CUDA tensors."""
    lib = fk._build.load()
    qc = fk._host_qconst([[1.0] * 5] * 5)
    pars = (ctypes.c_float * 2)(1.0, 0.0)
    for model, obs, mode, q_k in ((0, 0, 0, 4), (2, 1, 0, 3), (3, 0, 2, 3),
                                  (2, 0, 3, 4), (1, 1, 0, 6), (4, 0, 1, 4),
                                  (5, 0, 0, 3), (0, 2, 0, 3)):
        for entry in (lib.rodeo_filter_nn_batch,
                      lib.rodeo_filter_nn_batch_tan):
            assert entry(model, obs, mode, q_k, 1, 4, 2,
                         ctypes.addressof(qc), ctypes.addressof(pars),
                         *([None] * 14)) != 0, (model, obs, mode, q_k)
    for how, q_k in (("kramer", 6), ("schober", 3), ("chkrebtii", 3)):
        cfg = fitzhugh.setup(n_steps=8, t_max=0.4, dtype=torch.float32,
                             device=cuda_device, n_deriv=q_k)
        args = (cfg["theta"][None], cfg["ode_weight"], cfg["ode_init"][None],
                0.0, 0.4, 8, cfg["prior_pars"],
                torch.ones((2, 2, 1), device=cuda_device),
                torch.tensor([0.0, 0.4]), obs_models.gauss(0.005), (0,),
                "fitzhugh")
        for entry, kernel in ((fdn.daltonng_fused_batch, "filter_nn_batch"),
                              (fdn.daltonng_fused_batch_grad,
                               "filter_nn_batch_tan")):
            with pytest.raises(NotImplementedError, match=kernel):
                entry(*args, interrogation=how, device=cuda_device)
