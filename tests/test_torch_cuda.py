"""
The port's CUDA kernels on the card: kernel K1 (filter_batch) and K2
(smoother_batch) against their plain PyTorch twins on the same CUDA
inputs, and the fused solve's launch contract.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so that it runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""
import numpy as np
import pytest
import torch

from rodeo_tpu_torch.models import fitzhugh, lorenz
from rodeo_tpu_torch.ops import fused_kalman as fk

pytestmark = pytest.mark.cuda

MODELS = {"lorenz": lorenz, "fitzhugh": fitzhugh}
# Built without multiply-add contraction, a kernel does its twin's float32
# operations in the same order; a division by a constant, which PyTorch on
# CUDA takes through its reciprocal, still rounds differently (measured
# 3.4e-6 of the largest entry on FitzHugh-Nagumo over 1000 steps on an H100).
TWIN_TOL = 1e-5


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


@pytest.mark.parametrize("model,mode,t_max", [("lorenz", "kramer", 0.6),
                                              ("fitzhugh", "rodeo", 3.0)])
def test_kernels_match_their_twins_on_the_card(cuda_device, model, mode,
                                               t_max):
    n_steps = 300
    cfg, thetas, inits = _lanes(model, n_steps, t_max, 96, 4, cuda_device)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    fused = fk.resolve_model(model)
    out_k = fk.fused_filter_batch(fused, n_steps, **ops, mode=mode)
    out_p = fk._filter_batch_plain(fused, n_steps, **ops, mode=mode)
    for name, a, b in zip(["G", "g", "L", "m_last", "p_last"], out_k, out_p):
        assert a.is_cuda and torch.isfinite(a).all(), name
        assert _scaled_err(a, b) <= TWIN_TOL, name
    G, g, L, mN, pN = out_k
    sm_k = fk.smoother_recursion_batch(g[1:], G[1:], L[1:], mN, pN)
    sm_p = fk._smoother_batch_plain(g[1:], G[1:], L[1:], mN, pN)
    for name, a, b in zip(["ms", "ps"], sm_k, sm_p):
        assert _scaled_err(a, b) <= TWIN_TOL, name


def test_fused_solve_launches_each_kernel_once(cuda_device):
    """One solve on CUDA tensors is one launch of each kernel, and agrees
    with the same solve on CPU tensors, which runs the plain twins."""
    n_steps, t_max = 200, 2.0

    def solve(device):
        cfg, thetas, inits = _lanes("lorenz", n_steps, t_max, 64, 5, device)
        return fk.solve_mv_fused_batch(
            thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
            cfg["prior_pars"], model="lorenz")

    fk.LAUNCHES.update(filter_batch=0, smoother_batch=0)
    mean, var = solve(cuda_device)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"filter_batch": 1, "smoother_batch": 1}
    assert mean.shape == (n_steps + 1, 3, 3, 64) and mean.is_cuda
    assert var.shape == (n_steps + 1, 3, 6, 64)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    mean_c, var_c = solve(torch.device("cpu"))
    assert fk.LAUNCHES == {"filter_batch": 1, "smoother_batch": 1}
    for d in range(3):
        assert _scaled_err(mean[..., d, :], mean_c[..., d, :]) <= TWIN_TOL, d
    assert _scaled_err(var, var_c) <= TWIN_TOL


def test_cuda_tensors_never_take_the_twin(cuda_device):
    """A CUDA operand the kernels cannot take raises; it is not handed to
    the plain twin."""
    rng = np.random.default_rng(6)
    T, q, nb, B = 5, 4, 2, 3           # q = 4: no kernel instantiated
    n_tri = q * (q + 1) // 2

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda_device)

    fk.LAUNCHES.update(filter_batch=0, smoother_batch=0)
    with pytest.raises(NotImplementedError):
        fk.smoother_recursion_batch(t(T, q, nb, B), t(T, q * q, nb, B),
                                    t(T, n_tri, nb, B), t(q, nb, B),
                                    t(n_tri, nb, B))
    with pytest.raises(ValueError):    # operands on two devices
        fk.smoother_recursion_batch(t(T, 3, nb, B), t(T, 9, nb, B).cpu(),
                                    t(T, 6, nb, B), t(3, nb, B), t(6, nb, B))
    assert fk.LAUNCHES == {"filter_batch": 0, "smoother_batch": 0}
