"""
Parity of the port's torch-op solvers (rodeo_tpu_torch.solve_mv and
rodeo_tpu_torch.ops.precond.solve_mv) with the JAX package at float64 on the
CPU, and the failure contract of chip_smoke.py on a host without a GPU.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import rodeo_tpu
from rodeo_tpu import interrogate as jinterrogate
from rodeo_tpu.models import lorenz as jlorenz
from rodeo_tpu.ops import precond as jprecond
from rodeo_tpu.prior import ibm_init as jibm_init
from rodeo_tpu.utils import first_order_pad as jfirst_order_pad

import rodeo_tpu_torch
from rodeo_tpu_torch import interrogate as tinterrogate
from rodeo_tpu_torch.models import lorenz as tlorenz
from rodeo_tpu_torch.ops import precond as tprecond
from rodeo_tpu_torch.prior import ibm_init as tibm_init
from rodeo_tpu_torch.utils import first_order_pad as tfirst_order_pad

REPO = pathlib.Path(__file__).resolve().parents[1]


def _fitz_jax(X, t, **params):
    a, b, c = params["theta"]
    V, R = X[0, 0], X[1, 0]
    return jnp.array([[c * (V - V ** 3 / 3 + R)], [-1 / c * (V - a + b * R)]])


def _fitz_torch(X, t, **params):
    a, b, c = params["theta"]
    V, R = X[0, 0], X[1, 0]
    return torch.stack([c * (V - V ** 3 / 3 + R),
                        -1 / c * (V - a + b * R)])[:, None]


@pytest.mark.parametrize("scheme", ["rodeo", "kramer"])
def test_solve_mv_matches_jax_on_the_readme_fitzhugh(scheme):
    """The README walkthrough (FitzHugh-Nagumo, N=200, sigma=0.01).  Both
    packages run the same float64 recursion; the port's Joseph-form update
    and the JAX default's subtractive form differ by rounding only, well
    inside atol=1e-10."""
    n_steps, theta, x0 = 200, [0.2, 0.2, 3.0], [-1.0, 1.0]
    Wj, padj = jfirst_order_pad(_fitz_jax, n_vars=2, n_deriv=3)
    thj = jnp.asarray(theta)
    mu_j, var_j = rodeo_tpu.solve_mv(
        key=None, ode_fun=_fitz_jax, ode_weight=Wj,
        ode_init=padj(jnp.asarray(x0), 0.0, theta=thj), t_min=0.0,
        t_max=10.0, n_steps=n_steps,
        interrogate=getattr(jinterrogate, f"interrogate_{scheme}"),
        prior_pars=jibm_init(10.0 / n_steps, 3, jnp.asarray([0.01] * 2)),
        theta=thj)
    Wt, padt = tfirst_order_pad(_fitz_torch, n_vars=2, n_deriv=3,
                                dtype=torch.float64)
    tht = torch.tensor(theta, dtype=torch.float64)
    mu_t, var_t = rodeo_tpu_torch.solve_mv(
        ode_fun=_fitz_torch, ode_weight=Wt,
        ode_init=padt(torch.tensor(x0, dtype=torch.float64), 0.0,
                      theta=tht),
        t_min=0.0, t_max=10.0, n_steps=n_steps,
        interrogate=getattr(tinterrogate, f"interrogate_{scheme}"),
        prior_pars=tibm_init(10.0 / n_steps, 3,
                             torch.tensor([0.01] * 2, dtype=torch.float64)),
        theta=tht)
    assert mu_t.shape == (n_steps + 1, 2, 3)
    assert var_t.shape == (n_steps + 1, 2, 3, 3)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=0,
                               atol=1e-10)


def test_precond_solve_mv_matches_jax_on_lorenz():
    """Lorenz63 (prior_sigma=5e7, which overflows the plain recursion) at
    N=200, t_max=2 through the preconditioned solver, float64.  JAX runs it
    with closed-form tiny inverses, the port with LU solves; over 200
    chaotic steps the rounding difference stays below 1e-8 relative."""
    cfg_j = jlorenz.setup(n_steps=200, t_max=2.0, dtype=jnp.float64)
    th_j = cfg_j.pop("theta")
    mu_j, var_j = jprecond.solve_mv(
        key=None, interrogate=jinterrogate.interrogate_kramer, theta=th_j,
        **cfg_j)
    cfg_t = tlorenz.setup(n_steps=200, t_max=2.0, dtype=torch.float64)
    th_t = cfg_t.pop("theta")
    mu_t, var_t = tprecond.solve_mv(
        interrogate=tinterrogate.interrogate_kramer, theta=th_t, **cfg_t)
    mu_j, var_j = np.asarray(mu_j), np.asarray(var_j)
    for d in range(3):
        np.testing.assert_allclose(mu_t[..., d].numpy(), mu_j[..., d],
                                   rtol=0,
                                   atol=1e-8 * np.abs(mu_j[..., d]).max())
    np.testing.assert_allclose(var_t.numpy(), var_j, rtol=0,
                               atol=1e-8 * np.abs(var_j).max())


@pytest.mark.parametrize("kwargs", [{"temporal": "parallel"},
                                    {"temporal": "bogus"},
                                    {"kalman_type": "square-root"}])
def test_solve_mv_raises_for_unported_options(kwargs):
    cfg = tlorenz.setup(n_steps=4, t_max=0.1, dtype=torch.float64)
    th = cfg.pop("theta")
    with pytest.raises(NotImplementedError):
        tprecond.solve_mv(interrogate=tinterrogate.interrogate_rodeo,
                          theta=th, **cfg, **kwargs)


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """chip_smoke.py never runs the port on the CPU: without CUDA (and, as
    a lone copy, without the package) it exits non-zero with no result."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = _run_smoke(cwd, script)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
