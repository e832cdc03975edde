"""
The fused gradient entries at the instances that K11a, K11b and K11e took
last, on the CPU: Hes1 and SEIRAH at q = 3, Chkrebtii's ODE at q = 4 and 5
(tests/coverage_value_cases.py's value cases, kramer and rodeo) and
FitzHugh-Nagumo at q = 4 and 5 (its weight and initial state padded with
zeros past the third derivative), 40 steps x 4 lanes.  Here
``fenrir_fused_batch_grad`` (K11a, K11b) against the JAX package's
``fenrir_fused_batch_grad``, whose Pallas kernels run in interpret mode
(its Jacobian of Hes1 and SEIRAH by ``coverage_value_cases.jac_lanes``,
``jvp_jac_flat``'s jax.jvp per block on lane-wide seeds), the values within
LOGLIK_RTOL = 1e-4 relative and each parameter's gradient within
GRAD_RTOL = 1e-3 of its largest entry (tests/test_torch_grad.py's; at
q = 5, where both packages' float32 values are rounding-bound,
tests/coverage_value_cases.py's Q5_TOL and GRAD_Q5_TOL, 3 x the measured
gaps; coverage_value_cases.check_fenrir_case; FitzHugh-Nagumo's cases in
tests/test_torch_coverage_grad_fitz.py); every gradient entry's values
bitwise its value entry's; and ``fused_loglik``'s backward on Hes1.
tests/test_torch_coverage_grad_solve*.py hold
``solve_mv_fused_batch_grad`` and ``basic_fused_batch_grad``.

Under kramer at FitzHugh-Nagumo q = 4 and 5 the JAX package's fused
gradient misses its own float64 plain reference (``ops.precond.fenrir``
and ``jax.value_and_grad``) by up to 1.6e-2 (q = 4) and 0.78 (q = 5) of
each parameter's largest entry, where the port's lies within 4.5e-5 and
8.8e-4, and the exact gradient moves by at most 8.3e-6 under a one-ulp
move of theta: the port is held to that plain reference there, within
GRAD_RTOL and GRAD_Q5_TOL (tests/test_torch_coverage_grad_fitz.py, which
also records the JAX package's miss).
"""
import numpy as np
import pytest
import torch

import coverage_value_cases as cv

import rodeo_tpu_torch as rt
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk

NAMES = sorted(cv.GRAD_CASES)
# the cases on the value path's models
VALUE_NAMES = [n for n in NAMES if cv.GRAD_CASES[n][0] != "fitzhugh"]


@pytest.mark.parametrize("name", VALUE_NAMES)
def test_fenrir_gradient_matches_jax(name):
    """coverage_value_cases.check_fenrir_case on Hes1, SEIRAH and
    Chkrebtii's ODE at q = 4 and 5, kramer and rodeo
    (tests/test_torch_coverage_grad_fitz.py holds FitzHugh-Nagumo's)."""
    cv.check_fenrir_case(name)


def _b_loglik(obs_data, ode_data, **params):
    return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)


@pytest.mark.parametrize("entry", ["fenrir", "basic"])
@pytest.mark.parametrize("name", NAMES)
def test_grad_values_equal_the_value_entry_points(name, entry):
    """On the CPU each gradient entry's log-likelihood is its value entry's,
    bitwise (the Duals' values are the plain operations, Hes1's and
    SEIRAH's nested Jacobian included)."""
    c = cv.case(name)
    args, kw, obs = cv.port_args(c)
    if entry == "fenrir":
        grad = ff.fenrir_fused_batch_grad(*args, **obs, **kw)[0]
        value = ff.fenrir_fused_batch(*args, **obs, **kw)
    else:
        basic = dict(obs_data=obs["obs_data"], obs_times=obs["obs_times"],
                     obs_loglik=_b_loglik)
        grad = fk.basic_fused_batch_grad(*args, **basic, **kw)[0]
        value = fk.basic_fused_batch(*args, **basic, **kw)[0]
    np.testing.assert_array_equal(grad.numpy(), value.numpy())


def test_fused_loglik_backward_on_hes1():
    """fused_loglik over fenrir_fused_batch_grad on Hes1 (EK1, its Jacobian
    on nested Duals) hands the explicit gradient to thetas."""
    c = cv.case("hes1_kramer")
    args, kw, obs = cv.port_args(c)
    thetas = args[0].double().requires_grad_(True)
    loglik = rt.fused_loglik(rt.fenrir_fused_batch_grad, thetas,
                             ode_weight=args[1], ode_inits=args[2],
                             t_min=args[3], t_max=args[4], n_steps=args[5],
                             prior_pars=args[6], **obs, **kw)
    weights = torch.arange(1.0, cv.N_LANE + 1)
    (loglik * weights).sum().backward()
    ll, grad = ff.fenrir_fused_batch_grad(*args, **obs, **kw)
    torch.testing.assert_close(loglik.detach(), ll, rtol=0, atol=0)
    torch.testing.assert_close(thetas.grad, (weights[:, None] * grad)
                               .double(), rtol=0, atol=0)
