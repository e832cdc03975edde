"""
The fused solve's sensitivities and the basic likelihood's gradient at the
instances that K11a and K11e took last, on the CPU (the cases of
tests/test_torch_coverage_grad.py): ``solve_mv_fused_batch_grad`` (K11a,
K11e) against the JAX package's ``solve_mv_fused_batch_grad`` (interpret
mode), the means within SCALED_TOL = 1e-4 of their largest entry and each
parameter's sensitivity of each derivative within GRAD_RTOL = 1e-3
(tests/test_torch_grad.py's; at q = 5 tests/coverage_value_cases.py's
Q5_TOL and GRAD_Q5_TOL, where both packages' float32 solves are
rounding-bound); the means bitwise
``solve_mv_fused_batch``'s; and ``basic_fused_batch_grad`` against the
JAX package's basic stage on that solve (its ``basic_fused_batch_grad``'s
lane-mapped ``obs_loglik`` and ``jax.jvp`` along each sensitivity),
LOGLIK_RTOL = 1e-4 and GRAD_RTOL.

On FitzHugh-Nagumo at q = 4 and 5 the JAX package's float64 plain
reference (``ops.precond.solve_mv`` and ``jax.jvp``) is computed too.
Wherever the JAX package's fused output lies further than half the
tolerance from it, the port is held to that reference instead: within
the tolerance, or within 3 x the port's own move under a one-ulp move of
its operands (theta, the initial state, the prior variance) where that is
larger, which it is only where float32 does not resolve the output (the
derivatives past the third, padding, and under kramer at q = 5 every
sensitivity).  Under kramer there
(JAX_FUSED_MISSES) the JAX package's fused sensitivities miss the plain
reference by 8.5e-3 to 0.48 of their largest entry at q = 4 and by 2.5 to
2.1e3 x it at q = 5 (tests/test_torch_coverage_grad_solve_fitz.py
records it), where the port's lie within 1.6e-4 at q = 4 (9.9e-4 in the
padding) and 2.3e-4 to 0.39 at q = 5.
"""
import pytest

import coverage_value_cases as cv

# the cases on the value path's models (test_torch_coverage_grad_solve_fitz.py
# holds FitzHugh-Nagumo's)
NAMES = sorted(n for n in cv.GRAD_CASES if cv.GRAD_CASES[n][0] != "fitzhugh")


@pytest.mark.parametrize("name", NAMES)
def test_solve_and_basic_gradients_match_jax(name):
    """coverage_value_cases.check_solve_case on Hes1, SEIRAH and Chkrebtii's
    ODE at q = 4 and 5, kramer and rodeo."""
    cv.check_solve_case(name)
