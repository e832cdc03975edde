"""
The fused solve's sensitivities and basic's gradient on FitzHugh-Nagumo at
q = 4 and 5 (its weight and initial state padded with zeros past the
third derivative), kramer and rodeo, on the CPU: the rules of
tests/test_torch_coverage_grad_solve.py (coverage_value_cases.
check_solve_case), the JAX package's float64 plain reference computed
beside its fused path.  A file of its own, so that ``--dist loadfile``
runs these cases beside the other models'.
"""
import pytest

import coverage_value_cases as cv

NAMES = sorted(n for n in cv.GRAD_CASES if cv.GRAD_CASES[n][0] == "fitzhugh")


@pytest.mark.parametrize("name", NAMES)
def test_solve_and_basic_gradients_match_jax(name):
    """coverage_value_cases.check_solve_case on FitzHugh-Nagumo at q = 4
    and 5, kramer and rodeo."""
    cv.check_solve_case(name)


@pytest.mark.parametrize("name", cv.JAX_FUSED_MISSES)
def test_jax_fused_sensitivities_miss_their_plain_reference(name):
    """The record behind check_solve_case's rule at JAX_FUSED_MISSES: under
    kramer at FitzHugh-Nagumo q = 4 and 5 the JAX package's fused
    sensitivities lie further than GRAD_RTOL (of their largest entry) from
    its own float64 plain reference (``ops.precond.solve_mv`` and
    ``jax.jvp``; up to 0.48 and 2.1e3 measured).  The outputs are those the
    check computed (coverage_value_cases.jax_solve_of)."""
    misses = cv.jax_solve_misses(name)
    assert max(misses) > cv.GRAD_RTOL, misses
