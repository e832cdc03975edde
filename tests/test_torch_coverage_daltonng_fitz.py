"""
Non-Gaussian DALTON's gradient on Chkrebtii's ODE at q = 4 and 5 (kramer)
and FitzHugh-Nagumo at q = 4 and 5 (its weight and initial state padded
with zeros past the third derivative; kramer and rodeo), on the CPU
(coverage_value_cases.check_daltonng_case, 40 steps x 4 lanes, Gaussian
data): Chkrebtii's ODE at q = 4 against the JAX package's fused entry, the
others, where float32 does not resolve the result in either package
(DALTONNG_UNRESOLVED), by the port's entries in float64 on the same
operands against the JAX package's float64 plain reference
(``ops.precond.daltonng`` and ``jax.value_and_grad``).  A file of its own,
so that ``--dist loadfile`` runs these cases beside the other models'.
"""
import numpy as np
import pytest

import coverage_value_cases as cv

NAMES = ["chkrebtii_q4"] + sorted(cv.DALTONNG_UNRESOLVED)


@pytest.mark.parametrize("name", NAMES)
def test_daltonng_gradient_matches_jax(name):
    """coverage_value_cases.check_daltonng_case on Chkrebtii's ODE at q = 4
    and 5 and FitzHugh-Nagumo at q = 4 and 5, kramer and rodeo; the
    gradient on Chkrebtii's ODE exactly zero."""
    cv.check_daltonng_case(name)


@pytest.mark.parametrize("name", sorted(cv.DALTONNG_UNRESOLVED))
def test_float32_does_not_resolve_daltonng(name):
    """The record behind check_daltonng_case's rule at DALTONNG_UNRESOLVED:
    the port's float32 value lies further from the JAX package's float64
    plain reference (coverage_value_cases.jax_daltonng_of) than FUSED_RTOL
    and than 3 x its own move under a one-ulp move of theta, x0 and the
    prior variance, on every lane: no float32 evaluation resolves it
    (measured 44 to 1.6e8 times the value away, the move 0.01-1.5 of
    it)."""
    c = cv.jax_grad_case(name)
    _, (ll_p, _) = cv.jax_daltonng_of(name)
    ll, _ = cv.port_daltonng(c)
    ll_m, _ = cv.port_daltonng(cv.ulp_case(c))
    err = np.abs(ll - ll_p) / np.abs(ll_p)
    move = np.abs(ll_m - ll) / np.abs(ll)
    assert (err > np.maximum(cv.FUSED_RTOL, 3 * move)).all(), (err, move)
