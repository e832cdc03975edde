"""
DALTON's gradient on FitzHugh-Nagumo at q = 4 and 5 (its weight and
initial state padded with zeros past the third derivative), kramer and
rodeo, on the CPU (coverage_value_cases.check_dalton_case).  There float32
does not resolve DALTON in either package: it is the difference of two
float32 sums of ~6e7 (q = 4) or ~5e11 (q = 5), which rounds to whole
numbers (to 0 at q = 5), where DALTON is ~10.  So the port's float32
outputs are held to the JAX package's float64 plain reference
(``ops.precond.dalton`` and ``jax.value_and_grad``) within 3 x how finely
float32 resolves them (coverage_value_cases.dalton_f32_held), and its twins
in float64, on the same float32 operands, within DALTON_RTOL and GRAD_RTOL
of that reference; under kramer, where that reference's joint forecast
density (eigen-masked at steps with data) and the fused filters'
sequential updates part in float64 (recorded here), within those
tolerances (or float64's own resolution there) of the JAX package's fused
formulation run in float64.  A file of its own, so that ``--dist
loadfile`` runs these cases beside the other models'.
"""
import numpy as np
import pytest

import coverage_value_cases as cv

NAMES = sorted(cv.DALTON_UNRESOLVED)


@pytest.mark.parametrize("name", NAMES)
def test_dalton_gradient_matches_jax(name):
    """coverage_value_cases.check_dalton_case on FitzHugh-Nagumo at q = 4
    and 5, kramer and rodeo."""
    cv.check_dalton_case(name)


@pytest.mark.parametrize("name", NAMES)
def test_float32_does_not_resolve_dalton(name):
    """The record behind check_dalton_case's rule at DALTON_UNRESOLVED: both
    packages' float32 DALTON, value or gradient, lies further than its
    tolerance from the float64 plain reference (the JAX package's, computed
    by the check: coverage_value_cases.jax_dalton_of)."""
    c = cv.jax_grad_case(name)
    (ll_j, g_j), (ll_p, g_p) = cv.jax_dalton_of(name)
    ll_t, g_t = cv.port_dalton(c)
    v_tol = cv.tol(name, cv.DALTON_RTOL, cv.DALTON_Q5_TOL)
    g_tol = cv.tol(name, cv.GRAD_RTOL, cv.GRAD_Q5_TOL)
    for ll, g in ((ll_t, g_t), (ll_j, g_j)):
        v_err = np.max(np.abs(ll - ll_p) / np.abs(ll_p))
        g_err = max(cv.tan_err(g[:, k], g_p[:, k])
                    for k in range(g.shape[1]))
        assert v_err > v_tol or g_err > g_tol, (v_err, g_err)


@pytest.mark.parametrize("name", cv.DALTON_PLAIN_PARTS)
def test_plain_reference_parts_from_the_fused_filters(name):
    """The record behind check_dalton_case's rule at DALTON_PLAIN_PARTS:
    under kramer at FitzHugh-Nagumo q = 4 and 5 the port's twins in float64
    and the JAX package's fused formulation in float64 both lie further
    than GRAD_RTOL from the JAX package's float64 plain reference in some
    parameter's gradient (3-13 % measured), while they agree with each
    other (check_dalton_case); under rodeo all three agree within 5e-6."""
    for v_err, g_errs in cv.jax_dalton_plain_parts(name):
        assert max(g_errs) > cv.GRAD_RTOL, (v_err, g_errs)
