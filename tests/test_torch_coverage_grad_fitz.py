"""
Fenrir's gradient on FitzHugh-Nagumo at q = 4 and 5 (its weight and
initial state padded with zeros past the third derivative), kramer and
rodeo, on the CPU: the rules of tests/test_torch_coverage_grad.py
(coverage_value_cases.check_fenrir_case); under kramer, where the JAX
package's fused gradient misses its own float64 plain reference
(``ops.precond.fenrir`` and ``jax.value_and_grad``; recorded here), against
that reference within the same tolerances.  A file of its own, so that
``--dist loadfile`` runs these cases beside the other models'.
"""
import pytest

import coverage_value_cases as cv

NAMES = sorted(n for n in cv.GRAD_CASES if cv.GRAD_CASES[n][0] == "fitzhugh")


@pytest.mark.parametrize("name", NAMES)
def test_fenrir_gradient_matches_jax(name):
    """coverage_value_cases.check_fenrir_case on FitzHugh-Nagumo at q = 4
    and 5, kramer and rodeo."""
    cv.check_fenrir_case(name)


@pytest.mark.parametrize("name", cv.JAX_FUSED_MISSES)
def test_jax_fused_gradient_misses_its_plain_reference(name):
    """The record behind check_fenrir_case's rule at JAX_FUSED_MISSES:
    under kramer at FitzHugh-Nagumo q = 4 and 5 the JAX package's fused
    gradient lies further than GRAD_RTOL (of a parameter's largest entry)
    from its own float64 plain reference (1.6e-2 and 0.78 measured), where
    the port's lies within GRAD_RTOL and GRAD_Q5_TOL of it.  The outputs
    are those the check computed (coverage_value_cases.jax_fenrir_of)."""
    misses = cv.jax_fenrir_misses(name)
    assert max(misses) > cv.GRAD_RTOL, misses
