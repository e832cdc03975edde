"""
Non-Gaussian DALTON's gradient at the instances that K9 and K11d took
last, on the CPU: SEIRAH at q = 3 under kramer and rodeo
(tests/coverage_value_cases.py's gradient cases, 40 steps x 4 lanes,
Gaussian data in derivative 0) through ``daltonng_fused_batch_grad`` (the
twins of K11d, K11e and K11a, and the torch stage) against the JAX
package's ``daltonng_fused_batch_grad``, whose Pallas kernels run in
interpret mode (coverage_value_cases.check_daltonng_case).  Hes1, whose
cases compile their own kernels, is in
tests/test_torch_coverage_daltonng.py; Chkrebtii's ODE and
FitzHugh-Nagumo at q = 4 and 5 in tests/test_torch_coverage_daltonng_fitz.py;
K11d's twin against torch.func.jvp and the masked eigendecomposition at
q = 4 and 5 in tests/test_torch_coverage_daltonng_twins.py.  A file each,
so that ``--dist loadfile`` runs them on different workers.
"""
import pytest

import coverage_value_cases as cv


@pytest.mark.parametrize("name", ["seirah_kramer", "seirah_rodeo"])
def test_daltonng_gradient_matches_jax(name):
    """coverage_value_cases.check_daltonng_case on SEIRAH under kramer (the
    JAX package's Jacobian by jax.jvp on lane-wide seeds, the port's on
    nested Duals) and rodeo."""
    cv.check_daltonng_case(name)
