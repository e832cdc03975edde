"""
K11c's twin at the instances that K11c took last, on the CPU
(``_dalton_filter_tan_plain``, K8's twin on Duals, Hes1's and SEIRAH's
Jacobian on nested Duals under kramer), against ``torch.func.jvp`` of K8's
twin in float64, with and without data, over RULES_TOL_STEPS steps that
hold a step with data, within tests/test_torch_grad.py's RULES_TOL = 1e-10
of the largest entry of each direction (tests/test_torch_coverage_dalton.py
and _fitz.py hold the gradient entry against the JAX package).
"""
import numpy as np
import pytest
import torch

import coverage_value_cases as cv

from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_kalman as fk

RULES_TOL = 1e-10
# the twins' steps: the cases observe steps 10, 20, 30 and 40 (the mask of
# step n + 1 at row n), so 12 steps hold one step with data
RULES_TOL_STEPS = 12
# the instances of K11c beyond Lorenz63 and FitzHugh-Nagumo at q = 3
NEW_K11C = sorted(
    fk._INSTANCES["dalton_filter_batch_tan"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))
_MODEL = {"Hes1": "hes1", "Seirah": "seirah", "Chkrebtii": "chkrebtii",
          "FitzHughNagumo": "fitzhugh"}


def _case_of(functor, mode, q):
    model = _MODEL[functor]
    if model == "chkrebtii":
        return f"chkrebtii_q{q}"
    if model == "fitzhugh":
        return f"fitzhugh_q{q}_{mode}"
    return f"{model}_{mode}"


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("functor,mode,q", NEW_K11C,
                         ids=["-".join(map(str, k)) for k in NEW_K11C])
def test_dalton_tangent_twin_matches_torch_jvp(functor, mode, q, with_obs):
    """K11c's twin at each new instance, in float64 over RULES_TOL_STEPS
    steps of the case's operands (dalton_fused_batch_grad's), with and
    without data: its values bitwise K8's twin's, and each direction's
    tangent of the log-density against torch.func.jvp of K8's twin along
    that parameter, within RULES_TOL of its largest entry (the absolute
    error where the tangent is zero: Chkrebtii's ODE has no parameter)."""
    c = cv.case(_case_of(functor, mode, q))
    args, _, obs = cv.port_args(c)
    ops, grid, ld0 = fd._dalton_prepare(*args, *obs.values())
    n = RULES_TOL_STEPS
    f64 = {k: (v.double() if isinstance(v, torch.Tensor) else v)
           for k, v in ops.items()}
    f64["tgrid"] = f64["tgrid"][:n]
    cut = {k: v[:n].double() for k, v in grid.items()}
    if with_obs:
        assert (cut["mask"] != 0).any()
    seed = ld0.double() if with_obs else torch.zeros_like(ld0.double())
    fused = fk.resolve_model(c["model"])
    theta = f64.pop("theta_lanes")
    n_theta = theta.shape[0]
    aug = fd._dalton_filter_tan_plain(
        fused, n, **f64, theta_lanes=theta, **cut,
        ld0=torch.cat([seed[None], seed.new_zeros((n_theta, seed.shape[0]))]),
        mode=mode, with_obs=with_obs)

    def value(th):
        return fd._dalton_filter_plain(fused, n, **f64, theta_lanes=th,
                                       **cut, ld0=seed, mode=mode,
                                       with_obs=with_obs)

    assert aug.shape == (1 + n_theta, cv.N_LANE)
    assert torch.equal(aug[0], value(theta))
    for k in range(n_theta):
        e = torch.zeros_like(theta)
        e[k] = 1.0
        _, tan = torch.func.jvp(value, (theta,), (e,))
        assert np.isfinite(aug[1 + k].numpy()).all()
        assert cv.tan_err(aug[1 + k], tan) <= RULES_TOL, k
