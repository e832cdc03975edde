"""
The tangent kernels' twins at the instances that K11a, K11b and K11e took
last, on the CPU: K11a's twin (K1's on Duals, Hes1's and SEIRAH's Jacobian
on nested Duals under kramer) against ``torch.func.jvp`` of K1's twin in
float64 at every new instance, and against the JAX package's tangent
filter ``pallas_fenrir.fused_filter_batch_tan(emit="gains")`` (interpret
mode) at FitzHugh-Nagumo q = 4 and 5; and K11e's twin against
``smoother_mean_recursion_batch_tan`` at q = 4 and 5 with 6 and 7 tangent
directions, every tangent seed a nonzero numpy normal
(tests/test_torch_coverage_grad_fenrir.py holds K11b's twin and the MALA
runner over fenrir on Hes1).

Tolerances are tests/test_torch_grad.py's: RULES_TOL = 1e-10 of the
largest entry for the float64 rules (Q5_RULES_TOL at q = 5, measured),
SCALED_TOL = 1e-4 of the largest entry of each output's values and of each
tangent direction against the Pallas kernels; where float32 does not
resolve an output of K11a (its smoothing gains at q = 4 and 5), within
3 x the twin's own move under a one-ulp move of its operands.
"""

import pytest
import torch

import coverage_value_cases as cv
from rodeo_tpu.ops import pallas_fenrir as pf
from rodeo_tpu.ops import pallas_kalman as pk

from rodeo_tpu_torch.ops import fused_kalman as fk

RULES_TOL = 1e-10
SCALED_TOL = 1e-4
# FitzHugh-Nagumo at q = 5 under kramer: K11a's twin in float64 lies 9.4e-10
# of the largest entry from torch.func.jvp (which differentiates the
# Schur-split inverse's scale that the Duals hold constant, in an
# ill-conditioned covariance; 1.4e-12 at q = 4, at most 2.5e-14 elsewhere):
# 3 x that
Q5_RULES_TOL = 3e-9
# the instances of K11a beyond Lorenz63 and FitzHugh-Nagumo at q = 3
NEW_K11A = sorted(
    fk._INSTANCES["filter_batch_tan"]
    - {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
       for md in ("kramer", "rodeo")}, key=lambda k: (k[2], k[0], k[1]))
_MODEL = {"Hes1": "hes1", "Seirah": "seirah", "Chkrebtii": "chkrebtii",
          "FitzHughNagumo": "fitzhugh"}


def _k11a_operands(name, dtype=torch.float32, n_steps=cv.N_STEPS):
    """K1's operands for the lanes of gradient case ``name``
    (tests/coverage_value_cases.py), as the port builds them."""
    c = cv.case(name)
    args, _, _ = cv.port_args(c)
    ops = fk._kernel_operands(args[0], args[1], args[2], 0.0, c["t_max"],
                              n_steps, args[6])
    if dtype != torch.float32:
        ops = {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v)
               for k, v in ops.items()}
    return c, ops


def _case_of(functor, mode, q):
    model = _MODEL[functor]
    if model == "chkrebtii":
        return f"chkrebtii_q{q}"
    if model == "fitzhugh":
        return f"fitzhugh_q{q}_{mode}"
    return f"{model}_{mode}"


@pytest.mark.parametrize("functor,mode,q", NEW_K11A,
                         ids=["-".join(map(str, k)) for k in NEW_K11A])
def test_tangent_filter_twin_matches_torch_jvp(functor, mode, q):
    """K11a's twin at each new instance, in float64 over 6 steps: its
    values bitwise K1's twin's, and each direction's tangents of every
    output against torch.func.jvp of K1's twin along that parameter (the
    nested Duals of Hes1's and SEIRAH's Jacobian under kramer included),
    within RULES_TOL (Q5_RULES_TOL at q = 5)."""
    name = _case_of(functor, mode, q)
    n_steps = 6
    c, ops = _k11a_operands(name, torch.float64, n_steps)
    fused = fk.resolve_model(c["model"])
    theta = ops.pop("theta_lanes")
    aug = fk._filter_batch_tan_plain(fused, n_steps, **ops,
                                     theta_lanes=theta, mode=mode)
    value = fk._filter_batch_plain(fused, n_steps, **ops,
                                   theta_lanes=theta, mode=mode)
    nt = q * (q + 1) // 2
    sizes = (q * q, q, nt, q, nt)
    for out, v, K in zip(aug, value, sizes):
        assert torch.equal(out.narrow(out.dim() - 3, 0, K), v)
    tol = Q5_RULES_TOL if q == 5 else RULES_TOL
    for k in range(theta.shape[0]):
        e = torch.zeros_like(theta)
        e[k] = 1.0
        _, tans = torch.func.jvp(
            lambda th: fk._filter_batch_plain(fused, n_steps, **ops,
                                              theta_lanes=th, mode=mode),
            (theta,), (e,))
        for out, ref, K in zip(aug, tans, sizes):
            sl = out.narrow(out.dim() - 3, (1 + k) * K, K)
            assert cv.tan_err(sl, ref) <= tol, (k, K)


@pytest.mark.parametrize("q", [4, 5])
@pytest.mark.parametrize("mode", ["kramer", "rodeo"])
def test_tangent_filter_twin_matches_pallas(mode, q):
    """K11a's twin at FitzHugh-Nagumo q = 4 and 5 (its weight and initial
    state padded with zeros past the third derivative) against the JAX
    package's pallas_fenrir.fused_filter_batch_tan(emit="gains"), every
    output, the values and each direction on their own, within the larger
    of SCALED_TOL and 3 x the twin's own move under a one-ulp move of its
    operands (theta, the initial state and the prior variance; the rule of
    tests/test_torch_sim.py, which moves theta).  That move exceeds
    SCALED_TOL where float32 does not resolve an output: the smoothing
    gains, whose float32 values lie 1e-4 to 7e-3 of their largest entry
    from the float64 twin at q = 4 and 1e-2 to 0.16 at q = 5 under rodeo,
    in both packages.  Under kramer at q = 5 a one-ulp move changes the
    gains A, b and C by their largest entry (float32 holds none of their
    digits, in either package: they lie up to 5e4 x it from float64), so
    there the rule holds them to be finite and of the JAX package's
    scale; the float64 twin's rules are held at every instance
    (test_tangent_filter_twin_matches_torch_jvp), and the likelihoods and
    gradients built on these gains to float64
    (tests/test_torch_coverage_grad_fitz.py)."""
    name = f"fitzhugh_q{q}_{mode}"
    c, ops = _k11a_operands(name)
    n_steps, n_tan = cv.N_STEPS, 3
    ref = pf.fused_filter_batch_tan(
        c["jflat"], c["jjac"], mode, n_tan, n_steps, None,
        ops["prior_var"].numpy(), ops["ode_weight"].numpy(),
        ops["x0_lanes"].numpy(), ops["theta_lanes"].numpy(),
        ops["tgrid"].numpy(), ops["t_vec"].numpy(), ops["q_const"],
        interpret=True, emit="gains")
    fk.LAUNCHES["filter_batch_tan"] = 0
    port = fk.fused_filter_batch_tan("fitzhugh", n_steps, **ops, mode=mode)
    assert fk.LAUNCHES["filter_batch_tan"] == 0     # the CPU takes the twin
    moved = fk.fused_filter_batch_tan("fitzhugh", n_steps, **{
        **ops, **{k: torch.from_numpy(cv.ulp_up(ops[k]))
                  for k in ("theta_lanes", "x0_lanes", "prior_var")}},
        mode=mode)
    nt = q * (q + 1) // 2
    for i, K in enumerate((q * q, q, nt, q, nt)):
        a, r = port[i], ref[i]
        assert a.shape == r.shape and torch.isfinite(a).all(), i
        axis = 1 if a.dim() == 4 else 0
        for s, (err, move) in enumerate(zip(
                cv.slice_errs(a, r, K, axis),
                cv.slice_errs(moved[i], a, K, axis))):
            assert err <= max(SCALED_TOL, 3 * move), (i, s, err, move)


_RECURSIONS = [(q, n_tan) for q in (4, 5) for n_tan in (6, 7)]


@pytest.mark.parametrize("q,n_tan", _RECURSIONS)
def test_smoother_mean_tan_twin_matches_pallas(q, n_tan):
    """K11e's twin against pallas_kalman.smoother_mean_recursion_batch_tan
    on a seeded augmented chain at q = 4 and 5 with 6 and 7 directions."""
    n_steps, nb, B = 30, 3, cv.N_LANE
    ch = cv.tan_chain(q, n_tan, n_steps, nb, B, seed=20 * q + n_tan)
    ref = pk.smoother_mean_recursion_batch_tan(
        ch["b"], ch["A"], ch["m_seed"], n_tan, interpret=True)
    fk.LAUNCHES["smoother_mean_batch_tan"] = 0
    port = fk.smoother_mean_recursion_batch_tan(
        torch.from_numpy(ch["b"]), torch.from_numpy(ch["A"]),
        torch.from_numpy(ch["m_seed"]), n_tan)
    assert fk.LAUNCHES["smoother_mean_batch_tan"] == 0
    assert port.shape == ref.shape
    errs = cv.slice_errs(port, ref, q, 1)
    assert max(errs) <= SCALED_TOL, errs
