"""
The fused likelihoods at the instances that K7a, K7b and K8 took last
(q = 4 and 5, the models Chkrebtii, Hes1 and SEIRAH), on the CPU, against
the JAX package's fused entries, whose Pallas kernels run in interpret
mode, on the same numpy-seeded lanes and observations
(``tests/coverage_value_cases.py``): ``fenrir_fused_batch`` (K1, K7b),
``fenrir_fused`` (K3, K7a) and ``dalton_fused_batch`` (K8, twice).
Chkrebtii's ODE runs kramer at q = 4 and 5; Hes1 and SEIRAH kramer, the JAX
package's Jacobian by ``jvp_jac_flat``, and rodeo.  fenrir's values are held
to LOGLIK_RTOL = 1e-4 and DALTON's to DALTON_RTOL = 1e-3 relative
(tests/test_torch_likelihood.py), at q = 5 to Q5_TOL and DALTON_Q5_TOL
(rounding-bound in both packages); and the instance tables to what the
value path's kernels hold.
"""
import jax
import numpy as np
import pytest

import coverage_value_cases as cv
from rodeo_tpu.ops import pallas_dalton as pd
from rodeo_tpu.ops import pallas_fenrir as pf

from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk


def _jax_batch(c, entry):
    """The JAX package's lane-batched likelihood of case ``c``."""
    common = cv.jax_common(c)
    obs = c["obs"]
    if entry == "fenrir_fused_batch":
        fn = jax.jit(lambda ts, x0: pf.fenrir_fused_batch(
            thetas=ts, ode_inits=x0, interrogation=c["mode"], **obs,
            **common))
    else:
        fn = jax.jit(lambda ts, x0: pd.dalton_fused_batch(
            thetas=ts, ode_inits=x0, **obs, **common))
    return cv.jax_lanes(c, fn)


@pytest.mark.parametrize("entry", ["fenrir_fused_batch",
                                   "dalton_fused_batch"])
@pytest.mark.parametrize("name", sorted(cv.CASES))
def test_batched_likelihoods_match_jax(name, entry):
    """Each lane's fenrir (K1, K7b) and DALTON (K8) against the JAX
    package's on the same lanes and observations."""
    c = cv.case(name)
    args, kw, obs = cv.port_args(c)
    counts = ff.LAUNCHES if entry == "fenrir_fused_batch" else fd.LAUNCHES
    before = dict(counts)
    mod = ff if entry == "fenrir_fused_batch" else fd
    port = getattr(mod, entry)(*args, **obs, **kw)
    assert counts == before               # the CPU takes the twins
    ref = _jax_batch(c, entry)
    tol = cv.tol(name, cv.LOGLIK_RTOL) if entry == "fenrir_fused_batch" \
        else cv.tol(name, cv.DALTON_RTOL, cv.DALTON_Q5_TOL)
    assert port.shape == ref.shape == (cv.N_LANE,)
    err = np.abs(port.numpy() - ref) / np.abs(ref)
    assert np.isfinite(port.numpy()).all()
    assert err.max() <= tol, err


@pytest.mark.parametrize("name", sorted(cv.CASES))
def test_fenrir_fused_matches_jax(name):
    """One fenrir evaluation (K3, K7a) of the case's first lane against the
    JAX package's."""
    c = cv.case(name)
    tcfg, jcfg = c["tcfg"], c["jcfg"]
    _, kw, obs = cv.port_args(c)
    theta = cv._t(c["thetas"][0])
    port = ff.fenrir_fused(theta, tcfg["ode_weight"], cv._t(c["inits"][0]),
                           0.0, c["t_max"], cv.N_STEPS, tcfg["prior_pars"],
                           **obs, **kw)
    params = {} if c["model"] == "chkrebtii" else {
        "theta": np.asarray(c["thetas"][0])}
    ref = pf.fenrir_fused(
        None, None, jcfg["ode_weight"], c["inits"][0], 0.0, c["t_max"],
        cv.N_STEPS, None, jcfg["prior_pars"], **c["obs"],
        ode_flat=c["jflat"], jac_flat=c["jjac"], interrogation=c["mode"],
        **params)
    err = abs(float(port) - float(ref)) / abs(float(ref))
    assert err <= cv.tol(name, cv.LOGLIK_RTOL), err


def test_instance_tables_hold_the_value_path():
    """K6, K7a and K7b hold q = 3, 4 and 5; K8 and K11c, and daltonng's K9
    and K11d, kramer and rodeo on Lorenz63, FitzHugh-Nagumo, Hes1 and
    SEIRAH at q = 3, Chkrebtii's ODE at q = 4 and 5 and FitzHugh-Nagumo at
    q = 4 and 5, as K11a does; K11b and K11e q = 3, 4 and 5 (the gradient
    path, tests/test_torch_coverage_grad.py,
    tests/test_torch_coverage_dalton*.py and
    tests/test_torch_coverage_daltonng*.py); MAGI and the stationary solve
    what they held before."""
    q345 = {(None, None, q) for q in (3, 4, 5)}
    for kernel in ("sampler_batch", "fenrir_backward_batch",
                   "fenrir_backward_single", "fenrir_backward_batch_tan",
                   "smoother_mean_batch_tan"):
        assert fk._INSTANCES[kernel] == q345
    first = ("Lorenz63", "FitzHughNagumo", "Hes1", "Seirah")
    k11a = {(m, md, q) for md in ("kramer", "rodeo")
            for m, q in [(m, 3) for m in first] + [
                (m, q) for m in ("Chkrebtii", "FitzHughNagumo")
                for q in (4, 5)]}
    for kernel in ("filter_batch_tan", "dalton_filter_batch",
                   "dalton_filter_batch_tan", "filter_nn_batch",
                   "filter_nn_batch_tan"):
        assert fk._INSTANCES[kernel] == k11a
    for kernel in ("magi_batch", "magi_adjoint_batch"):
        assert fk._INSTANCES[kernel] == {(None, None, 3)}
    for kernel in ("mean_gain_single", "mean_boundary_single",
                   "mean_recovery_single"):
        assert fk._INSTANCES[kernel] == {
            (m, None, 3) for m in ("Lorenz63", "FitzHughNagumo")}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("how,q", [("kramer", 6), ("rodeo", 6),
                                   ("schober", 3), ("chkrebtii", 3),
                                   ("schober", 4)])
def test_daltonng_refuses_other_instances(how, q, device):
    """daltonng_fused_batch and its gradient refuse FitzHugh-Nagumo at
    q = 6 (padded past q = 5) and the schober and chkrebtii interrogations,
    naming the kernel that lacks the instance, on CPU tensors and for the
    card too: the refusal comes before any tensor moves to the device, so
    it needs no card here; the kernel wrappers refuse on the same gate."""
    import torch

    from rodeo_tpu_torch.models import fitzhugh
    from rodeo_tpu_torch.models import obs as obs_models
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    cfg = fitzhugh.setup(n_steps=8, t_max=0.4, dtype=torch.float32,
                         device="cpu", n_deriv=q)
    args = (cfg["theta"][None], cfg["ode_weight"], cfg["ode_init"][None],
            0.0, 0.4, 8, cfg["prior_pars"], torch.ones((2, 2, 1)),
            torch.tensor([0.0, 0.4]), obs_models.gauss(0.005), (0,),
            "fitzhugh")
    for entry, kernel in ((fdn.daltonng_fused_batch, "filter_nn_batch"),
                          (fdn.daltonng_fused_batch_grad,
                           "filter_nn_batch_tan")):
        with pytest.raises(NotImplementedError, match=kernel):
            entry(*args, interrogation=how, device=device)
        with pytest.raises(NotImplementedError, match=kernel):
            fk._check_instance(kernel, q, "FitzHughNagumo", how)
