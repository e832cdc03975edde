"""
The port's MCMC diagnostics (rodeo_tpu_torch.parallel.diagnostics, numpy
only) against the JAX package's on the same arrays: effective sample size
and split-Rhat on IID and AR(1) chains, on chains that disagree, with a
parameter axis, and from a tensor; both packages raise the same errors.
The port keeps its own copy of the code, so the values are equal to the
last bit.
"""
import numpy as np
import pytest
import torch

from rodeo_tpu.parallel import diagnostics as jd
from rodeo_tpu_torch.parallel import diagnostics as td


def _ar1(rng, n, m, rho):
    x = np.zeros((n, m))
    x[0] = rng.normal(size=m)
    innov = rng.normal(size=(n, m)) * np.sqrt(1 - rho ** 2)
    for t in range(1, n):
        x[t] = rho * x[t - 1] + innov[t]
    return x


def _chains(kind):
    rng = np.random.default_rng(11)
    if kind == "iid":
        return rng.normal(size=(400, 8))
    if kind == "ar1":
        return _ar1(rng, 600, 6, 0.8)
    if kind == "disagreeing":
        return rng.normal(size=(300, 4)) + np.array([0.0, 3.0, -3.0, 6.0])
    if kind == "drift":
        return rng.normal(size=(300, 6)) + np.linspace(0, 4, 300)[:, None]
    if kind == "stuck":
        return np.ones((50, 3))
    return rng.normal(size=(200, 4, 3)) * np.array([1.0, 2.0, 0.5])


@pytest.mark.parametrize("kind", ["iid", "ar1", "disagreeing", "drift",
                                  "stuck", "param_axis"])
def test_ess_and_rhat_equal_the_jax_package(kind):
    x = _chains(kind)
    e_j, e_t = jd.ess(x), td.ess(x)
    np.testing.assert_array_equal(np.asarray(e_t), np.asarray(e_j))
    with np.errstate(invalid="ignore"):
        r_j, r_t = jd.rhat(x), td.rhat(x)
    np.testing.assert_array_equal(np.asarray(r_t), np.asarray(r_j))
    if kind == "param_axis":
        assert e_t.shape == (3,) and r_t.shape == (3,)
    else:
        assert isinstance(e_t, float) and isinstance(r_t, float)


def test_a_cpu_tensor_reads_as_its_array():
    x = _chains("ar1").astype(np.float32)
    assert td.ess(torch.from_numpy(x)) == jd.ess(x)
    assert td.rhat(torch.from_numpy(x)) == jd.rhat(x)


@pytest.mark.parametrize("fn", ["ess", "rhat"])
@pytest.mark.parametrize("shape", [(3, 4), (3, 4, 2), (10,), (5, 4, 3, 2)])
def test_both_packages_raise_the_same_errors(fn, shape):
    x = np.zeros(shape)
    with pytest.raises(ValueError) as e_j:
        getattr(jd, fn)(x)
    with pytest.raises(ValueError) as e_t:
        getattr(td, fn)(x)
    assert str(e_t.value) == str(e_j.value)
