r"""
Observation models of non-Gaussian DALTON (the per-component
log-likelihoods that the JAX package's tests and benchmark hand to
:func:`rodeo_tpu.ops.pallas_daltonng.daltonng_fused_batch` as
``obs_comp_flat``).

The log-likelihood of observation ``i`` is the sum over blocks ``b`` and
observed components ``j`` of ``comp_flat(y_cols, x_col, j, th, iobs)``,
elementwise in the columns (the JAX package's signature): ``y_cols`` the
data columns, ``x_col`` the state component ``j`` in original coordinates,
``th`` the parameters ``(n_theta, B)`` and ``iobs`` the observation's index.
The Laplace linearisation needs its first and second derivative in
``x_col``, which the kernels and their twins take by evaluating it on a
second-order forward number (:class:`~rodeo_tpu_torch.ops.dual.Jet2`).

Each model here is a :class:`ObsModel`: that function, written in
operations that plain tensors, ``Jet2`` and ``Dual`` numbers all support
(the constant operand on the right of a ``Dual``), and the CUDA functor of
``ops/csrc/obs_models.cuh`` that computes the same thing in the same order,
with its float32 parameters.  A user's own observation callable cannot
reach the kernels yet: they run only the functors compiled in.
"""
import dataclasses
import functools
from typing import Callable

__all__ = ["ObsModel", "gauss", "poisson"]


@dataclasses.dataclass(frozen=True)
class ObsModel:
    """An observation model as the fused non-Gaussian DALTON sees it.

    Attributes:
        comp_flat: ``comp_flat(y_cols, x_col, j, th, iobs)``, the
            per-component log-likelihood.
        cuda_functor: Name of the functor in ``ops/csrc/obs_models.cuh``.
        pars: Its parameters, passed to the functor as float32.
    """
    comp_flat: Callable
    cuda_functor: str
    pars: tuple


def gauss_comp_flat(y_cols, x_col, j, th, iobs, inv_var):
    """``-0.5 (y - x)^2 / var`` as a product with ``inv_var = 1 / var``, the
    ``Gauss`` functor's arithmetic: PyTorch on CUDA divides by a Python
    scalar through its reciprocal, so a product rounds alike on the CPU, on
    the card and in the kernel."""
    r = y_cols[0] - x_col
    return -0.5 * (r * r) * inv_var


def poisson_comp_flat(y_cols, x_col, j, th, iobs, b0, b1):
    """Poisson counts at rate ``exp(b0 + b1 x)``: ``y (b0 + b1 x) -
    exp(b0 + b1 x)``; the ``Poisson`` functor's arithmetic."""
    loglam = b0 + b1 * x_col
    return loglam * y_cols[0] - loglam.exp()


def gauss(var):
    """Gaussian observations of variance ``var`` on each observed
    component."""
    inv_var = 1.0 / float(var)
    return ObsModel(functools.partial(gauss_comp_flat, inv_var=inv_var),
                    "Gauss", (inv_var,))


def poisson(b0, b1):
    """Poisson counts at rate ``exp(b0 + b1 x)`` on each observed
    component."""
    return ObsModel(functools.partial(poisson_comp_flat, b0=float(b0),
                                      b1=float(b1)),
                    "Poisson", (float(b0), float(b1)))
