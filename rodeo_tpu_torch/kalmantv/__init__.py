r"""
Kalman kernel backends, selected by ``kalman_type`` (port of
:mod:`rodeo_tpu.kalmantv`).

Only the covariance form (``"standard"``) is ported; the square-root form
raises until it is.
"""
from rodeo_tpu_torch.kalmantv import standard

__all__ = ["standard", "get_backend"]


def get_backend(kalman_type):
    """Resolve a ``kalman_type`` string to a kernel module."""
    if kalman_type == "standard":
        return standard
    if kalman_type == "square-root":
        raise NotImplementedError(
            "kalman_type='square-root' is not ported to rodeo_tpu_torch yet")
    raise NotImplementedError(
        f"unknown kalman_type {kalman_type!r}; expected 'standard' "
        "('square-root' is not ported yet)")
