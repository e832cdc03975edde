r"""
Likelihood approximations for Bayesian parameter inference in ODE models
(port of :mod:`rodeo_tpu.inference`; so far the MAGI log-density and
non-Gaussian DALTON).
"""
from rodeo_tpu_torch.inference.dalton import daltonng
from rodeo_tpu_torch.inference.magi import magi_logdens

__all__ = ["daltonng", "magi_logdens"]
