r"""
Likelihood approximations for Bayesian parameter inference in ODE models
(port of :mod:`rodeo_tpu.inference`; so far the MAGI log-density).
"""
from rodeo_tpu_torch.inference.magi import magi_logdens

__all__ = ["magi_logdens"]
