r"""
Likelihood approximations for Bayesian parameter inference in ODE models
(port of :mod:`rodeo_tpu.inference`: basic, fenrir, DALTON and its
non-Gaussian form, and the MAGI log-density).
"""
from rodeo_tpu_torch.inference.basic import basic
from rodeo_tpu_torch.inference.fenrir import fenrir
from rodeo_tpu_torch.inference.dalton import dalton, daltonng
from rodeo_tpu_torch.inference.magi import magi_logdens

__all__ = ["basic", "fenrir", "dalton", "daltonng", "magi_logdens"]
