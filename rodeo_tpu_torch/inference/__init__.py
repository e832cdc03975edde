r"""
Likelihood approximations and MCMC kernels for Bayesian parameter inference
in ODE models (port of :mod:`rodeo_tpu.inference`: basic, fenrir, DALTON and
its non-Gaussian form, the MAGI log-density, and
:mod:`~rodeo_tpu_torch.inference.pseudo_marginal`, the pseudo-marginal
random-walk kernels with their chain-state checkpoints).
"""
from rodeo_tpu_torch.inference import pseudo_marginal
from rodeo_tpu_torch.inference.basic import basic
from rodeo_tpu_torch.inference.fenrir import fenrir
from rodeo_tpu_torch.inference.dalton import dalton, daltonng
from rodeo_tpu_torch.inference.magi import magi_logdens

__all__ = ["basic", "fenrir", "dalton", "daltonng", "magi_logdens",
           "pseudo_marginal"]
