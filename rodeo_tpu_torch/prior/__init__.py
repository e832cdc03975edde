from rodeo_tpu_torch.prior.ibm import ibm_init, ibm_state
from rodeo_tpu_torch.prior.indep_init import indep_init

__all__ = ["ibm_init", "ibm_state", "indep_init"]
