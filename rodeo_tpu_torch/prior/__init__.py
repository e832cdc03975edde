from rodeo_tpu_torch.prior.ibm import ibm_init, ibm_state

__all__ = ["ibm_init", "ibm_state"]
