r"""
Many MCMC chains on one card (port of the single-device part of
:mod:`rodeo_tpu.parallel`): the lockstep runners of
:mod:`~rodeo_tpu_torch.parallel.chains` (random walk over posterior draws,
MALA, HMC, MAGI's Gibbs sampler) and :mod:`~rodeo_tpu_torch.parallel.nuts`
over the fused entry points, the chains of any pseudo-marginal algorithm
(:func:`run_chains`), and the diagnostics of
:mod:`~rodeo_tpu_torch.parallel.diagnostics`.  The JAX package's device
mesh, sharded fused entry points and sharded solvers wait for
``ROADMAP.md`` queue 1 item 8.
"""
from rodeo_tpu_torch.parallel.chains import (
    run_chains, make_run_chains, run_chains_fused, make_chain_runner,
    make_mala_runner, run_chains_mala_fused, run_chains_mala_magi,
    make_hmc_runner, run_chains_hmc_fused, run_chains_hmc_magi,
    adapt_step_size, adapt_warmup, magi_sig2_quadform,
    run_chains_magi_gibbs, sharded_loglik)
from rodeo_tpu_torch.parallel.diagnostics import ess, rhat
from rodeo_tpu_torch.parallel.nuts import (
    make_nuts_runner, run_chains_nuts_fused, run_chains_nuts_magi)

__all__ = ["run_chains", "make_run_chains", "run_chains_fused",
           "make_chain_runner", "make_mala_runner", "run_chains_mala_fused",
           "run_chains_mala_magi", "make_hmc_runner", "run_chains_hmc_fused",
           "run_chains_hmc_magi", "adapt_step_size", "adapt_warmup",
           "magi_sig2_quadform", "run_chains_magi_gibbs", "sharded_loglik",
           "ess", "rhat", "make_nuts_runner", "run_chains_nuts_fused",
           "run_chains_nuts_magi"]
