"""
The port's lockstep HMC over fenrir (rodeo_tpu_torch.parallel.chains:
run_chains_hmc_fused, the twins of K11a and K11b) against the JAX
package's on the CPU, whose Pallas kernels run in interpret mode, fed the
JAX run's own draws (tests/mcmc_replay.py); the tolerances are
tests/fused_chains.py's.
"""
import fused_chains as fc


def test_hmc_fenrir_replays_jax():
    """8 lanes x 3 proposals of 3 leapfrog steps at step 0.002."""
    fc.replay_fused("hmc", "fenrir", 3, 0.002)
