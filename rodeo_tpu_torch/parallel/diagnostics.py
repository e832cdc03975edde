r"""
MCMC diagnostics: multi-chain effective sample size and split-
:math:`\widehat{R}` (port of :mod:`rodeo_tpu.parallel.diagnostics`, numpy
only, copied as it is so that the port imports nothing of the JAX
package).

Host-side (numpy) post-processing of sampled chains — the counterpart of
the reference's reliance on external samplers' diagnostics (blackjax /
arviz, neither a dependency here).  The estimators are the standard ones
(Vehtari, Gelman, Simpson, Carpenter & Bürkner 2021): multi-chain
autocovariance combination with Geyer's initial-monotone-positive-
sequence truncation for ESS, and split-:math:`\widehat{R}` on halved
chains for convergence.
"""
import numpy as np

__all__ = ["ess", "rhat"]


def _ess_1d(x):
    """Multi-chain ESS for one scalar parameter.  ``x``: (n_samples,
    n_chains)."""
    x = np.asarray(x, float)
    n, m = x.shape
    if n < 4:
        raise ValueError(f"need at least 4 samples per chain, got {n}")
    means = x.mean(axis=0)
    w_vars = x.var(axis=0, ddof=1)
    w = w_vars.mean()
    if w <= 0:
        return 0.0                       # all chains stuck
    # var_plus: the (over)estimate of the posterior variance
    var_plus = (n - 1) / n * w
    if m > 1:
        var_plus += means.var(ddof=1)
    # per-chain autocovariance via FFT (biased /n, as the estimator wants)
    xc = x - means
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real / n
    rho = 1.0 - (w - acov.mean(axis=1)) / var_plus   # (n,)
    # Geyer: paired sums, keep while positive, enforce monotone decrease
    tau = 1.0                            # = rho_0 contribution
    prev = np.inf
    for k in range(1, (n - 1) // 2):
        pair = rho[2 * k - 1] + rho[2 * k]
        if pair <= 0:
            break
        pair = min(pair, prev)
        tau += 2.0 * pair
        prev = pair
    return float(m * n / tau)


def ess(samples):
    r"""
    Multi-chain effective sample size.

    Args:
        samples (ndarray(n_samples, n_chains) |
            ndarray(n_samples, n_chains, n_param)): Sampled positions —
            the layout every runner in :mod:`rodeo_tpu_torch.parallel.chains`
            returns.

    Returns:
        (float | ndarray(n_param,)): Total ESS across chains (the
        combined estimator penalizes between-chain disagreement, so
        unconverged chains read low even when individually well-mixed).
    """
    samples = np.asarray(samples, float)
    if samples.ndim == 2:
        return _ess_1d(samples)
    if samples.ndim != 3:
        raise ValueError(
            f"expected (n_samples, n_chains[, n_param]), got shape "
            f"{samples.shape}")
    return np.array([_ess_1d(samples[:, :, j])
                     for j in range(samples.shape[2])])


def rhat(samples):
    r"""
    Split-:math:`\widehat{R}` convergence diagnostic: each chain is
    halved (catching within-chain drift), then the classic
    between/within variance ratio is taken over the ``2 m`` half-chains.
    Values near 1 indicate convergence; > 1.01 is suspect by the modern
    guideline.

    Args / layout as :func:`ess`; returns a float or ``(n_param,)``.
    """
    samples = np.asarray(samples, float)
    was_2d = samples.ndim == 2
    if was_2d:
        samples = samples[:, :, None]
    elif samples.ndim != 3:
        raise ValueError(
            f"expected (n_samples, n_chains[, n_param]), got shape "
            f"{samples.shape}")
    n = samples.shape[0]
    half = n // 2
    if half < 2:
        raise ValueError(f"need at least 4 samples per chain, got {n}")
    # (half, 2m, p) split chains
    x = np.concatenate([samples[:half], samples[half:2 * half]], axis=1)
    w = x.var(axis=0, ddof=1).mean(axis=0)           # (p,)
    b = half * x.mean(axis=0).var(axis=0, ddof=1)    # (p,)
    var_plus = (half - 1) / half * w + b / half
    out = np.sqrt(var_plus / np.where(w > 0, w, np.nan))
    return float(out[0]) if was_2d else out
