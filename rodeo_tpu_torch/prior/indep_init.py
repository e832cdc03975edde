r"""
Stacked block prior parameters collapsed into one dense block (port of
:mod:`rodeo_tpu.prior.indep_init`), for the non-blocked layout: one
``(d q, d q)`` state instead of ``d`` independent ``(q, q)`` blocks.
"""
import torch

__all__ = ["indep_init"]


def _block_diag(blocks):
    """Block diagonal of stacked ``(n_block, p, q)`` blocks, or of a
    sequence of blocks of any sizes."""
    if isinstance(blocks, torch.Tensor) and blocks.ndim == 3:
        n, p, q = blocks.shape
        out = blocks.new_zeros((n, p, n, q))
        idx = torch.arange(n, device=blocks.device)
        out[idx, :, idx, :] = blocks
        return out.reshape(n * p, n * q)
    return torch.block_diag(*blocks)


def indep_init(prior_pars):
    r"""
    Combine blocks of prior parameters into dense matrices.

    Args:
        prior_pars (tuple): ``(prior_weight, prior_var)``, stacked blocks
            ``(n_block, p, p)``.

    Returns:
        (tuple): ``(prior_weight, prior_var)`` as single dense blocks
        ``(1, n_block p, n_block p)``.
    """
    prior_weight, prior_var = prior_pars
    return _block_diag(prior_weight)[None], _block_diag(prior_var)[None]
