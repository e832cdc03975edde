r"""
The port's default device.

Every entry point of :mod:`rodeo_tpu_torch` that builds or moves tensors
(the model setups, :func:`rodeo_tpu_torch.convert.from_numpy`, the fused
solve, the likelihoods and the sampler) takes ``device=None``, which means
the CUDA card.  Only an explicit ``device="cpu"`` runs on the CPU, where the
fused entry points take the plain PyTorch twins of their kernels.  Without
a card, the default raises: nothing falls back to the CPU.
"""
import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """The ``torch.device`` for ``device`` (``None`` means ``"cuda"``).

    Raises:
        RuntimeError: CUDA is asked for (or defaulted to) and there is no
            CUDA device.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rodeo_tpu_torch runs on the CUDA card by default and found "
            "none; pass device='cpu' to run the plain PyTorch path")
    return device
