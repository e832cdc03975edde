r"""
Import of parameters exported from the JAX package.

A configuration of :mod:`rodeo_tpu` (``prior_pars``, ``ode_weight``,
``ode_init``, ``theta``, ...) exported as numpy arrays becomes port tensors
on a given device and dtype, so that the same numbers drive both packages
without this one importing JAX.
"""
import numpy as np
import torch

__all__ = ["from_numpy"]


def from_numpy(tree, *, device=None, dtype=torch.float32):
    """
    Convert the numpy arrays in ``tree`` to tensors.

    Args:
        tree: A numpy array, or dicts / tuples / lists of them; Python
            scalars (``t_min``, ``n_steps``, ...) and ``None`` pass through.
        device: Device of the tensors.
        dtype: dtype of the floating-point tensors; other arrays keep
            theirs.

    Returns:
        ``tree`` with every array replaced by a tensor.
    """
    if isinstance(tree, (np.ndarray, np.generic)):
        arr = np.asarray(tree)
        if np.issubdtype(arr.dtype, np.floating):
            return torch.tensor(arr, dtype=dtype, device=device)
        return torch.tensor(arr, device=device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device=device, dtype=dtype)
                          for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(
        f"from_numpy takes numpy arrays and containers of them, got "
        f"{type(tree).__name__}")
