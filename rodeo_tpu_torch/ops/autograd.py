r"""
The lane-batched likelihoods as differentiable PyTorch functions.

:func:`fused_loglik` wraps one of the gradient entry points
(:func:`~rodeo_tpu_torch.ops.fused_fenrir.fenrir_fused_batch_grad`,
:func:`~rodeo_tpu_torch.ops.fused_dalton.dalton_fused_batch_grad`,
:func:`~rodeo_tpu_torch.ops.fused_kalman.basic_fused_batch_grad`) in a
``torch.autograd.Function``: its forward returns the log-likelihood of each
lane and keeps the gradient that the forward-mode tangent kernels computed
beside it, and its backward hands that gradient to ``thetas``.  It gives
the numbers of the explicit ``(loglik, grad)`` return, in PyTorch's idiom::

    loglik = fused_loglik(fenrir_fused_batch_grad, thetas, **problem)
    loglik.sum().backward()          # thetas.grad is (B, n_theta)

Only ``thetas`` receives a gradient; every other argument is a constant.
"""
import torch

__all__ = ["FusedLoglik", "fused_loglik"]


class FusedLoglik(torch.autograd.Function):
    """``loglik (B,)`` of ``grad_fn(thetas=thetas, **kwargs)``; backward
    ``grad_output[:, None] * grad``."""

    @staticmethod
    def forward(ctx, thetas, grad_fn, kwargs):
        loglik, grad = grad_fn(thetas=thetas.detach(), **kwargs)[:2]
        ctx.save_for_backward(grad)
        ctx.theta_like = (thetas.device, thetas.dtype)
        return loglik

    @staticmethod
    def backward(ctx, grad_output):
        grad, = ctx.saved_tensors
        device, dtype = ctx.theta_like
        return (grad_output[:, None] * grad).to(device, dtype), None, None


def fused_loglik(grad_fn, thetas, **kwargs):
    """The log-likelihood ``(B,)`` of ``grad_fn`` (one of the
    ``*_fused_batch_grad`` entry points) at ``thetas (B, n_theta)``, with
    the gradient those kernels compute attached for ``backward``.
    ``kwargs`` are ``grad_fn``'s other arguments."""
    return FusedLoglik.apply(thetas, grad_fn, kwargs)
