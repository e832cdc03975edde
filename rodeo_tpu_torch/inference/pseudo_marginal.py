r"""
Pseudo-marginal MCMC: random-walk Rosenbluth-Metropolis-Hastings kernels
with **auxiliary variables** (port of
:mod:`rodeo_tpu.inference.pseudo_marginal`).

The ``logdensity_fn`` has signature ``logdensity_fn(position, rng) ->
(logdensity, auxdata)``: the density is stochastic (e.g. a Chkrebtii-style
marginal likelihood evaluated on a fresh ODE draw) and the auxiliary data
(e.g. the sampled solution path) is carried in the chain state.

**Randomness.** Where the JAX package takes a PRNG key, these functions
take ``rng``: a ``torch.Generator`` (``None`` is PyTorch's default
generator of the tensors' device), or, in its place, the noise the
function would draw from it:

- :func:`generate_gaussian_noise` and a :func:`normal` proposal: the
  standard normals, shaped like the flattened position;
- :func:`static_binomial_sampling`: the uniform, shaped like the
  acceptance probability;
- a kernel's ``step`` (:func:`build_rmh` and the top-level APIs): a dict
  ``{"proposal": ..., "accept": ..., "logdensity": ...}`` of the noise
  its three parts take, the JAX package's three subkeys
  ``key_proposal, key_accept, key_logdensity``; the ``"logdensity"``
  entry is passed to ``logdensity_fn`` as its ``rng``, whatever it is.

With a generator, a step draws the proposal's noise, then evaluates the
log-density with the generator, then draws the uniform.  The kernels act
on one chain; :func:`rodeo_tpu_torch.parallel.run_chains` runs many.
Chain states are pytrees (:mod:`rodeo_tpu_torch.pytree`), and
:func:`save_state` / :func:`load_state` keep the JAX package's file
format, so a state moves between the two packages.
"""
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.pytree import (ravel, tree_flatten, tree_map,
                                    tree_structure, tree_unflatten)

__all__ = [
    "RWAState",
    "RWAInfo",
    "SamplingAlgorithm",
    "init",
    "normal",
    "build_rmh",
    "build_additive_step",
    "build_irmh",
    "build_rmh_transition_energy",
    "normal_random_walk",
    "additive_step_random_walk",
    "irmh_as_top_level_api",
    "rmh_as_top_level_api",
    "save_state",
    "load_state",
]


class RWAState(NamedTuple):
    """State of the Random Walk Auxiliary (RWA) chain."""

    position: Any
    """Current position of the chain."""

    logdensity: Any
    """Current value of the log-density."""

    auxdata: Any = None
    """Current value of the auxiliary data."""


class RWAInfo(NamedTuple):
    """Additional information about one RWA chain step."""

    acceptance_rate: Any
    """Acceptance probability of the proposed transition."""

    is_accepted: Any
    """Whether the proposed state was accepted."""

    proposal: RWAState
    """The proposed state of the chain."""


class SamplingAlgorithm(NamedTuple):
    """A pair of functions ``(init, step)`` defining an MCMC algorithm
    (blackjax-compatible interface): ``init(position, rng=None)`` and
    ``step(rng, state) -> (state, info)``."""

    init: Callable
    step: Callable


def _is_source(rng):
    """Whether ``rng`` is a source of draws (a generator, or ``None`` for
    the default one) rather than the draws themselves."""
    return rng is None or isinstance(rng, torch.Generator)


# --- building blocks -----------------------------------------------------------


def init(position, logdensity_fn: Callable, rng=None) -> RWAState:
    """Create an initial chain state from a position; ``rng`` goes to
    ``logdensity_fn``, since the density is stochastic."""
    logdensity, auxdata = logdensity_fn(position, rng)
    return RWAState(position, logdensity, auxdata)


def generate_gaussian_noise(rng, position, sigma):
    """
    Gaussian noise with the same pytree structure as ``position``.

    ``sigma`` may be a scalar, a vector of per-coordinate standard
    deviations, or a full covariance square-root matrix (as in
    ``blackjax.util.generate_gaussian_noise``).  ``rng``: a generator, or
    the standard normals, shaped like the flattened position.
    """
    flat, unravel = ravel(position)
    if _is_source(rng):
        z = torch.randn(flat.shape, generator=rng, dtype=flat.dtype,
                        device=flat.device)
    else:
        z = torch.as_tensor(rng, dtype=flat.dtype,
                            device=flat.device).reshape(flat.shape)
    sigma = torch.as_tensor(sigma, dtype=flat.dtype, device=flat.device)
    if sigma.ndim <= 1:
        noise = sigma * z
    elif sigma.ndim == 2:
        noise = sigma @ z
    else:
        raise ValueError("sigma must be a scalar, vector or matrix.")
    return unravel(noise)


def normal(sigma) -> Callable:
    """Normal random-walk proposal: step ~ N(0, sigma sigma');
    ``propose(rng, position)``."""
    if np.ndim(sigma) > 2:
        raise ValueError("sigma must be a vector or a matrix.")

    def propose(rng, position):
        return generate_gaussian_noise(rng, position, sigma)

    return propose


def static_binomial_sampling(rng, log_p_accept, prev_state, new_state):
    """
    Metropolis accept/reject with probability ``min(1, exp(log_p_accept))``:
    a uniform below it accepts (``blackjax.mcmc.proposal.
    static_binomial_sampling``).  ``rng``: a generator, or the uniform.
    """
    p_accept = torch.clamp(torch.exp(torch.as_tensor(log_p_accept)),
                           max=1.0)
    if _is_source(rng):
        u = torch.rand(p_accept.shape, generator=rng, dtype=p_accept.dtype,
                       device=p_accept.device)
    else:
        u = torch.as_tensor(rng, dtype=p_accept.dtype,
                            device=p_accept.device)
    do_accept = u < p_accept
    accepted_state = tree_map(
        lambda new, prev: torch.where(do_accept, new, prev),
        new_state, prev_state)
    return accepted_state, (do_accept, p_accept, None)


def build_rmh_transition_energy(
        proposal_logdensity_fn: Optional[Callable]) -> Callable:
    """
    Transition energy of an RMH move.

    ``proposal_logdensity_fn(state_from, state_to)`` must return the
    log-density of the proposal move *from* the first argument *to* the
    second (:math:`\\log q(x_{\\text{to}} \\mid x_{\\text{from}})`), so
    that the acceptance ratio is the textbook
    :math:`\\pi(x') q(x \\mid x') / [\\pi(x)\\, q(x' \\mid x)]`.
    """
    if proposal_logdensity_fn is None:

        def transition_energy(prev_state, new_state):
            return -new_state.logdensity

    else:

        def transition_energy(prev_state, new_state):
            return -new_state.logdensity - proposal_logdensity_fn(
                new_state, prev_state)

    return transition_energy


def compute_asymmetric_acceptance_ratio(
        transition_energy: Callable) -> Callable:
    """Log acceptance ratio from a transition energy (the blackjax
    convention)."""

    def acceptance_ratio(prev_state, new_state):
        return transition_energy(new_state, prev_state) - \
            transition_energy(prev_state, new_state)

    return acceptance_ratio


def rmh_proposal(
    logdensity_fn: Callable,
    transition_distribution: Callable,
    compute_acceptance_ratio: Callable,
    sample_proposal: Callable = static_binomial_sampling,
) -> Callable:
    """
    Generator of RMH sample proposals with auxiliary data:
    ``generate(rng, previous_state)``, ``rng`` a generator or the dict of
    the proposal's, the acceptance's and the log-density's noise (the
    stochastic log-density gets its own each step).
    """

    def generate(rng, previous_state: RWAState):
        if _is_source(rng):
            rng_proposal = rng_accept = rng_logdensity = rng
        else:
            rng_proposal, rng_accept, rng_logdensity = (
                rng["proposal"], rng["accept"], rng["logdensity"])
        position = previous_state.position
        new_position = transition_distribution(rng_proposal, position)
        new_logdensity, new_auxdata = logdensity_fn(new_position,
                                                    rng_logdensity)
        proposed_state = RWAState(new_position, new_logdensity, new_auxdata)
        log_p_accept = compute_acceptance_ratio(previous_state,
                                                proposed_state)
        accepted_state, info = sample_proposal(
            rng_accept, log_p_accept, previous_state, proposed_state)
        do_accept, p_accept, _ = info
        return accepted_state, do_accept, p_accept

    return generate


# --- kernels --------------------------------------------------------------------


def build_rmh():
    """
    Build a Rosenbluth-Metropolis-Hastings kernel with auxiliary variables:
    ``kernel(rng, state, logdensity_fn, transition_generator,
    proposal_logdensity_fn=None) -> (RWAState, RWAInfo)``.
    """

    def kernel(rng, state: RWAState, logdensity_fn: Callable,
               transition_generator: Callable,
               proposal_logdensity_fn: Optional[Callable] = None):
        transition_energy = build_rmh_transition_energy(
            proposal_logdensity_fn)
        acceptance_ratio = compute_asymmetric_acceptance_ratio(
            transition_energy)
        proposal_generator = rmh_proposal(
            logdensity_fn, transition_generator, acceptance_ratio)
        new_state, do_accept, p_accept = proposal_generator(rng, state)
        return new_state, RWAInfo(p_accept, do_accept, new_state)

    return kernel


def build_additive_step():
    """RMH kernel with an additive-step proposal (``x' = x + step``)."""

    def kernel(rng, state: RWAState, logdensity_fn: Callable,
               random_step: Callable):
        def proposal_generator(rng_proposal, position):
            move = random_step(rng_proposal, position)
            return tree_map(torch.add, position, move)

        inner_kernel = build_rmh()
        return inner_kernel(rng, state, logdensity_fn, proposal_generator)

    return kernel


def build_irmh() -> Callable:
    """Independent-proposal RMH kernel: ``proposal_distribution(rng)``
    does not depend on the current position."""

    def kernel(rng, state: RWAState, logdensity_fn: Callable,
               proposal_distribution: Callable,
               proposal_logdensity_fn: Optional[Callable] = None):
        def proposal_generator(rng_proposal, position):
            del position
            return proposal_distribution(rng_proposal)

        inner_kernel = build_rmh()
        return inner_kernel(
            rng, state, logdensity_fn, proposal_generator,
            proposal_logdensity_fn)

    return kernel


# --- top-level APIs ---------------------------------------------------------------


def additive_step_random_walk(logdensity_fn: Callable,
                              random_step: Callable) -> SamplingAlgorithm:
    """User interface for the additive-step RMH."""
    kernel = build_additive_step()

    def init_fn(position, rng=None):
        return init(position, logdensity_fn, rng)

    def step_fn(rng, state):
        return kernel(rng, state, logdensity_fn, random_step)

    return SamplingAlgorithm(init_fn, step_fn)


def normal_random_walk(logdensity_fn: Callable, sigma) -> SamplingAlgorithm:
    """Gaussian additive-step random-walk Metropolis-Hastings sampler."""
    return additive_step_random_walk(logdensity_fn, normal(sigma))


def irmh_as_top_level_api(
    logdensity_fn: Callable,
    proposal_distribution: Callable,
    proposal_logdensity_fn: Optional[Callable] = None,
) -> SamplingAlgorithm:
    """
    User interface for the independent RMH.  ``proposal_logdensity_fn(
    state_from, state_to)`` (an independent proposal is not symmetric)
    follows :func:`build_rmh_transition_energy`'s convention: for an
    independent proposal ``q``, simply ``log q(state_to.position)``.
    """
    kernel = build_irmh()

    def init_fn(position, rng=None):
        return init(position, logdensity_fn, rng)

    def step_fn(rng, state):
        return kernel(rng, state, logdensity_fn,
                      proposal_distribution, proposal_logdensity_fn)

    return SamplingAlgorithm(init_fn, step_fn)


def rmh_as_top_level_api(
    logdensity_fn: Callable,
    proposal_generator: Callable,
    proposal_logdensity_fn: Optional[Callable] = None,
) -> SamplingAlgorithm:
    """
    User interface for the general RMH; for an asymmetric
    ``proposal_generator(rng, position)``, supply
    ``proposal_logdensity_fn(state_from, state_to)`` (see
    :func:`build_rmh_transition_energy`).
    """
    kernel = build_rmh()

    def init_fn(position, rng=None):
        return init(position, logdensity_fn, rng)

    def step_fn(rng, state):
        return kernel(rng, state, logdensity_fn,
                      proposal_generator, proposal_logdensity_fn)

    return SamplingAlgorithm(init_fn, step_fn)


def save_state(path, state: RWAState):
    """
    Checkpoint a (possibly many-chain) chain state to ``path`` (.npz): its
    leaves in pytree order as ``leaf_0 .. leaf_{n-1}`` and their count as
    ``n_leaves``, the JAX package's format.
    """
    leaves, _ = tree_flatten(state)
    np.savez(path, n_leaves=len(leaves), **{
        f"leaf_{i}": (x.detach().cpu().numpy()
                      if isinstance(x, torch.Tensor) else np.asarray(x))
        for i, x in enumerate(leaves)})


def load_state(path, like: RWAState = None, device=None) -> RWAState:
    """Restore a chain state saved by :func:`save_state` (or by the JAX
    package's).

    Args:
        path: File path.
        like (RWAState | None): A state with the same pytree structure
            (needed when ``position``/``auxdata`` are non-trivial pytrees);
            defaults to the flat single-leaf-per-field layout.
        device: Device of the restored tensors; ``None`` means the CUDA
            card (:func:`rodeo_tpu_torch.device.resolve_device`).
    """
    device = resolve_device(device)
    with np.load(path) as data:
        n = int(data["n_leaves"])
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
                  for i in range(n)]
    template = like if like is not None else RWAState(
        position=0, logdensity=0.0, auxdata=0)
    return tree_unflatten(tree_structure(template), leaves)
