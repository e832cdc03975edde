r"""
Many MCMC chains on one card (port of the single-device part of
:mod:`rodeo_tpu.parallel.chains`).

- :func:`run_chains` runs a :class:`~rodeo_tpu_torch.inference.
  pseudo_marginal.SamplingAlgorithm` for each chain, a plain loop over the
  chains (``torch.func.vmap`` cannot carry the torch-op solvers: their
  ``eigh`` factor is an ``autograd.Function`` without a batching rule);
- the **lockstep** runners advance all chains ("lanes") at once, each step
  ONE call of a lane-batched fused entry point for every lane: the
  pseudo-marginal random walk over posterior draws
  (:func:`run_chains_fused`: kernels K1 and K6), MALA and HMC over the
  fenrir or DALTON likelihood (:func:`run_chains_mala_fused`,
  :func:`run_chains_hmc_fused`: K11a and K11b, or K11c) and over MAGI's path
  posterior (:func:`run_chains_mala_magi`, :func:`run_chains_hmc_magi`,
  and the Gibbs sampler of the path and :math:`\sigma^2`,
  :func:`run_chains_magi_gibbs`: K10a and K10b), and the same for any
  ``logpost_grad_fn`` (:func:`make_mala_runner`, :func:`make_hmc_runner`);
  NUTS is in :mod:`rodeo_tpu_torch.parallel.nuts`.

**Randomness.** Each runner's ``run`` takes ``generator=`` (a
``torch.Generator`` on the chains' device; ``None`` is PyTorch's default
generator there) or, in its place, ``noise=``: a dict of the tensors one
run consumes, each with the step (or sweep) as its leading axis, the keys
and shapes in each runner's docstring.  Every step first takes its normals
and uniforms (drawn from the generator in the dict's order, or read from
``noise``), then runs on them.  A test replays the JAX package's runner by
rebuilding its key tree with ``jax.random`` and passing the draws as
``noise``.  Uniforms accept as ``log(u) < log_ratio``; a NaN ratio never
accepts, and a rejected lane keeps its position, its log-density (the
rejected-state estimate, as pseudo-marginal sampling requires) and its
gradient, lane by lane.

A step makes no host synchronisation of its own: the only reads of device
values are :func:`adapt_step_size`'s mean acceptance per window and NUTS's
check per doubling.  The runners over the fused entry points run on the
CUDA card unless given ``device="cpu"``, where the entry points take the
plain twins of their kernels.  The entry points take ``model=`` (a
compiled model) where the JAX package takes ``ode_flat``/``jac_flat``; the
TPU layout options ``chunk`` and ``interpret`` have no counterpart.
Sharding over a device mesh waits for the port of the JAX package's
``parallel/mesh.py`` and ``fused.py`` (``ROADMAP.md`` queue 1 item 8):
``mesh=`` raises.
"""
import math

import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.pytree import tree_leaves, tree_map

__all__ = ["run_chains", "make_run_chains", "run_chains_fused",
           "make_chain_runner", "make_mala_runner",
           "run_chains_mala_fused", "run_chains_mala_magi",
           "make_hmc_runner", "run_chains_hmc_fused",
           "run_chains_hmc_magi", "adapt_step_size", "adapt_warmup",
           "magi_sig2_quadform", "run_chains_magi_gibbs",
           "sharded_loglik"]

_NO_MESH = ("sharding over a device mesh waits for the port of "
            "parallel/mesh.py and parallel/fused.py (ROADMAP.md queue 1 "
            "item 8, multi-device); pass mesh=None")


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)


def _noise_on(noise, device):
    """``noise``'s tensors on ``device``, floating ones in float32."""
    if noise is None:
        return None

    def move(x):
        x = torch.as_tensor(x, device=device)
        return x.float() if x.is_floating_point() else x

    return tree_map(move, noise)


def _at(tree, *index):
    """Every leaf of ``tree`` at ``index`` of its leading axes."""
    return tree_map(lambda x: x[index], tree)


def _stack(trees):
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _normals(shape, device, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def _uniforms(n, device, generator):
    return torch.rand((n,), generator=generator, dtype=torch.float32,
                      device=device)


def _accept(u, log_ratio):
    """``log(u) < log_ratio``, a NaN ratio never accepting."""
    return torch.log(u) < torch.nan_to_num(log_ratio, nan=-math.inf)


def _keep(accept, new, old):
    """Per lane (the leading axis): ``new`` where ``accept``, else
    ``old``."""
    return tree_map(lambda a, b: torch.where(
        accept.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), new, old)


# --- chains of any SamplingAlgorithm -------------------------------------------


def run_chains(alg, init_positions, generator, n_samples, mesh=None,
               axis_name="chain", noise=None):
    r"""
    Run many MCMC chains of one algorithm on one device.

    Args:
        alg (SamplingAlgorithm): e.g.
            :func:`rodeo_tpu_torch.inference.pseudo_marginal.
            normal_random_walk`, with ``alg.init(position, rng)`` and
            ``alg.step(rng, state)``.
        init_positions (pytree): Initial positions with a leading chain
            axis of size ``n_chains``.
        generator (torch.Generator | None): Source of every draw, in the
            order init of chain 0, 1, ..., then step 0 of chain 0, 1, ...
        n_samples (int): Number of MCMC steps.
        mesh: Must be ``None``: sharding waits for ``ROADMAP.md`` queue 1
            item 8.
        axis_name (str): The JAX package's mesh axis; unused.
        noise (dict | None): In place of ``generator``: ``{"init": ...,
            "step": ...}``, the ``rng`` of each chain's ``alg.init`` (a
            pytree whose leaves have the leading axis ``(n_chains,)``) and
            of each ``alg.step`` (leading axes ``(n_samples, n_chains)``),
            e.g. ``{"proposal", "accept", "logdensity"}`` for the
            pseudo-marginal kernels.

    Returns:
        (tuple):
        - **positions** (pytree): Sampled positions with shape
          ``(n_samples, n_chains, ...)``.
        - **final_state** (RWAState): Final chain state, chains stacked on
          the leading axis.
        - **accept_rate** (Tensor(n_chains,)): Mean acceptance rate.
    """
    runner = make_run_chains(alg, n_samples, mesh=mesh,
                             axis_name=axis_name)
    return runner(init_positions, generator, noise=noise)


def make_run_chains(alg, n_samples, mesh=None, axis_name="chain"):
    r"""
    Build the multi-chain runner of :func:`run_chains`:
    ``runner(init_positions, generator=None, noise=None) -> (positions,
    final_state, accept_rate)``.  Each step runs ``alg.step`` once per
    chain, in a loop over the chains.
    """
    _check_mesh(mesh)
    del axis_name

    def run(init_positions, generator=None, noise=None):
        n_chains = tree_leaves(init_positions)[0].shape[0]

        def rng(part, *index):
            return generator if noise is None else _at(noise[part], *index)

        states = [alg.init(_at(init_positions, c), rng("init", c))
                  for c in range(n_chains)]
        positions, accepted = [], []
        for i in range(n_samples):
            flags = []
            for c in range(n_chains):
                states[c], info = alg.step(rng("step", i, c), states[c])
                flags.append(torch.as_tensor(info.is_accepted))
            positions.append(_stack([s.position for s in states]))
            accepted.append(torch.stack(flags))
        accept_rate = torch.stack(accepted).float().mean(0)
        return _stack(positions), _stack(states), accept_rate

    return run


def sharded_loglik(loglik_fn, thetas, keys=None, mesh=None,
                   axis_name="batch"):
    r"""
    Evaluate a log-likelihood over a batch of parameter candidates on one
    device, one call per candidate.

    Args:
        loglik_fn (Callable): ``loglik_fn(theta)``, or ``loglik_fn(theta,
            key)`` if ``keys`` is given.
        thetas (pytree): Parameter batch with a leading axis.
        keys (sequence | None): Optional per-candidate ``rng`` (generators
            or noise tensors), indexed like the batch.
        mesh: Must be ``None`` (``ROADMAP.md`` queue 1 item 8).
        axis_name (str): The JAX package's mesh axis; unused.

    Returns:
        (Tensor): Log-likelihood values, one per candidate.
    """
    _check_mesh(mesh)
    del axis_name
    n = tree_leaves(thetas)[0].shape[0]
    args = [(_at(thetas, i),) + (() if keys is None else (keys[i],))
            for i in range(n)]
    return torch.stack([torch.as_tensor(loglik_fn(*a)) for a in args])


# --- the lockstep random walk over posterior draws --------------------------------


def run_chains_fused(loglik_fn, init_positions, generator, n_samples,
                     rw_scale, ode_weight, ode_init, t_min, t_max, n_steps,
                     prior_pars, model, position_to_init=None, noise=None,
                     device=None, interrogation="kramer"):
    r"""
    Pseudo-marginal random-walk MCMC with every chain riding the fused
    lane-batched sampler: all ``n_lane`` chains advance in lockstep, each
    step's likelihood estimate from ONE
    :func:`rodeo_tpu_torch.ops.fused_sim.solve_sim_fused_batch` call
    (kernels K1 and K6).

    Mathematically identical to :func:`run_chains` over
    :func:`rodeo_tpu_torch.inference.pseudo_marginal.normal_random_walk`
    (independent normal proposals, Metropolis accept/reject on the
    auxiliary-path likelihood estimate; the rejected-state estimate is
    kept).

    Args:
        loglik_fn (Callable): ``loglik_fn(positions, paths) -> (n_lane,)``
            log-likelihood (+ log-prior) of each lane given its sampled ODE
            path; ``positions`` is ``(n_lane, n_theta)``, ``paths`` is
            ``(n_steps+1, n_block, q, n_lane)`` (lane axis LAST).
        init_positions (Tensor(n_lane, n_theta)): Initial chain positions.
        generator (torch.Generator | None): Source of the draws.
        n_samples (int): Number of MCMC steps.
        rw_scale (Tensor(n_theta,) | float): Random-walk proposal scale.
        ode_weight, ode_init, t_min, t_max, n_steps, prior_pars, model:
            Solver configuration (see
            :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`);
            ``ode_init`` is shared across lanes unless ``position_to_init``
            is given.
        position_to_init (Callable | None): Optional
            ``position_to_init(positions) -> (n_lane, n_block, q)``.
        noise (dict | None): In place of ``generator``, as
            :func:`make_chain_runner`'s.
        device: The device; ``None`` is the CUDA card.

    Returns:
        (tuple):
        - **positions** (Tensor(n_samples, n_lane, n_theta)).
        - **logdens** (Tensor(n_lane,)): Final likelihood estimates.
        - **accept_rate** (Tensor(n_lane,)): Per-chain acceptance rate.
    """
    runner = make_chain_runner(
        loglik_fn=loglik_fn, n_lane=init_positions.shape[0],
        n_samples=n_samples, rw_scale=rw_scale, ode_weight=ode_weight,
        ode_init=ode_init, t_min=t_min, t_max=t_max, n_steps=n_steps,
        prior_pars=prior_pars, model=model,
        position_to_init=position_to_init, interrogation=interrogation,
        device=device)
    return runner(init_positions, generator, noise=noise)


def make_chain_runner(loglik_fn, n_lane, n_samples, rw_scale, ode_weight,
                      ode_init, t_min, t_max, n_steps, prior_pars, model,
                      position_to_init=None, interrogation="kramer",
                      device=None):
    r"""
    Build the lockstep random-walk runner of :func:`run_chains_fused`:
    ``runner(init_positions, generator=None, scale=None, noise=None) ->
    (positions, logdens, accept)``.  ``scale`` overrides ``rw_scale`` at
    run time.

    ``noise`` holds, with ``S = n_samples``, ``N = n_steps`` and the
    solver's ``q`` and ``n_block``: ``"init_eps" (N-1, q, n_block,
    n_lane)`` and ``"init_eps_term" (q, n_block, n_lane)``, the normals of
    the initial estimate (:func:`~rodeo_tpu_torch.ops.fused_sim.
    solve_sim_fused_batch`'s ``eps`` and ``eps_term``); then per step
    ``"prop" (S, n_lane, n_theta)``, the proposal's normals, ``"eps" (S,
    N-1, q, n_block, n_lane)`` and ``"eps_term" (S, q, n_block, n_lane)``,
    the draw's, and ``"u" (S, n_lane)``, the uniforms.  Under
    ``interrogation="chkrebtii"`` the estimates' interrogations draw too:
    ``"init_eps_int" (N, q, n_block, n_lane)`` and ``"eps_int" (S, N, q,
    n_block, n_lane)``, :func:`~rodeo_tpu_torch.ops.fused_sim.
    solve_sim_fused_batch`'s ``eps_int`` (the JAX package draws them from
    the ``key_int`` it splits off each estimate's key).
    """
    from rodeo_tpu_torch.ops.fused_sim import solve_sim_fused_batch

    device = resolve_device(device)
    chkrebtii = interrogation == "chkrebtii"
    ode_init = torch.as_tensor(ode_init, device=device)
    n_block, _, q = ode_weight.shape

    def inits_for(positions):
        if position_to_init is not None:
            return position_to_init(positions)
        return ode_init.expand((n_lane,) + ode_init.shape)

    def estimate(positions, eps_int, eps, eps_term):
        paths = solve_sim_fused_batch(
            positions, ode_weight, inits_for(positions), t_min, t_max,
            n_steps, prior_pars, model, interrogation=interrogation,
            eps=eps, eps_term=eps_term, eps_int=eps_int, device=device)
        return loglik_fn(positions, paths)

    def path_normals(generator):
        """An estimate's normals: the interrogations' (chkrebtii), then the
        path's and the terminal draw's."""
        shape = (n_steps - 1, q, n_block, n_lane)
        eps_int = _normals((n_steps,) + shape[1:], device, generator) \
            if chkrebtii else None
        return (eps_int, _normals(shape, device, generator),
                _normals(shape[1:], device, generator))

    def given(noise, prefix, i=None):
        """An estimate's normals from ``noise``: those of the initial
        estimate (``prefix`` "init_") or of step ``i`` (prefix "")."""
        keys = (prefix + "eps_int",) * chkrebtii + (prefix + "eps",
                                                    prefix + "eps_term")
        normals = tuple(noise[k] if i is None else noise[k][i] for k in keys)
        return normals if chkrebtii else (None,) + normals

    def run(init_positions, generator=None, scale=None, noise=None):
        pos = torch.as_tensor(init_positions, device=device).float()
        s = torch.as_tensor(rw_scale if scale is None else scale,
                            dtype=torch.float32, device=device)
        s = s.broadcast_to(pos.shape[-1:])
        noise = _noise_on(noise, device)
        ll = estimate(pos, *(path_normals(generator) if noise is None else
                             given(noise, "init_")))
        positions = pos.new_empty((n_samples,) + pos.shape)
        accepted = torch.empty((n_samples, n_lane), dtype=torch.bool,
                               device=device)
        for i in range(n_samples):
            if noise is None:
                z = _normals(pos.shape, device, generator)
                normals = path_normals(generator)
                u = _uniforms(n_lane, device, generator)
            else:
                z, u = noise["prop"][i], noise["u"][i]
                normals = given(noise, "", i)
            prop = pos + s * z
            ll_prop = estimate(prop, *normals)
            accept = _accept(u, ll_prop - ll)
            pos = torch.where(accept[:, None], prop, pos)
            ll = torch.where(accept, ll_prop, ll)
            positions[i] = pos
            accepted[i] = accept
        return positions, ll, accepted.float().mean(0)

    return run


# --- lockstep MALA and HMC ------------------------------------------------------


def _mala_proposal(logpost_grad_fn, eps, pos, ll, g, xi):
    """The MALA proposal of every lane, ``x' = x + (eps^2/2) grad(x) + eps
    xi``, its value and gradient, and the log acceptance ratio with the
    exact asymmetric-kernel correction."""

    def log_q(to, frm, g_frm):
        def term(t, f, gr):
            mu = f + 0.5 * eps * eps * gr
            d = ((t - mu) ** 2 / (2.0 * eps * eps)).float()
            return torch.sum(d.reshape(d.shape[0], -1), dim=-1)
        return -sum(tree_leaves(tree_map(term, to, frm, g_frm)))

    prop = tree_map(lambda p, gr, x: p + 0.5 * eps * eps * gr + eps * x,
                    pos, g, xi)
    ll_prop, g_prop = logpost_grad_fn(prop)
    log_ratio = (ll_prop - ll + log_q(pos, prop, g_prop)
                 - log_q(prop, pos, g))
    return prop, ll_prop, g_prop, log_ratio


def _hmc_proposal(logpost_grad_fn, eps, n_leapfrog, pos, ll, g, mom):
    """The HMC proposal of every lane after ``n_leapfrog`` leapfrog steps,
    its value and gradient, and the log acceptance ratio on Delta H.  The
    first half kick reuses the carried gradient; each step drifts,
    evaluates and kicks in full, and the trailing half kick undoes half of
    the last full kick."""

    def kinetic(p):
        return 0.5 * sum(tree_leaves(tree_map(
            lambda x: torch.sum((x * x).reshape(x.shape[0], -1), dim=-1),
            p)))

    p = tree_map(lambda pp, gg: pp + 0.5 * eps * gg, mom, g)
    q, ll_prop, g_prop = pos, ll, g
    for _ in range(n_leapfrog):
        q = tree_map(lambda qq, pp: qq + eps * pp, q, p)
        ll_prop, g_prop = logpost_grad_fn(q)
        p = tree_map(lambda pp, gg: pp + eps * gg, p, g_prop)
    p = tree_map(lambda pp, gg: pp - 0.5 * eps * gg, p, g_prop)
    return q, ll_prop, g_prop, ll_prop - ll + kinetic(mom) - kinetic(p)


def _metropolis(u, pos, ll, g, proposal):
    """Accept each lane's proposal ``(prop, ll_prop, g_prop, log_ratio)``
    where ``log(u) < log_ratio``; returns the next ``(pos, ll, g)`` and
    the decisions."""
    prop, ll_prop, g_prop, log_ratio = proposal
    accept = _accept(u, log_ratio)
    return (_keep(accept, prop, pos), torch.where(accept, ll_prop, ll),
            _keep(accept, g_prop, g), accept)


def _step_size(init_positions, step_size, device):
    """The step size as float32 on ``device``; over plain ``(n_lane,
    n_dim)`` positions a scalar or vector broadcasts to ``(n_dim,)``."""
    eps = torch.as_tensor(step_size, dtype=torch.float32, device=device)
    if isinstance(init_positions, torch.Tensor) \
            and init_positions.ndim == 2 and eps.ndim <= 1:
        eps = eps.broadcast_to(init_positions.shape[-1:])
    return eps


def _lockstep(logpost_grad_fn, n_lane, n_samples, step_size, propose,
              part):
    """The run of a lockstep gradient runner: ``propose(eps, pos, ll, g,
    draw)`` and the Metropolis decision once a step, on the draws ``part``
    (normals shaped like the position) and the uniforms ``"u"``."""

    def run(init_positions, generator=None, step_size_override=None,
            noise=None):
        pos = tree_map(lambda p: torch.as_tensor(p).float(), init_positions)
        device = tree_leaves(pos)[0].device
        eps = _step_size(init_positions, step_size if step_size_override
                         is None else step_size_override, device)
        noise = _noise_on(noise, device)
        ll, g = logpost_grad_fn(pos)
        positions = tree_map(lambda p: p.new_empty((n_samples,) + p.shape),
                             pos)
        accepted = torch.empty((n_samples, n_lane), dtype=torch.bool,
                               device=device)
        for i in range(n_samples):
            if noise is None:
                draw = tree_map(
                    lambda p: _normals(p.shape, p.device, generator), pos)
                u = _uniforms(n_lane, device, generator)
            else:
                draw, u = _at(noise[part], i), noise["u"][i]
            pos, ll, g, accept = _metropolis(
                u, pos, ll, g, propose(eps, pos, ll, g, draw))
            tree_map(lambda out, p: out[i].copy_(p), positions, pos)
            accepted[i] = accept
        return positions, ll, accepted.float().mean(0)

    return run


def make_mala_runner(logpost_grad_fn, n_lane, n_samples, step_size):
    r"""
    Build a lockstep MALA (Metropolis-adjusted Langevin) runner:
    ``runner(init_positions, generator=None, step_size_override=None,
    noise=None) -> (positions, logdens, accept)``.

    ONE call of ``logpost_grad_fn`` per step supplies the value and
    gradient of every chain: over a ``*_fused_batch_grad`` entry, the
    Langevin drift costs the kernel pass a likelihood evaluation would.
    Proposal ``x' = x + (eps^2/2) grad(x) + eps xi`` with the exact
    asymmetric-kernel Metropolis correction.

    Args:
        logpost_grad_fn (Callable): ``logpost_grad_fn(positions) ->
            (logdens (n_lane,), grad)`` with ``grad`` shaped like the
            (pytree) positions, e.g. a closure over
            :func:`rodeo_tpu_torch.ops.fused_fenrir.fenrir_fused_batch_grad`
            plus a log-prior.
        n_lane (int): Number of chains.
        n_samples (int): Number of MCMC steps.
        step_size (float | Tensor(n_theta,)): Langevin step size;
            ``step_size_override`` replaces it at run time.  It must
            broadcast against each leaf's trailing dimensions.

    ``noise`` holds ``"xi"``, the proposal normals (a pytree like the
    positions with the leading axis ``(n_samples,)``), and ``"u"``,
    ``(n_samples, n_lane)`` uniforms.

    Returns:
        (Callable): the runner; it returns ``positions`` (pytree, leading
        ``(n_samples,)``), the final ``logdens (n_lane,)`` and the
        per-lane acceptance rate.
    """

    def propose(eps, pos, ll, g, xi):
        return _mala_proposal(logpost_grad_fn, eps, pos, ll, g, xi)

    return _lockstep(logpost_grad_fn, n_lane, n_samples, step_size,
                     propose, "xi")


def make_hmc_runner(logpost_grad_fn, n_lane, n_samples, step_size,
                    n_leapfrog=10):
    r"""
    Build a lockstep HMC (Hamiltonian Monte Carlo) runner:
    ``runner(init_positions, generator=None, step_size_override=None,
    noise=None) -> (positions, logdens, accept)``.

    Each proposal integrates ``n_leapfrog`` leapfrog steps, ``n_leapfrog``
    calls of ``logpost_grad_fn``.  A per-dimension ``step_size`` acts as a
    diagonal mass preconditioner (leapfrog for the rescaled target ``u = q
    / eps`` with unit momenta).

    Args:
        logpost_grad_fn, n_lane, n_samples, step_size: As
            :func:`make_mala_runner`.
        n_leapfrog (int): Leapfrog steps per proposal (>= 1).

    ``noise`` holds ``"mom"``, the momenta (a pytree like the positions
    with the leading axis ``(n_samples,)``), and ``"u"``, ``(n_samples,
    n_lane)`` uniforms.
    """
    if n_leapfrog < 1:
        raise ValueError(f"n_leapfrog must be >= 1, got {n_leapfrog}")

    def propose(eps, pos, ll, g, mom):
        return _hmc_proposal(logpost_grad_fn, eps, n_leapfrog, pos, ll, g,
                             mom)

    return _lockstep(logpost_grad_fn, n_lane, n_samples, step_size,
                     propose, "mom")


def adapt_step_size(runner, init_positions, generator, init_step,
                    target_accept=0.57, n_windows=15, decay=0.75,
                    gamma=0.05, t0=10.0):
    r"""
    Dual-averaging step-size adaptation (Nesterov primal-dual as used by
    Stan/NUTS, Hoffman & Gelman 2014 §3.2) for the lockstep MALA, HMC and
    NUTS runners: runs short windows, drives the mean acceptance toward
    ``target_accept`` by adapting a log step-size multiplier, and
    warm-starts each window from the previous one's final positions.  The
    step size is a run-time argument of the runners, so nothing is
    rebuilt.  The mean acceptance of each window is read on the host.

    Args:
        runner (Callable): From :func:`make_mala_runner`,
            :func:`make_hmc_runner` or :func:`rodeo_tpu_torch.parallel.
            nuts.make_nuts_runner`; its ``n_samples`` is the window length.
        init_positions (pytree): Initial positions (leading lane axis).
        generator (torch.Generator | None): Passed to every window.
        init_step (float | Tensor): Initial step size; a per-dimension
            vector is scaled by one shared adapted multiplier.
        target_accept (float): ~0.57 for MALA, ~0.8 for HMC.
        n_windows (int): Adaptation windows.
        decay, gamma, t0: Dual-averaging constants (paper defaults).

    Returns:
        (tuple):
        - **step_size** (Tensor): Adapted step size (averaged iterate).
        - **positions** (pytree): Warmed-up positions for the main run.
        - **accept** (float): Mean acceptance of a final window run at the
          returned step size.
    """
    base = torch.as_tensor(init_step, dtype=torch.float32)
    mu = math.log(10.0)        # shrink target: 10x the initial step
    log_eps, log_eps_bar, h_bar = 0.0, 0.0, 0.0
    pos = init_positions
    for t in range(1, n_windows + 1):
        positions, _ll, acc = runner(
            pos, generator, step_size_override=base * math.exp(log_eps))
        a = float(torch.mean(acc))
        h_bar = (1.0 - 1.0 / (t + t0)) * h_bar \
            + (target_accept - a) / (t + t0)
        log_eps = mu - math.sqrt(t) / gamma * h_bar
        eta = t ** (-decay)
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        pos = tree_map(lambda p: p[-1], positions)
    eps_final = base * math.exp(log_eps_bar)
    positions, _ll, acc = runner(pos, generator,
                                 step_size_override=eps_final)
    pos = tree_map(lambda p: p[-1], positions)
    return eps_final, pos, float(torch.mean(acc))


def adapt_warmup(runner, init_positions, generator, init_step,
                 target_accept=0.8, n_windows=8, n_var_windows=3):
    r"""
    Stan-style two-phase warmup for the lockstep MALA/HMC/NUTS runners:
    dual-averaging step-size adaptation *plus* diagonal mass-matrix
    estimation.

    Phase 1 dual-averages a scalar step size at identity mass
    (:func:`adapt_step_size`).  Phase 2 samples ``n_var_windows`` windows
    at that step, estimates the per-dimension posterior standard deviation
    across (samples x lanes), and sets the per-dimension step ``eps_d
    \propto std_d`` (a per-dimension step is a diagonal mass
    preconditioner for these runners), normalised by its geometric mean;
    phase 3 re-runs dual averaging on the shared multiplier of the new base
    vector.

    Args:
        runner (Callable): As :func:`adapt_step_size`'s; positions must be
            plain ``(n_lane, n_dim)`` tensors.
        init_positions (Tensor(n_lane, n_dim)): Initial positions.
        generator (torch.Generator | None): Passed to every window.
        init_step (float): Initial scalar step size.
        target_accept (float): ~0.57 for MALA, ~0.8 for HMC/NUTS.
        n_windows (int): Dual-averaging windows per phase (phase 3 uses
            ``max(4, n_windows // 2)``).
        n_var_windows (int): Sampling windows for the variance estimate.

    Returns:
        (tuple): adapted per-dimension ``step_size (n_dim,)``, warmed-up
        ``positions``, and the final-window mean acceptance.
    """
    if getattr(init_positions, "ndim", None) != 2:
        raise ValueError(
            "adapt_warmup requires plain (n_lane, n_dim) positions; "
            "use adapt_step_size for pytree positions")
    eps1, pos, _ = adapt_step_size(
        runner, init_positions, generator, init_step,
        target_accept=target_accept, n_windows=n_windows)
    draws = []
    for _ in range(n_var_windows):
        positions, _ll, _acc = runner(pos, generator,
                                      step_size_override=eps1)
        pos = positions[-1]
        draws.append(positions)
    samples = torch.cat(draws)                       # (W*n, n_lane, d)
    std = torch.std(samples.reshape(-1, samples.shape[-1]), dim=0,
                    correction=0)
    std = torch.maximum(std, 1e-6 * torch.max(std))
    scale = std / torch.exp(torch.mean(torch.log(std)))
    base = eps1.to(scale.device) * scale
    return adapt_step_size(
        runner, pos, generator, base, target_accept=target_accept,
        n_windows=max(4, n_windows // 2))


# --- over the fused fenrir and DALTON gradients ----------------------------------


def _fused_theta_logpost_grad(likelihood, n_lane, ode_weight, ode_init,
                              t_min, t_max, n_steps, prior_pars, obs_data,
                              obs_times, obs_weight, obs_var, model,
                              logprior_grad_fn, device):
    """``logpost_grad_fn`` over the fused fenrir or DALTON value+gradient
    entry points (the MALA, HMC and NUTS wrappers')."""
    from rodeo_tpu_torch.ops.fused_dalton import dalton_fused_batch_grad
    from rodeo_tpu_torch.ops.fused_fenrir import fenrir_fused_batch_grad
    grad_fns = {"fenrir": fenrir_fused_batch_grad,
                "dalton": dalton_fused_batch_grad}
    if likelihood not in grad_fns:
        raise NotImplementedError(
            f"unknown likelihood {likelihood!r}; expected one of "
            f"{sorted(grad_fns)}")
    fused_grad = grad_fns[likelihood]
    device = resolve_device(device)
    move = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    ode_init = move(ode_init)
    inits = ode_init.expand((n_lane,) + ode_init.shape)
    ode_weight, obs_data, obs_weight, obs_var = map(
        move, (ode_weight, obs_data, obs_weight, obs_var))
    prior_pars = tuple(map(move, prior_pars))
    # the observation grid is built on the host: keep its times there
    if isinstance(obs_times, torch.Tensor):
        obs_times = obs_times.detach().cpu().numpy()

    def logpost_grad_fn(positions):
        ll, g = fused_grad(
            positions, ode_weight, inits, t_min, t_max, n_steps, prior_pars,
            obs_data, obs_times, obs_weight, obs_var, model, device=device)
        if logprior_grad_fn is not None:
            lp, gp = logprior_grad_fn(positions)
            ll, g = ll + lp, g + gp
        return ll, g

    return logpost_grad_fn


def run_chains_mala_fused(init_positions, generator, n_samples, step_size,
                          ode_weight, ode_init, t_min, t_max, n_steps,
                          prior_pars, obs_data, obs_times, obs_weight,
                          obs_var, model, logprior_grad_fn=None,
                          likelihood="fenrir", noise=None, device=None):
    r"""
    Lockstep MALA over the fenrir (kernels K11a and K11b) or DALTON (K11c)
    marginal likelihood, every chain riding ONE fused value+gradient call
    per step.

    Args:
        likelihood (str): ``"fenrir"`` or ``"dalton"``.
        logprior_grad_fn (Callable | None): Optional
            ``logprior_grad_fn(positions) -> (logp (n_lane,),
            grad (n_lane, n_theta))`` added to the likelihood (flat prior
            otherwise).
        noise (dict | None): As :func:`make_mala_runner`'s.
        device: The device; ``None`` is the CUDA card.
        (other args as :func:`run_chains_fused` and
        :func:`rodeo_tpu_torch.ops.fused_fenrir.fenrir_fused_batch_grad`)

    Returns:
        (tuple): ``positions (n_samples, n_lane, n_theta)``,
        ``logdens (n_lane,)``, ``accept_rate (n_lane,)``.
    """
    logpost_grad_fn = _fused_theta_logpost_grad(
        likelihood, init_positions.shape[0], ode_weight, ode_init, t_min,
        t_max, n_steps, prior_pars, obs_data, obs_times, obs_weight,
        obs_var, model, logprior_grad_fn, device)
    runner = make_mala_runner(logpost_grad_fn, init_positions.shape[0],
                              n_samples, step_size)
    return runner(torch.as_tensor(init_positions,
                                  device=resolve_device(device)),
                  generator, noise=noise)


def run_chains_hmc_fused(init_positions, generator, n_samples, step_size,
                         ode_weight, ode_init, t_min, t_max, n_steps,
                         prior_pars, obs_data, obs_times, obs_weight,
                         obs_var, model, logprior_grad_fn=None,
                         likelihood="fenrir", n_leapfrog=10, noise=None,
                         device=None):
    r"""
    Lockstep HMC over the fenrir or DALTON marginal likelihood: each of
    the ``n_leapfrog`` leapfrog steps per proposal is ONE fused
    value+gradient call for all chains.

    Args as :func:`run_chains_mala_fused` plus ``n_leapfrog``, ``noise``
    as :func:`make_hmc_runner`'s; returns ``(positions, logdens,
    accept_rate)``.
    """
    logpost_grad_fn = _fused_theta_logpost_grad(
        likelihood, init_positions.shape[0], ode_weight, ode_init, t_min,
        t_max, n_steps, prior_pars, obs_data, obs_times, obs_weight,
        obs_var, model, logprior_grad_fn, device)
    runner = make_hmc_runner(logpost_grad_fn, init_positions.shape[0],
                             n_samples, step_size, n_leapfrog=n_leapfrog)
    return runner(torch.as_tensor(init_positions,
                                  device=resolve_device(device)),
                  generator, noise=noise)


# --- over MAGI's path posterior ---------------------------------------------------


def _magi_logpost_grad(joint_theta, ode_expand, n_active, prior_pars, dt,
                       sig2_lanes, extra_grad_fn, device, params):
    """Path-posterior ``logpost_grad_fn`` over the MAGI forward and adjoint
    kernels (the MALA, HMC and NUTS wrappers')."""
    from rodeo_tpu_torch.ops.fused_magi import magi_fused_batch_grad

    def logpost_grad_fn(position):
        if not joint_theta:
            ld, grad = magi_fused_batch_grad(
                position, ode_expand, n_active, prior_pars, dt,
                sig2_lanes=sig2_lanes, device=device, **params)
        else:
            u, th = position
            ld, g_u, g_th = magi_fused_batch_grad(
                u, ode_expand, n_active, prior_pars, dt, theta_lanes=th,
                sig2_lanes=sig2_lanes, device=device, **params)
            grad = (g_u, g_th)
        if extra_grad_fn is not None:
            lp, gp = extra_grad_fn(position)
            ld = ld + lp
            grad = tree_map(torch.add, grad, gp)
        return ld, grad

    return logpost_grad_fn


def _magi_position(init_subsets, theta_lanes, device):
    device = resolve_device(device)
    u = torch.as_tensor(init_subsets, device=device)
    if theta_lanes is None:
        return u
    return (u, tree_map(lambda t: torch.as_tensor(t, device=device),
                        theta_lanes))


def run_chains_mala_magi(init_subsets, generator, n_samples, step_size,
                         ode_expand, n_active, prior_pars, dt,
                         theta_lanes=None, sig2_lanes=None,
                         extra_grad_fn=None, noise=None, device=None,
                         **params):
    r"""
    Lockstep MALA over the MAGI **path posterior**: the position is the
    latent path subset ``U`` itself (optionally jointly with a per-lane
    ``theta``), and every step's Langevin drift is one fused forward and
    adjoint pipeline for all chains
    (:func:`rodeo_tpu_torch.ops.fused_magi.magi_fused_batch_grad`: kernels
    K10a and K10b).

    Args:
        init_subsets (Tensor(n_lane, n_steps+1, n_block, n_sub)): Initial
            per-chain paths.
        theta_lanes (Tensor(n_lane, ...) | None): When given, theta is
            sampled jointly with the path (position ``(U, theta)``),
            entering via ``ode_expand(subset, theta=..., **params)``.
        extra_grad_fn (Callable | None): ``extra_grad_fn(position) ->
            (logp (n_lane,), grad_like_position)`` for the rest of the
            posterior (MAGI's log-density alone is only the ODE-prior
            factor).
        step_size (float): Langevin step size.
        noise (dict | None): As :func:`make_mala_runner`'s.
        device: The device; ``None`` is the CUDA card.
        (other args as :func:`rodeo_tpu_torch.ops.fused_magi.
        magi_fused_batch`)

    Returns:
        (tuple): ``positions`` (pytree like the position with a leading
        ``(n_samples,)`` axis), ``logdens (n_lane,)``,
        ``accept_rate (n_lane,)``.
    """
    logpost_grad_fn = _magi_logpost_grad(
        theta_lanes is not None, ode_expand, n_active, prior_pars, dt,
        sig2_lanes, extra_grad_fn, device, params)
    runner = make_mala_runner(logpost_grad_fn, init_subsets.shape[0],
                              n_samples, step_size)
    return runner(_magi_position(init_subsets, theta_lanes, device),
                  generator, noise=noise)


def run_chains_hmc_magi(init_subsets, generator, n_samples, step_size,
                        ode_expand, n_active, prior_pars, dt,
                        theta_lanes=None, sig2_lanes=None,
                        extra_grad_fn=None, n_leapfrog=10, noise=None,
                        device=None, **params):
    r"""
    Lockstep HMC over the MAGI **path posterior**, each leapfrog step's
    gradient from the filter's exact adjoint (kernels K10a and K10b).

    Args as :func:`run_chains_mala_magi` plus ``n_leapfrog``, ``noise`` as
    :func:`make_hmc_runner`'s; returns ``(positions, logdens,
    accept_rate)``.
    """
    logpost_grad_fn = _magi_logpost_grad(
        theta_lanes is not None, ode_expand, n_active, prior_pars, dt,
        sig2_lanes, extra_grad_fn, device, params)
    runner = make_hmc_runner(logpost_grad_fn, init_subsets.shape[0],
                             n_samples, step_size, n_leapfrog=n_leapfrog)
    return runner(_magi_position(init_subsets, theta_lanes, device),
                  generator, noise=noise)


def magi_sig2_quadform(ld_s, ld_2s, sig2_lanes, n_steps, n_block,
                       n_active):
    r"""
    Recover the per-lane :math:`(Q, D)` of the MAGI log-density's exact
    :math:`\sigma^2` dependence from two evaluations.

    Every covariance in the MAGI filter is linear in the process-noise
    multiplier, so for each lane

    .. math:: \log p(U \mid \sigma^2 = s)
        = -\tfrac{Q(U)}{2s} - \tfrac{D}{2}\log s + C(U),

    with :math:`D = n_{steps}\, n_{block}\, n_{active}` and :math:`Q \ge 0`
    the total forecast quadratic form at ``s = 1``; two evaluations at
    ``s`` and ``2s`` give :math:`Q = 4s\,[\,ld(2s) - ld(s) +
    \tfrac{D}{2}\log 2\,]`.

    Args:
        ld_s (Tensor(n_lane,)): Log-density at ``sig2_lanes``.
        ld_2s (Tensor(n_lane,)): Log-density at ``2 * sig2_lanes``.
        sig2_lanes (Tensor(n_lane,)): The base multiplier ``s``.
        n_steps, n_block, n_active (int): Grid/model dimensions.

    Returns:
        (tuple): ``Q (Tensor(n_lane,))``, ``D (float)``.
    """
    d_dim = float(n_steps * n_block * n_active)
    q = 4.0 * sig2_lanes * (ld_2s - ld_s + 0.5 * d_dim * math.log(2.0))
    return torch.clamp(q, min=0.0), d_dim


def run_chains_magi_gibbs(init_subsets, generator, n_sweeps, step_size,
                          ode_expand, n_active, prior_pars, dt, sig2_init,
                          sig2_prior_shape=2.0, sig2_prior_rate=1.0,
                          n_inner=5, extra_grad_fn=None, noise=None,
                          device=None, **params):
    r"""
    Joint MAGI inference over (path, :math:`\sigma^2`): each sweep runs
    ``n_inner`` lockstep MALA steps on the latent path ``U`` given the
    per-lane :math:`\sigma^2` (kernels K10a and K10b), then a **conjugate
    Gibbs draw**

    .. math:: \sigma^2 \mid U \sim
        \text{InvGamma}(a_0 + D/2,\; b_0 + Q(U)/2),

    with :math:`(Q, D)` from :func:`magi_sig2_quadform` (two value calls,
    K10a), and one refresh of the carried value and gradient at the new
    :math:`\sigma^2`.  The ODE-prior factor alone does not identify
    :math:`\sigma^2`, so choose a proper InvGamma prior
    (``sig2_prior_shape/rate``; mean = rate/(shape-1)).

    Args:
        init_subsets (Tensor(n_lane, n_steps+1, n_block, n_sub)).
        generator (torch.Generator | None): Source of the draws.
        sig2_init (Tensor(n_lane,) | float): Initial multipliers.
        n_inner (int): MALA steps on ``U`` per sigma^2 draw (>= 1).
        extra_grad_fn (Callable | None): As :func:`run_chains_mala_magi`'s
            (it must not depend on :math:`\sigma^2`).
        noise (dict | None): In place of ``generator``: ``"xi" (n_sweeps,
            n_inner, n_lane, n_steps+1, n_block, n_sub)`` proposal normals,
            ``"u" (n_sweeps, n_inner, n_lane)`` uniforms and ``"gamma"
            (n_sweeps, n_lane)``, standard gamma variates of shape
            ``sig2_prior_shape + D / 2`` (drawn with
            ``torch._standard_gamma``).
        device: The device; ``None`` is the CUDA card.
        (other args as :func:`run_chains_mala_magi`)

    Returns:
        (tuple):
        - **positions** (Tensor(n_sweeps, n_lane, n_steps+1, n_block,
          n_sub)): Path draw after each sweep.
        - **sig2s** (Tensor(n_sweeps, n_lane)): Sigma^2 draw per sweep.
        - **logdens** (Tensor(n_lane,)): Final log-densities.
        - **accept_rate** (Tensor(n_lane,)): MALA acceptance on ``U``.
    """
    if n_inner < 1:
        raise ValueError(f"n_inner must be >= 1, got {n_inner}")
    from rodeo_tpu_torch.ops.fused_magi import (magi_fused_batch,
                                                magi_fused_batch_grad)
    device = resolve_device(device)
    pos = torch.as_tensor(init_subsets, device=device).float()
    n_lane, n_grid, n_block = pos.shape[:3]
    n_steps = n_grid - 1

    def ld_at(u, sig2):
        return magi_fused_batch(u, ode_expand, n_active, prior_pars, dt,
                                sig2_lanes=sig2, device=device, **params)

    def logpost_grad(u, sig2):
        ld, g_u = magi_fused_batch_grad(
            u, ode_expand, n_active, prior_pars, dt, sig2_lanes=sig2,
            device=device, **params)
        if extra_grad_fn is not None:
            lp, gp = extra_grad_fn(u)
            ld, g_u = ld + lp, g_u + gp
        return ld, g_u

    eps = torch.as_tensor(step_size, dtype=torch.float32, device=device)
    d_dim = float(n_steps * n_block * n_active)
    shape = sig2_prior_shape + 0.5 * d_dim
    noise = _noise_on(noise, device)
    sig2 = torch.as_tensor(sig2_init, dtype=torch.float32,
                           device=device).broadcast_to((n_lane,))
    ll, g = logpost_grad(pos, sig2)
    positions = pos.new_empty((n_sweeps,) + pos.shape)
    sig2s = pos.new_empty((n_sweeps, n_lane))
    accepted = torch.empty((n_sweeps, n_inner, n_lane), dtype=torch.bool,
                           device=device)
    for i in range(n_sweeps):
        for k in range(n_inner):
            if noise is None:
                xi = _normals(pos.shape, device, generator)
                u = _uniforms(n_lane, device, generator)
            else:
                xi, u = noise["xi"][i, k], noise["u"][i, k]
            pos, ll, g, accepted[i, k] = _metropolis(
                u, pos, ll, g, _mala_proposal(
                    lambda p: logpost_grad(p, sig2), eps, pos, ll, g, xi))
        # the conjugate draw from the prior factor alone: the carried `ll`
        # may hold extra_grad_fn's terms
        q_lane, _ = magi_sig2_quadform(ld_at(pos, sig2),
                                       ld_at(pos, 2.0 * sig2), sig2,
                                       n_steps, n_block, n_active)
        rate = sig2_prior_rate + 0.5 * q_lane
        if noise is None:
            gam = torch._standard_gamma(
                torch.full((n_lane,), shape, dtype=torch.float32,
                           device=device), generator=generator)
        else:
            gam = noise["gamma"][i]
        sig2 = rate / gam
        # refresh the carried value and gradient at the new sigma^2
        ll, g = logpost_grad(pos, sig2)
        positions[i] = pos
        sig2s[i] = sig2
    acc = accepted.float().reshape(-1, n_lane).mean(0)
    return positions, sig2s, ll, acc
