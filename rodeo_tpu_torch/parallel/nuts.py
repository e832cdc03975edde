r"""
Lockstep No-U-Turn Sampler (NUTS) over the fused gradient kernels (port of
:mod:`rodeo_tpu.parallel.nuts`).

The same *lockstep* execution model as the MALA and HMC runners of
:mod:`rodeo_tpu_torch.parallel.chains`: every leapfrog step of every chain
is ONE call of ``logpost_grad_fn`` over the whole lane batch, and the
trajectory lengths adapt per lane under masks, by the **iterative**
tree-building algorithm (Phan & Pradhan 2019) made lane-parallel:

- a proposal runs at most ``max_depth`` doublings, doubling ``j`` a
  subtree of ``2**j`` leapfrog leaves for all lanes; lanes whose
  trajectory terminated ride along frozen by their ``done`` mask, and
  once every lane is done the remaining doublings are skipped (one read of
  the mask on the host per doubling);
- the U-turn checks over all balanced subtrees run iteratively against
  ``max_depth`` checkpointed momenta by the trailing-bits bookkeeping of
  the leaf index;
- the next sample is drawn by progressive multinomial sampling along the
  trajectory, with Betancourt's biased merge between doublings.

U-turn criterion: :math:`\langle r_{end}, \rho - (r_l + r_r)/2 \rangle
\le 0` at either trajectory end (rho = summed momenta).  A per-dimension
``step_size`` acts as a diagonal mass preconditioner.  Positions may be any
pytree with a leading lane axis; internally everything runs on one
flattened ``(n_lane, D)`` float32 matrix.

**Noise.** Each proposal takes its draws up front, whether or not its
doublings run: momenta ``(n_lane, D)``, a direction and a merge uniform per
doubling, and a uniform per leaf for all ``2**max_depth - 1`` leaves
(doubling ``j``'s leaves are rows ``2**j - 1 .. 2**(j+1) - 2``).  The
runner's ``noise=`` holds them for a whole run:

- ``"mom" (n_samples, n_lane, D)`` standard normals;
- ``"forward" (n_samples, max_depth, n_lane)`` bool, True where the
  doubling extends the trajectory forward in time (the JAX package's
  ``jax.random.bernoulli(k_dir, shape=(n_lane,))``);
- ``"u_merge" (n_samples, max_depth, n_lane)`` uniforms;
- ``"u_leaf" (n_samples, 2**max_depth - 1, n_lane)`` uniforms.

With a generator they are drawn in that order for each proposal.
"""
import math

import torch

from rodeo_tpu_torch.device import resolve_device
from rodeo_tpu_torch.parallel.chains import (_fused_theta_logpost_grad,
                                             _magi_logpost_grad,
                                             _magi_position, _noise_on)
from rodeo_tpu_torch.pytree import tree_flatten, tree_unflatten

__all__ = ["make_nuts_runner", "run_chains_nuts_fused",
           "run_chains_nuts_magi"]

_DIVERGENCE = 1000.0          # |delta energy| beyond this = divergent leaf


def _flatten_positions(positions):
    """Flatten a pytree with leading lane axis to ``(n_lane, D)`` float32;
    return (flat, unflatten)."""
    leaves, spec = tree_flatten(positions)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    n_lane = leaves[0].shape[0]
    shapes = [leaf.shape[1:] for leaf in leaves]
    sizes = [int(math.prod(s)) for s in shapes]
    flat = torch.cat([leaf.reshape(n_lane, -1).float() for leaf in leaves],
                     dim=1)

    def unflatten(z):
        out, off = [], 0
        for s, sz in zip(shapes, sizes):
            out.append(z[..., off:off + sz].reshape(z.shape[:-1] + s))
            off += sz
        return tree_unflatten(spec, out)

    return flat, unflatten


def _is_turning(r_a, r_b, rho):
    """Generalized U-turn test between span ends ``r_a``/``r_b`` with
    span momentum sum ``rho``, all ``(n_lane, D)``."""
    centered = rho - 0.5 * (r_a + r_b)
    t_a = torch.sum(r_a * centered, dim=-1) <= 0.0
    t_b = torch.sum(r_b * centered, dim=-1) <= 0.0
    return t_a | t_b


def _popcount(n):
    return bin(n).count("1")


def _sel(mask, a, b):
    """Per lane: ``a`` where ``mask``, else ``b``."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def _leapfrog(flat_grad_fn, z, r, g, h):
    r1 = r + 0.5 * h * g
    z1 = z + h * r1
    ll1, g1 = flat_grad_fn(z1)
    r1 = r1 + 0.5 * h * g1
    return z1, r1, ll1, g1


def _doubling(flat_grad_fn, eps, max_depth, j, H0, state, forward,
              u_merge, u_leaf):
    """Doubling ``j`` of one proposal for every lane: a subtree of ``2**j``
    leaves from the trajectory's end in each lane's direction, merged into
    the trajectory where it neither turned nor diverged."""
    ends, r_sum, prop, log_w, done, acc_sum, acc_cnt = state
    n_lane, D = r_sum.shape
    direction = torch.where(forward, 1.0, -1.0)
    fwd = direction > 0
    h = (direction[:, None] * eps[None, :]).float()
    edge = (_sel(fwd, ends["zr"], ends["zl"]),
            _sel(fwd, ends["rr"], ends["rl"]),
            _sel(fwd, ends["gr"], ends["gl"]))
    z_e, r_e, g_e = edge
    sub_r_sum = torch.zeros_like(r_sum)
    sub_log_w = torch.full((n_lane,), -math.inf, dtype=torch.float32,
                           device=r_sum.device)
    sub_prop = (edge[0], torch.zeros_like(prop[1]),
                torch.zeros_like(prop[2]))
    turning = torch.zeros_like(done)
    diverged = torch.zeros_like(done)
    ckpt_r = r_sum.new_zeros((max_depth, n_lane, D))
    ckpt_rs = r_sum.new_zeros((max_depth, n_lane, D))
    for n in range(1 << j):
        active = ~(done | turning | diverged)
        z1, r1, ll1, g1 = _leapfrog(flat_grad_fn, z_e, r_e, g_e, h)
        lw = torch.nan_to_num(
            ll1 - 0.5 * torch.sum(r1 * r1, dim=-1) - H0,
            nan=-math.inf, posinf=-math.inf, neginf=-math.inf)
        div_n = active & (lw < -_DIVERGENCE)
        # accept statistic (the dual-averaging control signal)
        acc_sum = acc_sum + torch.where(
            active, torch.exp(torch.clamp(lw, max=0.0)), 0.0)
        acc_cnt = acc_cnt + active.float()
        # streaming multinomial over the subtree's leaves
        new_log_w = torch.logaddexp(sub_log_w, lw)
        take_p = torch.exp(lw - torch.where(torch.isfinite(new_log_w),
                                            new_log_w, 0.0))
        take = active & (u_leaf[n] < take_p)
        sub_prop = (_sel(take, z1, sub_prop[0]),
                    torch.where(take, ll1, sub_prop[1]),
                    _sel(take, g1, sub_prop[2]))
        sub_r_sum = sub_r_sum + _sel(active, r1, torch.zeros_like(r1))
        # balanced-subtree U-turn bookkeeping (trailing-bit trick): even
        # leaves open spans -> checkpoint (r, running sum); odd leaves
        # close spans -> check against each open checkpoint
        idx_max = _popcount(n >> 1)
        n_close = _popcount(n & ~(n + 1))
        idx_min = idx_max - n_close + 1
        if n % 2 == 0:
            ckpt_r[idx_max] = _sel(active, r1, ckpt_r[idx_max])
            ckpt_rs[idx_max] = _sel(active, sub_r_sum, ckpt_rs[idx_max])
        else:
            for i in range(idx_min, idx_max + 1):
                span_sum = sub_r_sum - ckpt_rs[i] + ckpt_r[i]
                t_i = _is_turning(ckpt_r[i], r1, span_sum)
                turning = turning | (active & t_i)
        z_e, r_e, g_e = (_sel(active, z1, z_e), _sel(active, r1, r_e),
                         _sel(active, g1, g_e))
        sub_log_w = torch.where(active, new_log_w, sub_log_w)
        diverged = diverged | div_n

    # merge the completed subtree into the trajectory
    ok = ~(done | turning | diverged)
    p_merge = torch.exp(torch.clamp(sub_log_w - log_w, max=0.0))
    take = ok & (u_merge < p_merge)
    prop = (_sel(take, sub_prop[0], prop[0]),
            torch.where(take, sub_prop[1], prop[1]),
            _sel(take, sub_prop[2], prop[2]))
    log_w = torch.where(ok, torch.logaddexp(log_w, sub_log_w), log_w)
    r_sum = torch.where(ok[:, None], r_sum + sub_r_sum, r_sum)
    right, left = ok & fwd, ok & ~fwd
    ends = dict(zr=_sel(right, z_e, ends["zr"]),
                rr=_sel(right, r_e, ends["rr"]),
                gr=_sel(right, g_e, ends["gr"]),
                zl=_sel(left, z_e, ends["zl"]),
                rl=_sel(left, r_e, ends["rl"]),
                gl=_sel(left, g_e, ends["gl"]))
    turn_traj = _is_turning(ends["rl"], ends["rr"], r_sum)
    done = done | turning | diverged | (ok & turn_traj)
    return ends, r_sum, prop, log_w, done, acc_sum, acc_cnt


def _nuts_step(flat_grad_fn, eps, max_depth, z0, ll0, g0, draws):
    """One NUTS proposal of every lane on its draws; returns the next
    ``(z, ll, g)`` and the per-lane mean acceptance statistic."""
    r0 = draws["mom"]
    n_lane = r0.shape[0]
    H0 = ll0 - 0.5 * torch.sum(r0 * r0, dim=-1)
    zeros = torch.zeros((n_lane,), dtype=torch.float32, device=r0.device)
    state = (dict(zl=z0, rl=r0, gl=g0, zr=z0, rr=r0, gr=g0), r0,
             (z0, ll0, g0), zeros, torch.zeros_like(zeros, dtype=torch.bool),
             zeros, zeros)
    for j in range(max_depth):
        # once every lane has terminated, the remaining (largest)
        # doublings are skipped: one read of the mask a doubling
        if j > 0 and bool(torch.all(state[4])):
            break
        leaves = slice((1 << j) - 1, (1 << (j + 1)) - 1)
        state = _doubling(flat_grad_fn, eps, max_depth, j, H0, state,
                          draws["forward"][j], draws["u_merge"][j],
                          draws["u_leaf"][leaves])
    _, _, prop, _, _, acc_sum, acc_cnt = state
    return prop, acc_sum / torch.clamp(acc_cnt, min=1.0)


def make_nuts_runner(logpost_grad_fn, n_lane, n_samples, step_size,
                     max_depth=6):
    r"""
    Build a lockstep NUTS runner: ``runner(init_positions, generator=None,
    step_size_override=None, noise=None) -> (positions, logdens,
    accept)``.

    Args:
        logpost_grad_fn (Callable): ``positions -> (logdens (n_lane,),
            grad)`` with ``grad`` shaped like the (pytree) positions, e.g.
            a closure over the fused ``*_fused_batch_grad`` entry points.
        n_lane (int): Number of chains (lanes).
        n_samples (int): NUTS proposals per run; each costs at most
            ``2**max_depth - 1`` calls of ``logpost_grad_fn``.
        step_size (float | Tensor(D,)): Leapfrog step size, scalar or one
            per dimension of the flattened position; ``step_size_override``
            replaces it at run time (e.g. from
            :func:`rodeo_tpu_torch.parallel.chains.adapt_step_size`,
            ``target_accept~0.8``).
        max_depth (int): Maximum tree depth (>= 1).

    ``noise`` holds the draws of the module's docstring.

    Returns:
        (Callable): the runner; it returns ``positions (n_samples,
        n_lane, ...)`` (pytree like the input positions, float32), the
        final ``logdens (n_lane,)``, and the per-lane mean acceptance
        statistic (the dual-averaging control signal, target ~0.8).
    """
    if max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {max_depth}")
    n_leaf = (1 << max_depth) - 1

    def run(init_positions, generator=None, step_size_override=None,
            noise=None):
        flat0, unflatten = _flatten_positions(init_positions)
        device = flat0.device
        D = flat0.shape[1]
        eps = torch.as_tensor(
            step_size if step_size_override is None else step_size_override,
            dtype=torch.float32, device=device)
        if eps.ndim == 0:
            eps = eps.expand(D)
        elif eps.shape != (D,):
            raise ValueError(
                f"step_size must be scalar or shape ({D},) for the "
                f"flattened position space; got {tuple(eps.shape)}")

        def flat_grad_fn(z):
            ll, g = logpost_grad_fn(unflatten(z))
            gflat, _ = _flatten_positions(g)
            return ll.float(), gflat

        def draw():
            u = lambda *shape: torch.rand(  # noqa: E731
                shape, generator=generator, dtype=torch.float32,
                device=device)
            mom = torch.randn((n_lane, D), generator=generator,
                              dtype=torch.float32, device=device)
            return dict(mom=mom, forward=u(max_depth, n_lane) < 0.5,
                        u_merge=u(max_depth, n_lane),
                        u_leaf=u(n_leaf, n_lane))

        noise = _noise_on(noise, device)
        z, (ll, g) = flat0, flat_grad_fn(flat0)
        zs = flat0.new_empty((n_samples,) + flat0.shape)
        accs = flat0.new_empty((n_samples, n_lane))
        for i in range(n_samples):
            draws = draw() if noise is None else \
                {k: v[i] for k, v in noise.items()}
            (z, ll, g), accs[i] = _nuts_step(flat_grad_fn, eps, max_depth,
                                             z, ll, g, draws)
            zs[i] = z
        return unflatten(zs), ll, torch.mean(accs, dim=0)

    return run


def run_chains_nuts_fused(init_positions, generator, n_samples, step_size,
                          ode_weight, ode_init, t_min, t_max, n_steps,
                          prior_pars, obs_data, obs_times, obs_weight,
                          obs_var, model, logprior_grad_fn=None,
                          likelihood="fenrir", max_depth=6, noise=None,
                          device=None):
    r"""
    Lockstep NUTS over the fenrir (kernels K11a and K11b) or DALTON (K11c)
    marginal likelihood: every leapfrog leaf of every chain is ONE fused
    value+gradient call.

    Args as :func:`rodeo_tpu_torch.parallel.chains.run_chains_hmc_fused`
    plus ``max_depth``; ``noise`` as :func:`make_nuts_runner`'s.

    Returns:
        (tuple): ``positions (n_samples, n_lane, n_theta)``,
        ``logdens (n_lane,)``, per-lane mean acceptance statistic.
    """
    logpost_grad_fn = _fused_theta_logpost_grad(
        likelihood, init_positions.shape[0], ode_weight, ode_init, t_min,
        t_max, n_steps, prior_pars, obs_data, obs_times, obs_weight,
        obs_var, model, logprior_grad_fn, device)
    runner = make_nuts_runner(logpost_grad_fn, init_positions.shape[0],
                              n_samples, step_size, max_depth=max_depth)
    return runner(torch.as_tensor(init_positions,
                                  device=resolve_device(device)),
                  generator, noise=noise)


def run_chains_nuts_magi(init_subsets, generator, n_samples, step_size,
                         ode_expand, n_active, prior_pars, dt,
                         theta_lanes=None, sig2_lanes=None,
                         extra_grad_fn=None, max_depth=6, noise=None,
                         device=None, **params):
    r"""
    Lockstep NUTS over the MAGI **path posterior** (optionally jointly with
    a per-lane ``theta``), each leapfrog leaf one forward and adjoint
    pipeline (kernels K10a and K10b).

    Args as :func:`rodeo_tpu_torch.parallel.chains.run_chains_mala_magi`
    plus ``max_depth``; ``noise`` as :func:`make_nuts_runner`'s; returns
    ``(positions, logdens, accept)``.
    """
    logpost_grad_fn = _magi_logpost_grad(
        theta_lanes is not None, ode_expand, n_active, prior_pars, dt,
        sig2_lanes, extra_grad_fn, device, params)
    runner = make_nuts_runner(logpost_grad_fn, init_subsets.shape[0],
                              n_samples, step_size, max_depth=max_depth)
    return runner(_magi_position(init_subsets, theta_lanes, device),
                  generator, noise=noise)
