r"""
Lane-batched DALTON likelihood and its gradient on the GPU (port of the
batch path of :mod:`rodeo_tpu.ops.pallas_dalton`: ``_dalton_prepare``,
``dalton_fused_batch`` and ``dalton_fused_batch_grad``).

DALTON's log-likelihood is the difference of two forward-filter
log-densities, :math:`\log p(Z, Y) - \log p(Z)`.  Each is one launch of
**K8** ``csrc/dalton_filter_batch.cu``, which replaces
``_dalton_filter_kernel``: K1's filter step, plus the forecast log-density
of the ODE's pseudo-observation and, with ``with_obs``, a masked scalar
observation update after the ODE update (sequential processing of the
independent ODE and data noises), skipped at steps without data, where it
is an exact identity.  One thread per (lane, block), the blocks of a lane
meeting once a step in shared memory (``csrc/block_step.cuh``, as K1).
Only the ``(B,)`` log-density leaves the kernel.

The gradient runs two launches of **K11c**
``csrc/dalton_filter_batch_tan.cuh`` (replacing ``_dalton_filter_kernel_tan``):
K8 carrying the tangents of its state and log-density along each parameter
(forward mode), one thread per (lane, direction, block).  K8 and K11c hold
kramer and rodeo on the instances of K1: Lorenz63, FitzHugh-Nagumo, Hes1
and SEIRAH at q = 3, FitzHugh-Nagumo and Chkrebtii's ODE at q = 4 and 5
(``fused_kalman._INSTANCES``).

The plain PyTorch twin of K8 is :func:`_dalton_filter_plain`, and run on
:class:`~rodeo_tpu_torch.ops.dual.Dual` numbers it is K11c's
(:func:`_dalton_filter_tan_plain`); the wrappers take them only for CPU
tensors.  ``LAUNCHES`` counts the launches.
"""
import ctypes

import torch

from rodeo_tpu_torch.ops.dual import Dual, constant, rows, seed_directions
from rodeo_tpu_torch.ops.fused_kalman import (
    _LOG2PI, _block_sum, _check, _check_mode, _fused_inputs, _host_qconst,
    _interrogate_update_cols, _kernel_operands, _launch, _launch_geometry,
    _masked_obs_update_cols, _pack_tri, _predict_cols, _tri_idx,
    normalize_meas_var, resolve_kalman_type, resolve_model)
from rodeo_tpu_torch.ops.obs_grid import dense_obs_grid, obs_indices

__all__ = ["dalton_fused_batch", "dalton_fused_batch_grad",
           "dalton_filter_batch", "dalton_filter_batch_tan", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"dalton_filter_batch": 0, "dalton_filter_batch_tan": 0}


# --- K8: forward filter summing the log-density ------------------------------------


def _dalton_filter_plain(model, n_steps, q_const, prior_var, ode_weight,
                         t_vec, x0_lanes, theta_lanes, tgrid, d, y, om, mask,
                         ld0, mode, with_obs, skip_unobserved=True):
    """Plain PyTorch twin of ``csrc/dalton_filter_batch.cu``: K1's twin step
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._interrogate_update_cols`),
    the forecast log-density and the masked observation update, in the
    kernel's order.  Arguments and returns as :func:`dalton_filter_batch`
    (``model`` resolved); on Duals (``x0_lanes``, ``theta_lanes``, ``ld0``)
    it returns a Dual.

    Like K8 and K11c it skips the observation update and its term at a
    step without data, where they are an exact identity; with
    ``skip_unobserved=False`` it runs them there (a test holds the two to
    each other bitwise)."""
    q, n_block, n_lane = x0_lanes.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(prior_var, pairs)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]
    W_cols = [ode_weight[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j] for j in range(q)]
    m_cols = list(x0_lanes)
    p_cols = [torch.zeros_like(x0_lanes[0]) for _ in range(n_tri)]
    ld = ld0
    masks = mask.tolist()
    for n in range(n_steps):
        mp_cols, pp_cols = _predict_cols(q, where, q_const, R_cols, m_cols,
                                         p_cols)
        m_cols, p_cols, z, S, inv_S = _interrogate_update_cols(
            model, q, pairs, where, W_cols, tv_cols, mp_cols, pp_cols,
            theta_lanes, tgrid[n], mode)
        # the ODE pseudo-observation's forecast log-density
        ld = ld - 0.5 * _block_sum(z * z * inv_S + torch.log(S) + _LOG2PI)
        if with_obs and (masks[n] != 0.0 or not skip_unobserved):
            D = [d[n, j][:, None] for j in range(q)]
            m_cols, p_cols, term = _masked_obs_update_cols(
                q, pairs, where, m_cols, p_cols, D, y[n][:, None],
                om[n][:, None], mask[n])
            ld = ld + mask[n] * (-0.5 * _block_sum(term))
    return ld


def _dalton_filter_tan_plain(model, n_steps, q_const, prior_var, ode_weight,
                             t_vec, x0_lanes, theta_lanes, tgrid, d, y, om,
                             mask, ld0, mode, with_obs, skip_unobserved=True):
    """Plain PyTorch twin of ``csrc/dalton_filter_batch_tan.cu``: K8's twin
    on Duals, theta seeded along its ``n_theta`` basis directions, the
    initial state exact, the seed's tangents the rows ``ld0[1:]``.
    Arguments and returns as :func:`dalton_filter_batch_tan`;
    ``skip_unobserved`` as :func:`_dalton_filter_plain`."""
    theta = seed_directions(theta_lanes)
    ld = _dalton_filter_plain(model, n_steps, q_const, prior_var, ode_weight,
                              t_vec, constant(x0_lanes, theta.n_dir), theta,
                              tgrid, d, y, om, mask, Dual(ld0[0], ld0[1:]),
                              mode, with_obs, skip_unobserved)
    return rows(ld)


def dalton_filter_batch(model, n_steps, q_const, prior_var, ode_weight,
                        t_vec, x0_lanes, theta_lanes, tgrid, d, y, om, mask,
                        ld0, mode="kramer", with_obs=True):
    r"""
    Lane-batched forward filter of DALTON (kernel K8), summing the forecast
    log-density of the ODE's pseudo-observations and, with ``with_obs``,
    that of the data through a masked update after each ODE update.  All
    tensors float32, in Taylor-scaled coordinates.

    Args:
        model, n_steps, q_const, prior_var, ode_weight, t_vec, x0_lanes,
            theta_lanes, tgrid, mode: As
            :func:`rodeo_tpu_torch.ops.fused_kalman.fused_filter_batch`.
        d (Tensor(N, q, n_block)), y (Tensor(N, n_block)),
            om (Tensor(N, n_block)), mask (Tensor(N,)): The observation
            grid of steps 1..N, shared by all lanes (read only with
            ``with_obs``).
        ld0 (Tensor(B,)): The seed of the sum.
        with_obs (bool): Whether to add the observation updates.

    Returns:
        (Tensor(B,)): ``ld0`` plus the log-density of steps 1..N.
    """
    return _dalton_filter(False, model, n_steps, q_const, prior_var,
                          ode_weight, t_vec, x0_lanes, theta_lanes, tgrid, d,
                          y, om, mask, ld0, mode, with_obs)


def dalton_filter_batch_tan(model, n_steps, q_const, prior_var, ode_weight,
                            t_vec, x0_lanes, theta_lanes, tgrid, d, y, om,
                            mask, ld0, mode="kramer", with_obs=True):
    r"""
    Tangent-augmented forward filter of DALTON (kernel K11c): K8 and the
    derivative of its log-density along each of the ``n_theta`` theta
    basis directions, the initial state held fixed.  Arguments as
    :func:`dalton_filter_batch`, but ``ld0 (Tensor(n_aug, B))``, the seed
    and its tangents (``n_aug = 1 + n_theta``).

    Returns:
        (Tensor(n_aug, B)): ``ld0`` plus the log-density of steps 1..N, and
        its tangents.
    """
    return _dalton_filter(True, model, n_steps, q_const, prior_var,
                          ode_weight, t_vec, x0_lanes, theta_lanes, tgrid, d,
                          y, om, mask, ld0, mode, with_obs)


def _dalton_filter_batch_geometry(model, n_lane, mode="kramer",
                                 with_obs=True, q=3, device=None):
    """The launch of kernel K8 (:func:`dalton_filter_batch`) at ``n_lane``
    lanes on the card, for the model, mode and q of one of its instances,
    as :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports
    it."""
    return _launch_geometry("dalton_filter_batch", device, int(with_obs),
                            n_lane, q=q,
                            model=resolve_model(model).cuda_functor,
                            mode=mode)


def _dalton_filter_batch_tan_geometry(model, n_lane, mode="kramer",
                                     with_obs=True, q=3, device=None):
    """The launch of kernel K11c (:func:`dalton_filter_batch_tan`) at
    ``n_lane`` lanes on the card, for the model, mode and q of one of its
    instances, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports
    it."""
    return _launch_geometry("dalton_filter_batch_tan", device, int(with_obs),
                            n_lane, q=q,
                            model=resolve_model(model).cuda_functor,
                            mode=mode)


def _dalton_filter(tangent, model, n_steps, q_const, prior_var, ode_weight,
                   t_vec, x0_lanes, theta_lanes, tgrid, d, y, om, mask, ld0,
                   mode, with_obs):
    """K8 (``tangent`` False) or K11c: check the operands, take the twin
    for CPU tensors, else launch the kernel."""
    model = resolve_model(model)
    _check_mode(mode)
    q, n_block, n_lane = x0_lanes.shape
    kernel = "dalton_filter_batch_tan" if tangent else "dalton_filter_batch"
    pairs, _ = _tri_idx(q)
    n_tri = len(pairs)
    device = x0_lanes.device
    R_packed = _pack_tri(prior_var, pairs).contiguous()
    for name, t, shape in (
            ("prior_var", R_packed, (n_block, n_tri)),
            ("ode_weight", ode_weight, (n_block, q)),
            ("t_vec", t_vec, (q,)),
            ("x0_lanes", x0_lanes, (q, model.n_block, n_lane)),
            ("theta_lanes", theta_lanes, (model.n_theta, n_lane)),
            ("tgrid", tgrid, (n_steps,)),
            ("d", d, (n_steps, q, n_block)),
            ("y", y, (n_steps, n_block)),
            ("om", om, (n_steps, n_block)),
            ("mask", mask, (n_steps,)),
            ("ld0", ld0, (1 + model.n_theta, n_lane) if tangent
             else (n_lane,))):
        _check(name, t, shape, device)
    args = (model, n_steps, q_const, prior_var, ode_weight, t_vec, x0_lanes,
            theta_lanes, tgrid, d, y, om, mask, ld0, mode, with_obs)
    if device.type == "cpu":
        return (_dalton_filter_tan_plain if tangent
                else _dalton_filter_plain)(*args)
    ld = torch.empty_like(ld0)
    qc = _host_qconst(q_const)
    _launch(LAUNCHES, kernel, q, device, int(with_obs), n_steps, n_lane,
            ctypes.addressof(qc), R_packed, ode_weight, t_vec, x0_lanes,
            theta_lanes, tgrid, d, y, om, mask, ld0, ld,
            model=model.cuda_functor, mode=mode)
    return ld


# --- the likelihood -----------------------------------------------------------------


def _dalton_prepare(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                    prior_pars, obs_data, obs_times, obs_weight, obs_var):
    """The operands of the two K8 launches, in float32 Taylor-scaled
    coordinates on ``thetas``' device: K1's operands, the observation grid
    of steps 1..N, and the masked log-density ``ld0 (B,)`` of the data at
    t_min, computed in *original* coordinates with the original weight."""
    n_obs, _, n_bobs, q = obs_weight.shape
    if n_bobs != 1:
        raise NotImplementedError("dalton_fused_batch requires n_bobs == 1")
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    obs_weight = torch.as_tensor(obs_weight)
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times)
    d, y, om, mask = dense_obs_grid(
        obs_ind, n_steps, ops["t_vec"], torch.as_tensor(obs_data),
        obs_weight, torch.as_tensor(obs_var))
    # the t = 0 observation term log p(Y_0 | X_0), batched over lanes
    x0_orig = ode_inits.permute(1, 2, 0).to(torch.float32)     # (nb, q, B)
    D0 = obs_weight[0, :, 0, :].to(thetas.device, torch.float32)  # (nb, q)
    mean_y0 = D0[:, 0:1] * x0_orig[:, 0]
    for j in range(1, q):
        mean_y0 = mean_y0 + D0[:, j:j + 1] * x0_orig[:, j]
    z0 = y[0][:, None] - mean_y0
    om0 = om[0][:, None]
    ld0 = mask[0] * (-0.5) * _block_sum(
        z0 * z0 / om0 + torch.log(om0) + _LOG2PI)
    # the reference matches the data to step n + 1: the mask is on 1..N
    obs = dict(d=d[1:].contiguous(), y=y[1:].contiguous(),
               om=om[1:].contiguous(), mask=mask[1:].contiguous())
    return ops, obs, ld0.contiguous()


def dalton_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                       prior_pars, obs_data, obs_times, obs_weight, obs_var,
                       model, interrogation="kramer", kalman_type="standard",
                       device=None):
    r"""
    Lane-batched DALTON log-likelihood
    :math:`\log p(Y \mid Z) = \log p(Z, Y) - \log p(Z)`: two launches of
    kernel K8 on the CUDA card (its plain twin with ``device="cpu"``).

    Args and return as
    :func:`rodeo_tpu_torch.ops.fused_fenrir.fenrir_fused_batch`, under
    kramer and rodeo alone (the JAX package's DALTON takes no other).
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("dalton_filter_batch",))
    obs_var = normalize_meas_var(resolve_kalman_type(kalman_type), obs_var)
    ops, obs, ld0 = _dalton_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times, obs_weight, obs_var)
    ld_joint = dalton_filter_batch(fused, n_steps, **ops, **obs, ld0=ld0,
                                   mode=interrogation, with_obs=True)
    ld_marg = dalton_filter_batch(fused, n_steps, **ops, **obs,
                                  ld0=torch.zeros_like(ld0),
                                  mode=interrogation, with_obs=False)
    return ld_joint - ld_marg


def dalton_fused_batch_grad(thetas, ode_weight, ode_inits, t_min, t_max,
                            n_steps, prior_pars, obs_data, obs_times,
                            obs_weight, obs_var, model,
                            interrogation="kramer", kalman_type="standard",
                            device=None):
    r"""
    Lane-batched DALTON log-likelihood and its gradient in theta, forward
    mode: two launches of kernel K11c on the CUDA card (its plain twin with
    ``device="cpu"``).  ``ode_inits`` must not depend on theta: its
    tangents, and those of the seed log-density at t_min, are zero.

    Args as :func:`dalton_fused_batch`.

    Returns:
        (tuple): **loglik** ``(B,)``, equal to :func:`dalton_fused_batch`'s
        bitwise, and **grad** ``(B, n_theta)``.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("dalton_filter_batch_tan",))
    obs_var = normalize_meas_var(resolve_kalman_type(kalman_type), obs_var)
    ops, obs, ld0 = _dalton_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times, obs_weight, obs_var)
    zeros = ld0.new_zeros((fused.n_theta + 1, ld0.shape[0]))
    seed = torch.cat([ld0[None], zeros[1:]])
    ld_joint = dalton_filter_batch_tan(fused, n_steps, **ops, **obs,
                                       ld0=seed, mode=interrogation,
                                       with_obs=True)
    ld_marg = dalton_filter_batch_tan(fused, n_steps, **ops, **obs,
                                      ld0=zeros, mode=interrogation,
                                      with_obs=False)
    diff = ld_joint - ld_marg
    return diff[0], diff[1:].T.contiguous()
