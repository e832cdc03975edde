r"""
Lane-batched DALTON likelihood on the GPU (port of the batch path of
:mod:`rodeo_tpu.ops.pallas_dalton`: ``_dalton_prepare`` and
``dalton_fused_batch``).

DALTON's log-likelihood is the difference of two forward-filter
log-densities, :math:`\log p(Z, Y) - \log p(Z)`.  Each is one launch of
**K8** ``csrc/dalton_filter_batch.cu``, which replaces
``_dalton_filter_kernel``: K1's filter step (``csrc/filter_step.cuh``),
plus the forecast log-density of the ODE's pseudo-observation and, with
``with_obs``, a masked scalar observation update after the ODE update
(sequential processing of the independent ODE and data noises).  Only the
``(B,)`` log-density leaves the kernel.

The plain PyTorch twin of K8 is :func:`_dalton_filter_plain`; the wrapper
:func:`dalton_filter_batch` takes it only for CPU tensors.  ``LAUNCHES``
counts K8's launches.
"""
import ctypes

import torch

from rodeo_tpu_torch.ops import _build
from rodeo_tpu_torch.ops.fused_kalman import (
    _FUNCTORS, _KERNEL_Q, _LOG2PI, _MODES, _block_sum, _check, _cuda_device,
    _fused_inputs, _interrogate_update_cols, _kernel_operands,
    _masked_obs_update_cols, _pack_tri, _predict_cols, _raise_on_error,
    _tri_idx, resolve_model)
from rodeo_tpu_torch.ops.obs_grid import dense_obs_grid, obs_indices

__all__ = ["dalton_fused_batch", "dalton_filter_batch", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"dalton_filter_batch": 0}


# --- K8: forward filter summing the log-density ------------------------------------


def _dalton_filter_plain(model, n_steps, q_const, prior_var, ode_weight,
                         t_vec, x0_lanes, theta_lanes, tgrid, d, y, om, mask,
                         ld0, mode, with_obs):
    """Plain PyTorch twin of ``csrc/dalton_filter_batch.cu``: K1's twin step
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._interrogate_update_cols`),
    the forecast log-density and the masked observation update, in the
    kernel's order.  Arguments and returns as :func:`dalton_filter_batch`
    (``model`` resolved)."""
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
    for n in range(n_steps):
        mp_cols, pp_cols = _predict_cols(q, where, q_const, R_cols, m_cols,
                                         p_cols)
        m_cols, p_cols, z, S, inv_S = _interrogate_update_cols(
            model, q, pairs, where, W_cols, tv_cols, mp_cols, pp_cols,
            theta_lanes, tgrid[n], mode)
        # the ODE pseudo-observation's forecast log-density
        ld = ld - 0.5 * _block_sum(z * z * inv_S + torch.log(S) + _LOG2PI)
        if with_obs:
            D = [d[n, j][:, None] for j in range(q)]
            m_cols, p_cols, term = _masked_obs_update_cols(
                q, pairs, where, m_cols, p_cols, D, y[n][:, None],
                om[n][:, None], mask[n])
            ld = ld + mask[n] * (-0.5 * _block_sum(term))
    return ld


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
    model = resolve_model(model)
    if mode not in _MODES:
        raise NotImplementedError(
            f"fused interrogation {mode!r} is not ported; expected one of "
            f"{sorted(_MODES)}")
    q, n_block, n_lane = x0_lanes.shape
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
            ("ld0", ld0, (n_lane,))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _dalton_filter_plain(model, n_steps, q_const, prior_var,
                                    ode_weight, t_vec, x0_lanes, theta_lanes,
                                    tgrid, d, y, om, mask, ld0, mode,
                                    with_obs)
    _cuda_device(device)
    if q != _KERNEL_Q:
        raise NotImplementedError(
            f"the DALTON kernel is instantiated for q={_KERNEL_Q}, got {q}")
    lib = _build.load()
    ld = torch.empty_like(ld0)
    qc = (ctypes.c_float * (q * q))(*[v for row in q_const for v in row])
    with torch.cuda.device(device):
        err = lib.rodeo_dalton_filter_batch(
            _FUNCTORS[model.cuda_functor], _MODES[mode], int(with_obs),
            n_steps, n_lane, ctypes.addressof(qc), R_packed.data_ptr(),
            ode_weight.data_ptr(), t_vec.data_ptr(), x0_lanes.data_ptr(),
            theta_lanes.data_ptr(), tgrid.data_ptr(), d.data_ptr(),
            y.data_ptr(), om.data_ptr(), mask.data_ptr(), ld0.data_ptr(),
            ld.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _raise_on_error("dalton_filter_batch", err)
    LAUNCHES["dalton_filter_batch"] += 1
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
    :func:`rodeo_tpu_torch.ops.fused_fenrir.fenrir_fused_batch`.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device)
    ops, obs, ld0 = _dalton_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times, obs_weight, obs_var)
    ld_joint = dalton_filter_batch(fused, n_steps, **ops, **obs, ld0=ld0,
                                   mode=interrogation, with_obs=True)
    ld_marg = dalton_filter_batch(fused, n_steps, **ops, **obs,
                                  ld0=torch.zeros_like(ld0),
                                  mode=interrogation, with_obs=False)
    return ld_joint - ld_marg
