r"""
Lane-batched non-Gaussian DALTON likelihood and its gradient on the GPU
(port of :mod:`rodeo_tpu.ops.pallas_daltonng`: ``daltonng_fused_batch`` and
``daltonng_fused_batch_grad``).

The log-likelihood ``logy_x + logx_z - logx_yhat`` of
:func:`rodeo_tpu_torch.inference.daltonng` comes from two forward filters
and the smoothing passes over their moments, in Taylor-scaled coordinates
(the change-of-variables Jacobians of ``logx_z`` and ``logx_yhat``
cancel):

- **K9** ``csrc/filter_nn_batch.cuh`` replaces ``_filter_nn_kernel_batch``:
  the Laplace-linearised filter, K1's predict and ODE update followed, at a
  step with data, by masked pseudo-observation updates of the observed
  components, storing the filtered and predicted moments of every step;
  split over the blocks of a lane as K1 is, one thread per lane and
  block; its C entry points are ``csrc/filter_nn_batch.cu``, its instances
  compiled one translation unit per (model, q),
  ``csrc/filter_nn_instances_*.cu``;
- the backward kernels ``(G, b, C)`` of those moments in batched torch
  (:func:`_cond_params_cols`), and the smoothed means through **K2r**
  (:func:`~rodeo_tpu_torch.ops.fused_kalman.smoother_recursion_batch_rows`
  at unit scales, whose mean rows are the JAX package's ``[m0, means,
  mN]``; its covariance rows are not needed);
- the marginal ODE filter, **K1** with ``emit="gains"``, whose gains are
  the backward kernels of ``logx_z``;
- the log-densities in batched torch: ``logx_yhat`` is a sum of masked
  log-determinants (its quadratic form vanishes at the smoothed mean),
  ``logx_z`` a masked log-density of the smoothed path, both through the
  masked eigendecomposition :func:`_masked_eigh` (closed form at q <= 3,
  ``torch.linalg.eigh`` at q = 4 and 5, as the JAX package takes
  ``jnp.linalg.eigh`` there), and ``logy_x`` the observation model at the
  smoothed means of the observed steps.

The gradient, forward mode, runs **K11d** ``csrc/filter_nn_batch_tan.cuh``
(replacing ``_filter_nn_kernel_batch_tan``: K9's step on Dual numbers,
split over the blocks of a lane, one thread per lane, direction and block;
instances ``csrc/filter_nn_tan_instances_*.cu``)
for the Laplace filter and **K11a** with ``emit="gains"`` for the marginal
one, the mean recursion **K11e** over the augmented ``(G, b)``, and
``torch.func.jvp`` of the torch stages along each parameter, the masked
log-densities with their analytic tangents (:class:`_LogdetPacked`,
:class:`_LogpdfPacked`).  Its values are the value call's, bitwise.

The plain PyTorch twin of K9 is :func:`_filter_nn_batch_plain`, and run on
:class:`~rodeo_tpu_torch.ops.dual.Dual` numbers it is K11d's
(:func:`_filter_nn_batch_tan_plain`); the wrappers take them only for CPU
tensors.  ``LAUNCHES`` counts the launches.

The observation model is one of :mod:`rodeo_tpu_torch.models.obs`
(``obs_model=``), each with a compiled CUDA functor, as the ODE is named by
``model=``: the JAX package's user callables (``obs_comp_flat``,
``ode_flat``) cannot reach the kernels until user functors compile.  K9
and K11d hold K1's (model, q) under kramer and rodeo, each with both
observation functors: the first-order models at q = 3, FitzHugh-Nagumo
also at q = 4 and 5, and Chkrebtii's second-order ODE at q = 4 and 5
(``fused_kalman._INSTANCES``).
"""
import ctypes

import torch

from rodeo_tpu_torch.models.obs import ObsModel
from rodeo_tpu_torch.ops.dual import (Dual, Jet2, constant, primal,
                                      seed_directions)
from rodeo_tpu_torch.ops.dual import stack as dual_stack
from rodeo_tpu_torch.ops.fused_kalman import (
    _LOG2PI, _check, _check_mode, _fused_inputs, _gain_cols_batched,
    _host_qconst, _interrogate_update_cols, _kernel_operands, _launch,
    _launch_geometry, _pack_tri, _predict_cols, _sym_quadform, _tri_idx,
    fused_filter_batch, fused_filter_batch_tan, resolve_model,
    smoother_mean_recursion_batch_tan, smoother_recursion_batch_rows,
    unpack_cov)
from rodeo_tpu_torch.ops.linalg import (_eigh, full_matmul_precision,
                                        sym_eigh_small)
from rodeo_tpu_torch.ops.obs_grid import obs_indices

__all__ = ["daltonng_fused_batch", "daltonng_fused_batch_grad",
           "filter_nn_batch", "filter_nn_batch_tan", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"filter_nn_batch": 0, "filter_nn_batch_tan": 0}

# observation functors, numbered as the C entry point rodeo_filter_nn_batch
# (csrc/filter_nn_batch.cu) numbers them (kNumber of csrc/obs_models.cuh),
# and their parameter slots
_OBS_FUNCTORS = {"Gauss": 0, "Poisson": 1}
_OBS_PARS = 2

# Matrices per torch.linalg.eigh call at q = 4 and 5 (_eigh_finite): on the
# H100 cuSOLVER's batched eigensolver refuses 32 768 float32 4 x 4 or 5 x 5
# matrices a call (CUSOLVER_STATUS_INVALID_VALUE from its workspace query)
# and takes 16 384 fastest of 1024, 8192 and 16 384, at 41 and 35 million
# matrices a second with 4.4 GB of workspace (tools/torch_eigh_costs.py)
_EIGH_CHUNK = 16384

# time rows per pass of the log-density stage: bounds its temporaries (a
# (rows, n_block, B, 3, 3) float32 tensor is 885 MB at 4000 x 3 x 2048)
_ROW_CHUNK = 1024


def resolve_obs_model(obs_model):
    """Check that ``obs_model`` is an :class:`~rodeo_tpu_torch.models.obs.
    ObsModel` with a CUDA functor."""
    if not isinstance(obs_model, ObsModel) or \
            obs_model.cuda_functor not in _OBS_FUNCTORS:
        raise NotImplementedError(
            f"obs_model must be an ObsModel of rodeo_tpu_torch.models.obs "
            f"with a CUDA functor ({sorted(_OBS_FUNCTORS)}); got "
            f"{obs_model!r}")
    return obs_model


def _obs_bits(obs_dims, q):
    """``obs_dims`` as the kernels' bit mask (bit ``j`` for component
    ``j``); the components are updated in ascending order."""
    dims = sorted(set(int(j) for j in obs_dims))
    if not dims or dims[0] < 0 or dims[-1] >= q:
        raise ValueError(f"obs_dims must name components in 0..{q - 1}, "
                         f"got {obs_dims!r}")
    return sum(1 << j for j in dims)


# --- K9: the Laplace-linearised filter ----------------------------------------


def _laplace_update_cols(obs, q, pairs, where, tv_cols, j, x, y_col, iobs,
                         mask, theta, m_cols, p_cols):
    """The masked Laplace pseudo-observation update of component ``j`` of
    every block in column arithmetic (``laplace_update`` of
    ``csrc/filter_step.cuh``): the observation model's gradient ``g`` and
    Hessian ``h`` at ``x`` (the predicted component, original coordinates)
    from a :class:`Jet2`, ``vhat = -1 / h``, ``zo = (x + vhat g) - tv_j
    m_j``, ``So = vhat + tv_j P_jj tv_j``, ``K = P D' (mask / So)``, the
    mean ``m + K zo`` and the Joseph form ``(I - K D) P (I - K D)' + K K'
    vhat`` with ``D = tv_j e_j``."""
    ones = torch.ones_like(primal(x))
    ll = obs.comp_flat([y_col], Jet2(x, ones, torch.zeros_like(ones)), j,
                       theta, iobs)
    g, h = ll.d1, ll.d2
    vhat = -1.0 / h
    zo = (x + vhat * g) - tv_cols[j] * m_cols[j]
    PD = [p_cols[where[(i, j)]] * tv_cols[j] for i in range(q)]
    So = vhat + tv_cols[j] * PD[j]
    ratio = mask / So
    K = [PD[i] * ratio for i in range(q)]
    m_out = [m_cols[i] + K[i] * zo for i in range(q)]
    IKD = [[(1.0 if i == l else 0.0) - (K[i] * tv_cols[j] if l == j else 0.0)
            for l in range(q)] for i in range(q)]
    pj = _sym_quadform(q, IKD, p_cols, where)
    p_out = [pj[k] + K[i] * K[l] * vhat for k, (i, l) in enumerate(pairs)]
    return m_out, p_out


def _filter_nn_batch_plain(model, obs, obs_dims, n_steps, q_const, prior_var,
                           ode_weight, t_vec, x0_lanes, theta_lanes, tgrid, y,
                           iobs, mask, mode, skip_unobserved=True):
    """Plain PyTorch twin of ``csrc/filter_nn_batch.cuh``: K1's twin step
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._interrogate_update_cols`),
    then at a step with data :func:`_laplace_update_cols` of each observed
    component, in the kernel's order.  Arguments and returns as
    :func:`filter_nn_batch` (``model``, ``obs`` resolved).  With
    ``x0_lanes`` and ``theta_lanes`` as Duals it is the twin of K11d and
    returns its augmented outputs.

    Like the kernel it skips the pseudo-observation update at a step
    without data, where it is an exact identity; ``skip_unobserved=False``
    runs it there too, as the JAX package's kernel does (a test holds the
    two to each other bitwise)."""
    q, n_block, n_lane = x0_lanes.shape
    pairs, where = _tri_idx(q)
    n_tri = len(pairs)
    R_packed = _pack_tri(prior_var, pairs)
    R_cols = [R_packed[:, k:k + 1] for k in range(n_tri)]
    W_cols = [ode_weight[:, j:j + 1] for j in range(q)]
    tv_cols = [t_vec[j] for j in range(q)]
    dims = [j for j in range(q) if _obs_bits(obs_dims, q) >> j & 1]
    masks, iobs_list = mask.tolist(), iobs.tolist()
    n_aug = 1 + theta_lanes.n_dir if isinstance(theta_lanes, Dual) else 1
    new = primal(x0_lanes).new_empty
    mf = new((n_steps, n_aug * q, n_block, n_lane))
    pf = new((n_steps, n_aug * n_tri, n_block, n_lane))
    mp = new((n_steps, n_aug * q, n_block, n_lane))
    pp = new((n_steps, n_aug * n_tri, n_block, n_lane))
    m_cols = list(x0_lanes)
    p_cols = [torch.zeros_like(x0_lanes[0]) for _ in range(n_tri)]
    for n in range(n_steps):
        mp_cols, pp_cols = _predict_cols(q, where, q_const, R_cols, m_cols,
                                         p_cols)
        m_cols, p_cols, _, _, _ = _interrogate_update_cols(
            model, q, pairs, where, W_cols, tv_cols, mp_cols, pp_cols,
            theta_lanes, tgrid[n], mode)
        if masks[n] != 0.0 or not skip_unobserved:
            for j in dims:
                m_cols, p_cols = _laplace_update_cols(
                    obs, q, pairs, where, tv_cols, j,
                    mp_cols[j] * tv_cols[j], y[n][:, None], iobs_list[n],
                    masks[n], theta_lanes, m_cols, p_cols)
        mf[n] = dual_stack(m_cols)
        pf[n] = dual_stack(p_cols)
        mp[n] = dual_stack(mp_cols)
        pp[n] = dual_stack(pp_cols)
    return mf, pf, mp, pp


def _filter_nn_batch_tan_plain(model, obs, obs_dims, n_steps, q_const,
                               prior_var, ode_weight, t_vec, x0_lanes,
                               theta_lanes, tgrid, y, iobs, mask, mode,
                               skip_unobserved=True):
    """Plain PyTorch twin of ``csrc/filter_nn_batch_tan.cuh``: K9's twin on
    Duals, theta seeded along its ``n_theta`` basis directions and the
    initial state exact.  Arguments as :func:`filter_nn_batch`; returns as
    :func:`filter_nn_batch_tan`."""
    theta = seed_directions(theta_lanes)
    return _filter_nn_batch_plain(model, obs, obs_dims, n_steps, q_const,
                                  prior_var, ode_weight, t_vec,
                                  constant(x0_lanes, theta.n_dir), theta,
                                  tgrid, y, iobs, mask, mode,
                                  skip_unobserved)


def filter_nn_batch(model, obs_model, obs_dims, n_steps, q_const, prior_var,
                    ode_weight, t_vec, x0_lanes, theta_lanes, tgrid, y, iobs,
                    mask, mode="kramer"):
    r"""
    Lane-batched Laplace-linearised forward filter of non-Gaussian DALTON
    (kernel K9).  All tensors float32, in Taylor-scaled coordinates.

    Args:
        model, n_steps, q_const, prior_var, ode_weight, t_vec, x0_lanes,
            theta_lanes, tgrid, mode: As
            :func:`rodeo_tpu_torch.ops.fused_kalman.fused_filter_batch`.
        obs_model (ObsModel): The observation model
            (:mod:`rodeo_tpu_torch.models.obs`).
        obs_dims (tuple of int): The state components it observes.
        y (Tensor(N, n_block)), iobs (Tensor(N,)), mask (Tensor(N,)): The
            data of steps 1..N, the index of the observation at each step
            and 1.0 where a step has data; shared by all lanes.

    Returns:
        (tuple): The filtered means ``mf (N, q, n_block, B)`` and packed
        covariances ``pf (N, n_tri, n_block, B)``, and the predicted ones
        ``mp`` and ``pp``, of steps 1..N.
    """
    return _filter_nn(False, model, obs_model, obs_dims, n_steps, q_const,
                      prior_var, ode_weight, t_vec, x0_lanes, theta_lanes,
                      tgrid, y, iobs, mask, mode)


def filter_nn_batch_tan(model, obs_model, obs_dims, n_steps, q_const,
                        prior_var, ode_weight, t_vec, x0_lanes, theta_lanes,
                        tgrid, y, iobs, mask, mode="kramer"):
    r"""
    Tangent-augmented Laplace-linearised filter (kernel K11d): K9 and the
    derivative of everything it stores along each of the ``n_theta`` theta
    basis directions, the initial state held fixed.  Arguments as
    :func:`filter_nn_batch`.

    Returns:
        (tuple): As :func:`filter_nn_batch`, each output with its tangents
        stacked on the ``d`` axis (``n_aug = 1 + n_theta``): ``mf (N,
        n_aug*q, n_block, B)``, ``pf (N, n_aug*n_tri, ...)``, ``mp``,
        ``pp``; entries ``0..K-1`` of an output of ``K`` entries are the
        values, entries ``(1+k)K ..`` the tangents along direction ``k``.
    """
    return _filter_nn(True, model, obs_model, obs_dims, n_steps, q_const,
                      prior_var, ode_weight, t_vec, x0_lanes, theta_lanes,
                      tgrid, y, iobs, mask, mode)


def _filter_nn_geometry(kernel, model, obs_model, n_lane, mode, q, device):
    obs = resolve_obs_model(obs_model)
    return _launch_geometry(kernel, device, n_lane, q=q,
                            model=resolve_model(model).cuda_functor,
                            mode=mode, obs=_OBS_FUNCTORS[obs.cuda_functor])


def _filter_nn_batch_geometry(model, obs_model, n_lane, mode="kramer", q=3,
                              device=None):
    """The launch of kernel K9 (:func:`filter_nn_batch`) at ``n_lane`` lanes
    on the card, for the model, mode and q of one of its instances, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports
    it."""
    return _filter_nn_geometry("filter_nn_batch", model, obs_model, n_lane,
                               mode, q, device)


def _filter_nn_batch_tan_geometry(model, obs_model, n_lane, mode="kramer",
                                  q=3, device=None):
    """The launch of kernel K11d (:func:`filter_nn_batch_tan`) at ``n_lane``
    lanes on the card, for the model, mode and q of one of its instances,
    as :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports
    it."""
    return _filter_nn_geometry("filter_nn_batch_tan", model, obs_model,
                               n_lane, mode, q, device)


def _filter_nn(tangent, model, obs_model, obs_dims, n_steps, q_const,
               prior_var, ode_weight, t_vec, x0_lanes, theta_lanes, tgrid, y,
               iobs, mask, mode):
    """K9 (``tangent`` False) or K11d: check the operands, take the twin
    for CPU tensors, else launch the kernel."""
    model = resolve_model(model)
    obs = resolve_obs_model(obs_model)
    _check_mode(mode)
    q, n_block, n_lane = x0_lanes.shape
    kernel = "filter_nn_batch_tan" if tangent else "filter_nn_batch"
    bits = _obs_bits(obs_dims, q)
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
            ("y", y, (n_steps, n_block)),
            ("iobs", iobs, (n_steps,)),
            ("mask", mask, (n_steps,))):
        _check(name, t, shape, device)
    args = (model, obs, obs_dims, n_steps, q_const, prior_var, ode_weight,
            t_vec, x0_lanes, theta_lanes, tgrid, y, iobs, mask, mode)
    if device.type == "cpu":
        return (_filter_nn_batch_tan_plain if tangent
                else _filter_nn_batch_plain)(*args)
    n_aug = 1 + model.n_theta if tangent else 1
    outs = [x0_lanes.new_empty((n_steps, n_aug * d, n_block, n_lane))
            for d in (q, n_tri, q, n_tri)]
    qc = _host_qconst(q_const)
    pars = (ctypes.c_float * _OBS_PARS)(
        *(obs.pars + (0.0,) * (_OBS_PARS - len(obs.pars))))
    _launch(LAUNCHES, kernel, q, device, bits, n_steps, n_lane,
            ctypes.addressof(qc), ctypes.addressof(pars), R_packed,
            ode_weight, t_vec, x0_lanes, theta_lanes, tgrid, y, iobs, mask,
            *outs, model=model.cuda_functor, mode=mode,
            obs=_OBS_FUNCTORS[obs.cuda_functor])
    return tuple(outs)


# --- the smoothing passes' log-densities --------------------------------------


def _cond_params_cols(ops, mf, pf, mp, pp):
    """The backward kernels ``(G, b, C)`` of steps ``1 .. N-1`` from the
    filter's moments ``(N, d, n_block, B)`` in column arithmetic
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._gain_cols_batched`), with
    the transition and noise of K1's operands ``ops``: ``G (N-1, q*q,
    n_block, B)`` row-major, ``b (N-1, q, ...)``, packed ``C (N-1, n_tri,
    ...)``."""
    q, n_tri = mf.shape[1], pf.shape[1]
    R_packed = _pack_tri(ops["prior_var"], _tri_idx(q)[0])
    R_cols = [R_packed[None, :, k, None] for k in range(n_tri)]
    G, g, L = _gain_cols_batched(
        q, n_tri, ops["q_const"], R_cols, [mf[:-1, j] for j in range(q)],
        [pf[:-1, k] for k in range(n_tri)], [mp[1:, j] for j in range(q)],
        [pp[1:, k] for k in range(n_tri)])
    return (torch.stack([G[i][j] for i in range(q) for j in range(q)], 1),
            torch.stack(g, 1), torch.stack(L, 1))


def _eigh_finite(d):
    """``torch.linalg.eigh`` of symmetric matrices ``d (..., q, q)``, in
    chunks of ``_EIGH_CHUNK`` matrices (``ops.linalg._eigh``), NaN where a
    matrix is not finite, as ``jnp.linalg.eigh`` returns it there
    (``torch.linalg.eigh`` would raise for the whole batch): a lane that
    float32 loses stays NaN and leaves the others as they are."""
    ok = torch.isfinite(d).all(-1).all(-1)[..., None]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    w, v = _eigh(torch.where(ok[..., None], d, eye), chunk=_EIGH_CHUNK)
    nan = torch.tensor(float("nan"), dtype=d.dtype, device=d.device)
    return torch.where(ok, w, nan), torch.where(ok[..., None], v, nan)


def _masked_eigh(C):
    """Eigendecomposition of packed covariances ``C (T, n_tri, n_block, B)``
    (q <= 5) with the JAX package's relative mask of degenerate directions
    (``pallas_daltonng._masked_eigh``), formula for formula: the closed form
    :func:`~rodeo_tpu_torch.ops.linalg.sym_eigh_small` at q <= 3 and
    :func:`_eigh_finite` above (the JAX package's ``jnp.linalg.eigh``), a
    direction kept where its eigenvalue clears 100 eps of the
    largest, and for q = 3 the smallest eigenvalue refined as ``det /
    (lam_mid lam_hi)`` and kept where the determinant clears 100 eps of the
    sum of its cofactor terms' sizes and the refined value clears the
    relative screen.

    Returns:
        (tuple): ``w (T, n_block, B, q)`` ascending, ``v (..., q, q)``
        eigenvectors as columns, ``keep (..., q)``.
    """
    d = unpack_cov(C.movedim(1, -1))                    # (T, nb, B, q, q)
    q = d.shape[-1]
    w, v = sym_eigh_small(d) if q <= 3 else _eigh_finite(d)
    tol = 100.0 * torch.finfo(d.dtype).eps
    wmax = torch.clamp(torch.amax(torch.abs(w), dim=-1, keepdim=True),
                       min=1e-30)
    keep = w > tol * wmax
    if q == 3:
        t0 = d[..., 0, 0] * (d[..., 1, 1] * d[..., 2, 2]
                             - d[..., 1, 2] * d[..., 2, 1])
        t1 = d[..., 0, 1] * (d[..., 1, 0] * d[..., 2, 2]
                             - d[..., 1, 2] * d[..., 2, 0])
        t2 = d[..., 0, 2] * (d[..., 1, 0] * d[..., 2, 1]
                             - d[..., 1, 1] * d[..., 2, 0])
        det = t0 - t1 + t2
        noise = (torch.abs(d[..., 0, 0] * d[..., 1, 1] * d[..., 2, 2])
                 + torch.abs(d[..., 0, 0] * d[..., 1, 2] * d[..., 2, 1])
                 + torch.abs(d[..., 0, 1] * d[..., 1, 0] * d[..., 2, 2])
                 + torch.abs(d[..., 0, 1] * d[..., 1, 2] * d[..., 2, 0])
                 + torch.abs(d[..., 0, 2] * d[..., 1, 0] * d[..., 2, 1])
                 + torch.abs(d[..., 0, 2] * d[..., 1, 1] * d[..., 2, 0]))
        prod = w[..., 1] * w[..., 2]
        rank2 = w[..., 1] > tol * wmax[..., 0]
        lam_min_ref = det / torch.where(prod != 0, prod,
                                        torch.ones_like(prod))
        lam_min = torch.where(rank2, lam_min_ref, w[..., 0])
        keep_min = torch.where(
            rank2, (det > tol * noise) & (lam_min_ref > tol * wmax[..., 0]),
            keep[..., 0])
        w = torch.cat([lam_min[..., None], w[..., 1:]], dim=-1)
        keep = torch.cat([keep_min[..., None], keep[..., 1:]], dim=-1)
    return w, v, keep


def _where_kept(keep, x):
    return torch.where(keep, x, torch.zeros_like(x))


def _kept_trace(keep, safe_w, v, dC):
    """``tr(C^+ dC)`` over the kept spectrum: ``sum_kept (v' dC v)_ii /
    w_i``, as broadcast sums."""
    dCd = unpack_cov(dC.movedim(1, -1))
    dCv = torch.sum(dCd[..., :, :, None] * v[..., None, :, :], dim=-2)
    Mdiag = torch.sum(v * dCv, dim=-2)
    return torch.sum(_where_kept(keep, Mdiag / safe_w), dim=-1), dCd


class _LogdetPacked(torch.autograd.Function):
    """The masked log-determinant and kept-direction count of packed
    covariances ``C (T, n_tri, n_block, B)``: ``(sum_kept log w, n_kept)``,
    each ``(T, n_block, B)``.  Its tangent is ``tr(C^+ dC)`` over the kept
    spectrum (constant rank); the count has none."""

    @staticmethod
    def forward(C):
        w, _, keep = _masked_eigh(C)
        safe_w = torch.where(keep, w, torch.ones_like(w))
        return (torch.sum(_where_kept(keep, torch.log(safe_w)), dim=-1),
                torch.sum(keep, dim=-1).to(w.dtype))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, dC):
        (C,) = ctx.saved_tensors
        w, v, keep = _masked_eigh(C)
        safe_w = torch.where(keep, w, torch.ones_like(w))
        dld, _ = _kept_trace(keep, safe_w, v, dC)
        return dld, torch.zeros_like(dld)


class _LogpdfPacked(torch.autograd.Function):
    """The masked-eigen normal log-density of ``x (T, q, n_block, B)``
    around ``mean`` with packed covariance ``C (T, n_tri, n_block, B)``:
    the pseudo-inverse quadratic form and the log-determinant over the kept
    spectrum, ``(T, n_block, B)``.  Its tangent is the masked
    pseudo-inverse's, ``-1/2 [2 a'(dx - dmean) - a' dC a + tr(C^+ dC)]``
    with ``a = C^+ (x - mean)``."""

    @staticmethod
    def forward(x, mean, C):
        return _logpdf_pieces(x, mean, C)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, dx, dmean, dC):
        x, mean, C = ctx.saved_tensors
        _, (v, keep, safe_w, zv) = _logpdf_pieces(x, mean, C)
        alpha = _where_kept(keep, zv / safe_w)
        out = torch.zeros_like(safe_w[..., 0])
        if dx is not None or dmean is not None:
            dd = (dx if dx is not None else 0.0) - \
                (dmean if dmean is not None else 0.0)
            dz = torch.as_tensor(dd).expand_as(x).movedim(1, -1)
            dzv = torch.sum(dz[..., :, None] * v, dim=-2)
            out = out + 2.0 * torch.sum(alpha * dzv, dim=-1)
        if dC is not None:
            term3, dCd = _kept_trace(keep, safe_w, v, dC)
            va = torch.sum(v * alpha[..., None, :], dim=-1)
            term2 = -torch.sum(va[..., :, None] * dCd * va[..., None, :],
                               dim=(-2, -1))
            out = out + term2 + term3
        return -0.5 * out


def _logpdf_pieces(x, mean, C):
    w, v, keep = _masked_eigh(C)
    z = (x - mean).movedim(1, -1)                       # (T, nb, B, q)
    zv = torch.sum(z[..., :, None] * v, dim=-2)
    safe_w = torch.where(keep, w, torch.ones_like(w))
    quad = torch.sum(_where_kept(keep, zv * zv / safe_w), dim=-1)
    logdet = torch.sum(_where_kept(keep, torch.log(safe_w)), dim=-1)
    k = torch.sum(keep, dim=-1).to(w.dtype)
    val = -0.5 * (quad + logdet + k * _LOG2PI)
    return val, (v, keep, safe_w, zv)


def _row_chunks(n_rows):
    return [(r, min(r + _ROW_CHUNK, n_rows))
            for r in range(0, n_rows, _ROW_CHUNK)]


def _loglik_terms(theta_lanes, obs, obs_dims, obs_ind, y_obs, t_vec, C, pfN,
                  mean_path, Gz, bz, Cz, mzN, pzN):
    """``logy_x + logx_z - logx_yhat (B,)`` from the smoothing passes'
    operands, in Taylor-scaled coordinates:

    - ``C (N-1, n_tri, nb, B)`` and ``pfN (n_tri, nb, B)``: the Laplace
      filter's backward-kernel covariances and last filtered covariance;
    - ``mean_path (N+1, q, nb, B)``: the smoothed means, ``[m0, means,
      mN]``;
    - ``Gz (N-1, q*q, ...)``, ``bz (N-1, q, ...)``, ``Cz (N-1, n_tri,
      ...)``, ``mzN``, ``pzN``: the marginal filter's gains and last state.

    The log-densities run over ``_ROW_CHUNK`` rows at a time, in order."""
    q = mean_path.shape[1]
    n_steps = mean_path.shape[0] - 1
    ld_C = k_C = 0.0
    for r0, r1 in _row_chunks(C.shape[0]):
        ld, k = _LogdetPacked.apply(C[r0:r1])
        ld_C = ld_C + torch.sum(ld, dim=(0, 1))
        k_C = k_C + torch.sum(k, dim=(0, 1))
    ld_N, k_N = _LogdetPacked.apply(pfN[None])
    logx_yhat = -0.5 * (ld_C + torch.sum(ld_N, dim=(0, 1))
                        + (k_C + torch.sum(k_N, dim=(0, 1))) * _LOG2PI)
    # the observation model at the smoothed means, original coordinates
    iobs = torch.arange(len(obs_ind), dtype=torch.float32,
                        device=mean_path.device)[:, None, None]
    logy_x = 0.0
    for j in obs_dims:
        x_obs = mean_path[obs_ind, j] * t_vec[j]
        logy_x = logy_x + torch.sum(
            obs.comp_flat([y_obs], x_obs, j, theta_lanes, iobs), dim=(0, 1))
    # the smoothed path under the marginal filter's backward chain
    logx_z = torch.sum(_LogpdfPacked.apply(mean_path[n_steps][None],
                                           mzN[None], pzN[None]), dim=(0, 1))
    for r0, r1 in _row_chunks(Cz.shape[0]):
        path_n1 = mean_path[2 + r0:2 + r1]
        mean_sim = bz[r0:r1] + torch.stack(
            [sum(Gz[r0:r1, i * q + j] * path_n1[:, j] for j in range(q))
             for i in range(q)], dim=1)
        logx_z = logx_z + torch.sum(_LogpdfPacked.apply(
            mean_path[1 + r0:1 + r1], mean_sim, Cz[r0:r1]), dim=(0, 1))
    return logy_x + logx_z - logx_yhat


# --- the likelihood -------------------------------------------------------------


def _daltonng_prepare(thetas, ode_weight, ode_inits, t_min, t_max, n_steps,
                      prior_pars, obs_data, obs_times):
    """K1's operands and the observation grid of K9 on ``thetas``' device:
    ``y (N, n_block)``, ``iobs (N,)`` (the index of each step's observation,
    as a float) and ``mask (N,)`` of steps 1..N (the observation at t_min
    enters only through ``logy_x``), and for ``logy_x`` the grid index of
    each observation and the data ``(n_obs, n_block, 1)``."""
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    device = thetas.device
    n_block = ode_weight.shape[0]
    obs_data = torch.as_tensor(obs_data)
    n_obs = obs_data.shape[0]
    y_obs = obs_data.reshape(n_obs, n_block, -1)
    if y_obs.shape[-1] != 1:
        raise NotImplementedError(
            "daltonng_fused_batch takes one datum per block and observation")
    y_obs = y_obs.to(device, torch.float32)
    obs_ind = obs_indices(t_min, t_max, n_steps, obs_times).to(device)
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.zeros((n_steps + 1, n_block), **f32)
    y[obs_ind] = y_obs[..., 0]
    iobs = torch.zeros((n_steps + 1,), **f32)
    iobs[obs_ind] = torch.arange(n_obs, **f32)
    mask = torch.zeros((n_steps + 1,), **f32)
    mask[obs_ind] = 1.0
    mask[0] = 0.0
    grid = dict(y=y[1:].contiguous(), iobs=iobs[1:].contiguous(),
                mask=mask[1:].contiguous())
    return ops, grid, obs_ind, y_obs


@full_matmul_precision
def daltonng_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max,
                         n_steps, prior_pars, obs_data, obs_times, obs_model,
                         obs_dims, model, interrogation="kramer",
                         kalman_type="standard", device=None):
    r"""
    Lane-batched non-Gaussian DALTON log-likelihood ``logy_x + logx_z -
    logx_yhat``: kernels K9, K2r and K1 on the CUDA card (their plain twins
    with ``device="cpu"``), and the log-densities in batched torch.

    Args:
        thetas (Tensor(B, n_theta)): Per-lane parameters.
        ode_weight (Tensor(n_block, 1, q)), ode_inits (Tensor(B, n_block,
            q)), t_min, t_max, n_steps, prior_pars: As
            :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`.
        obs_data (Tensor(n_obs, n_block, 1)): Observations.
        obs_times (Tensor(n_obs,)): Observation times, on grid points.
        obs_model (ObsModel): The observation model, from
            :mod:`rodeo_tpu_torch.models.obs` (``gauss(var)``,
            ``poisson(b0, b1)``): it stands where the JAX package takes the
            callable ``obs_comp_flat``, and names both the plain
            log-likelihood and its CUDA functor.
        obs_dims (tuple of int): The state components the observations see
            (e.g. ``(0,)``).
        model: The ODE's name or model module, in place of the JAX
            package's ``ode_flat``/``jac_flat``.
        interrogation (str): ``"kramer"`` (EK1) or ``"rodeo"`` (EK0).
        kalman_type (str): ``"standard"``, or ``"sqrt"`` with the prior's
            variance given as a factor, squared at entry; the value does not
            depend on the form.  The observation model's own variance is
            not a factor in either.
        device: Where to run; ``None`` is the CUDA card, and raises without
            one.

    Returns:
        (Tensor(B,)): The log-likelihood of each lane, float32.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_nn_batch", "smoother_batch_rows",
                              "filter_batch"))
    obs = resolve_obs_model(obs_model)
    ops, grid, obs_ind, y_obs = _daltonng_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times)
    q, n_tri = ode_weight.shape[-1], len(_tri_idx(ode_weight.shape[-1])[0])
    mf, pf, mp, pp = filter_nn_batch(fused, obs, obs_dims, n_steps, **ops,
                                     **grid, mode=interrogation)
    G, b, C = _cond_params_cols(ops, mf, pf, mp, pp)
    mfN, pfN = mf[-1].clone(), pf[-1].clone()
    del mf, pf, mp, pp
    ones = torch.ones(q + n_tri, dtype=torch.float32, device=G.device)
    mean_rows, _ = smoother_recursion_batch_rows(
        b, G, C, mfN, pfN, ops["x0_lanes"], ones[:q], ones[q:])
    del G, b
    Gz, bz, Cz, mzN, pzN = fused_filter_batch(fused, n_steps, **ops,
                                              mode=interrogation)
    # the mean path (N+1, q, n_block, B), laid out as the gradient's
    mean_path = mean_rows.movedim(2, 1).contiguous()
    del mean_rows
    return _loglik_terms(ops["theta_lanes"], obs, obs_dims, obs_ind, y_obs,
                         ops["t_vec"], C, pfN, mean_path, Gz[1:], bz[1:],
                         Cz[1:], mzN, pzN)


@full_matmul_precision
def daltonng_fused_batch_grad(thetas, ode_weight, ode_inits, t_min, t_max,
                              n_steps, prior_pars, obs_data, obs_times,
                              obs_model, obs_dims, model,
                              interrogation="kramer", kalman_type="standard",
                              device=None):
    r"""
    Lane-batched non-Gaussian DALTON log-likelihood and its gradient in
    theta, forward mode: kernels K11d (the Laplace filter with tangents),
    K11e (the smoothed means with tangents) and K11a (the marginal filter's
    gains with tangents) on the CUDA card (their plain twins with
    ``device="cpu"``), and ``torch.func.jvp`` of the torch stages along each
    parameter.  ``ode_inits`` must not depend on theta: its tangents are
    zero.

    Args as :func:`daltonng_fused_batch`.

    Returns:
        (tuple): **loglik** ``(B,)``, equal to :func:`daltonng_fused_batch`'s
        bitwise, and **grad** ``(B, n_theta)``.
    """
    fused, _, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_nn_batch_tan", "smoother_mean_batch_tan",
                              "filter_batch_tan"))
    obs = resolve_obs_model(obs_model)
    ops, grid, obs_ind, y_obs = _daltonng_prepare(
        thetas, ode_weight, ode_inits, t_min, t_max, n_steps, prior_pars,
        obs_data, obs_times)
    q, n_tri = ode_weight.shape[-1], len(_tri_idx(ode_weight.shape[-1])[0])
    n_tan = fused.n_theta
    streams = filter_nn_batch_tan(fused, obs, obs_dims, n_steps, **ops,
                                  **grid, mode=interrogation)
    # each augmented output split into its values and each direction's
    # tangents (views): the backward kernels' values by a plain call (the
    # value call's operations), each direction's tangents by jvp
    split = [a.split(k, 1) for a, k in zip(streams, (q, n_tri, q, n_tri))]
    mfN, pfN = streams[0][-1].clone(), streams[1][-1].clone()
    del streams

    def pre(mf, pf, mp, pp):
        return _cond_params_cols(ops, mf, pf, mp, pp)

    prims = [s[0] for s in split]
    G, b, C = pre(*prims)

    def pre_tangents(k):
        # a direction that moves no moment of the Laplace filter (a
        # parameter that the ODE does not read: Chkrebtii's placeholder)
        # has exactly zero tangents here; its jvp would turn them into
        # 0 x inf = NaN wherever float32 overflows 1 / det of a predicted
        # covariance, so it is not run
        dirs = tuple(s[1 + k] for s in split)
        if not any(bool(d.any()) for d in dirs):
            return tuple(torch.zeros_like(a) for a in (G, b, C))
        return torch.func.jvp(pre, tuple(prims), dirs)[1]

    tans = [pre_tangents(k) for k in range(n_tan)]
    del split, prims
    means = smoother_mean_recursion_batch_tan(
        torch.cat([b] + [t[1] for t in tans], 1),
        torch.cat([G] + [t[0] for t in tans], 1), mfN, n_tan)
    del G, b
    dC = [t[2] for t in tans]
    del tans
    Gz, bz, Cz, mzN, pzN = fused_filter_batch_tan(fused, n_steps, **ops,
                                                  mode=interrogation)
    # the smoothed paths [m0, means, mN]; the initial state has no tangent
    x0 = ops["x0_lanes"][None]
    paths = [torch.cat([x0 if a == 0 else torch.zeros_like(x0), m, mN[None]])
             for a, (m, mN) in enumerate(zip(means.split(q, 1),
                                             mfN.split(q)))]
    del means
    # post's operands after theta and C, each as its value and tangents
    per_dir = [pfN.split(n_tri), paths, Gz[1:].split(q * q, 1),
               bz[1:].split(q, 1), Cz[1:].split(n_tri, 1), mzN.split(q),
               pzN.split(n_tri)]

    def post(th, C, pfN, path, Gz, bz, Cz, mzN, pzN):
        return _loglik_terms(th, obs, obs_dims, obs_ind, y_obs, ops["t_vec"],
                             C, pfN, path, Gz, bz, Cz, mzN, pzN)

    theta = ops["theta_lanes"]
    args = [theta, C] + [x[0] for x in per_dir]
    ll = post(*args)
    eye = torch.eye(n_tan, dtype=theta.dtype, device=theta.device)
    grads = []
    for k in range(n_tan):
        tangents = [eye[k][:, None].expand_as(theta), dC[k]] + \
            [x[1 + k] for x in per_dir]
        grads.append(torch.func.jvp(post, tuple(args), tuple(tangents))[1])
    return ll, torch.stack(grads, dim=-1)
