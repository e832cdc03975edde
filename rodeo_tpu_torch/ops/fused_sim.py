r"""
Lane-batched posterior path sampling on the GPU (port of
:mod:`rodeo_tpu.ops.pallas_sim`: ``solve_sim_fused_batch``).

A posterior path is drawn backwards through the per-step conditionals
:math:`x_n \mid x_{n+1} \sim N(g_n + G_n x_{n+1}, L_n)`, whose parameters
are the smoothing gains that kernel K1 (``csrc/filter_batch.cu``) emits.
With the noise :math:`c_n = g_n + L_n^{1/2} \epsilon_n` formed in torch
beforehand (a closed-form Cholesky in column layout), the only sequential
part left is the affine recursion :math:`x_n = c_n + G_n x_{n+1}`:

- K1 runs the forward filter;
- the terminal draw from the last filtered state and the noise are formed
  here in torch;
- **K6** ``csrc/sampler_batch.cu`` replaces ``_sampler_kernel_batch``: the
  reverse recursion over steps N-1..1, a stream whose loads go through a
  ring of shared-memory stages filled asynchronously, at q = 3, 4 and 5.

The plain PyTorch twin of K6 is :func:`_sampler_batch_plain`; the wrapper
:func:`sampler_batch` takes it only for CPU tensors.  ``LAUNCHES`` counts
K6's launches.
"""
import torch

from rodeo_tpu_torch.ops.fused_kalman import (
    _check, _chol_cols, _chol_matvec, _fused_inputs, _interrogation_normals,
    _kernel_operands, _launch, _launch_geometry, _tri_idx, fused_filter_batch)

__all__ = ["solve_sim_fused_batch", "sampler_batch", "LAUNCHES"]

# kernel launches since the last reset
LAUNCHES = {"sampler_batch": 0}


# --- K6: reverse affine recursion of the draw ---------------------------------------


def _sampler_batch_plain(c, G, xN):
    """Plain PyTorch twin of ``csrc/sampler_batch.cu``.  Arguments and
    returns as :func:`sampler_batch`."""
    n_len, q = c.shape[:2]
    xs = torch.empty_like(c)
    x_cols = list(xN)
    for r in range(n_len - 1, -1, -1):
        out = []
        for i in range(q):
            acc = c[r, i]
            for j in range(q):
                acc = acc + G[r, i * q + j] * x_cols[j]
            out.append(acc)
        x_cols = out
        xs[r] = torch.stack(x_cols)
    return xs


def sampler_batch(c, G, xN):
    r"""
    Lane-batched reverse affine recursion of the posterior draw (kernel
    K6): ``x_n = c_n + G_n x_{n+1}`` from ``xN`` down to row 0.

    Args:
        c (Tensor(T, q, n_block, B)): Offsets with their noise.
        G (Tensor(T, q*q, n_block, B)): Gains, row-major.
        xN (Tensor(q, n_block, B)): The draw after the last row.

    Returns:
        (Tensor(T, q, n_block, B)): The draws ``x_0 .. x_{T-1}``.
    """
    n_len, q, n_block, n_lane = c.shape
    device = c.device
    for name, t, shape in (
            ("c", c, (n_len, q, n_block, n_lane)),
            ("G", G, (n_len, q * q, n_block, n_lane)),
            ("xN", xN, (q, n_block, n_lane))):
        _check(name, t, shape, device)
    if device.type == "cpu":
        return _sampler_batch_plain(c, G, xN)
    xs = torch.empty_like(c)
    _launch(LAUNCHES, "sampler_batch", q, device, n_len, n_block * n_lane,
            c, G, xN, xs)
    return xs


def _sampler_batch_geometry(n_col, q=3, device=None):
    """The launch of kernel K6 (:func:`sampler_batch`) at ``q`` over ``n_col
    = n_block x B`` columns on the card, as
    :func:`~rodeo_tpu_torch.ops.fused_kalman._launch_geometry` reports it
    (its shared memory dynamic), with the stages of its shared-memory ring
    and the steps a stage holds."""
    return _launch_geometry("sampler_batch", device, n_col,
                            extra=("stages", "steps_per_stage"), q=q)


# --- the sampler ---------------------------------------------------------------------


def _draw_operands(fused, n_steps, ops, interrogation, eps, eps_term,
                   eps_int=None):
    """The operands of K6 for one draw: the forward filter (K1, with
    chkrebtii's normals ``eps_int``) on ``ops``
    (:func:`~rodeo_tpu_torch.ops.fused_kalman._kernel_operands`), the
    noise ``c = g + L^{1/2} eps`` of steps 1..N-1 and the terminal draw
    ``xN`` from the last filtered state.  Returns ``(c, G, xN)``."""
    q = ops["x0_lanes"].shape[0]
    pairs, where = _tri_idx(q)
    # entry 0 of the gains conditions onto the exact initial state and is
    # not drawn; the last filtered state seeds the terminal draw
    A, b, C, m_last, p_last = fused_filter_batch(
        fused, n_steps, **ops, mode=interrogation, eps=eps_int)
    Lc = _chol_cols(q, [C[1:, k] for k in range(len(pairs))], where)
    eta = _chol_matvec(q, Lc, [eps[:, j] for j in range(q)])
    c = torch.stack([b[1:, i] + eta[i] for i in range(q)], dim=1)
    del Lc, eta, b, C
    LN = _chol_cols(q, list(p_last), where)
    etaN = _chol_matvec(q, LN, list(eps_term))
    xN = torch.stack([m_last[j] + etaN[j] for j in range(q)])
    return c, A[1:], xN


def solve_sim_fused_batch(thetas, ode_weight, ode_inits, t_min, t_max,
                          n_steps, prior_pars, model, interrogation="kramer",
                          kalman_type="standard", generator=None, eps=None,
                          eps_term=None, device=None, eps_int=None):
    r"""
    Lane-batched posterior path sampling: ``B`` independent draws, one per
    lane, through kernels K1 and K6 on the CUDA card (their plain twins with
    ``device="cpu"``).  Each lane's draw follows the posterior of
    :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`.

    Args:
        generator (torch.Generator): Source of the standard normals, on
            ``device``; ``None`` takes PyTorch's default generator.
        eps (Tensor(N-1, q, n_block, B)), eps_term (Tensor(q, n_block, B)):
            The standard normals of steps 1..N-1 and of the terminal draw,
            in place of the generator's (both or neither).
        eps_int (Tensor(N, q, n_block, B)): Under chkrebtii, the standard
            normals of the interrogations' draws in place of the
            generator's, which draws them before the path's normals (the
            JAX package splits ``key`` into ``(key, key_int)`` and draws
            these from ``key_int``); the other interrogations ignore it.
        kalman_type (str): As the solve's; in the square-root form the
            prior's variance is a factor, squared at entry, and the draws
            are the same.
        (other args as
        :func:`rodeo_tpu_torch.ops.fused_kalman.solve_mv_fused_batch`)

    Returns:
        (Tensor(N+1, n_block, q, B)): The drawn paths in original
        coordinates, lanes last, float32.
    """
    fused, device, thetas, ode_weight, ode_inits, prior_pars = _fused_inputs(
        thetas, ode_weight, ode_inits, prior_pars, model, interrogation,
        kalman_type, device, ("filter_batch", "sampler_batch"))
    if (eps is None) != (eps_term is None):
        raise ValueError("pass both eps and eps_term, or neither")
    n_block, _, q = ode_weight.shape
    n_lane = thetas.shape[0]
    n_len = n_steps - 1
    eps_int = _interrogation_normals(interrogation,
                                     (n_steps, q, n_block, n_lane),
                                     generator, eps_int, device)
    if eps is None:
        normal = dict(generator=generator, dtype=torch.float32,
                      device=device)
        eps = torch.randn((n_len, q, n_block, n_lane), **normal)
        eps_term = torch.randn((q, n_block, n_lane), **normal)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
    eps_term = torch.as_tensor(eps_term, dtype=torch.float32, device=device)
    ops = _kernel_operands(thetas, ode_weight, ode_inits, t_min, t_max,
                           n_steps, prior_pars)
    c, G, xN = _draw_operands(fused, n_steps, ops, interrogation, eps,
                              eps_term, eps_int)
    xs = sampler_batch(c, G, xN)
    del c, G
    # assemble (N+1, nb, q, B) in original coordinates, lanes last
    path = torch.cat([ops["x0_lanes"].permute(1, 0, 2)[None],
                      xs.permute(0, 2, 1, 3), xN.permute(1, 0, 2)[None]])
    path *= ops["t_vec"][:, None]
    return path
