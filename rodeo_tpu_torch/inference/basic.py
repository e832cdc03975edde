r"""
Basic (plug-in) likelihood approximation (port of
:mod:`rodeo_tpu.inference.basic`).

:math:`\log p(Y_{0:M} \mid Z_{1:N})` is approximated by the user's
observation log-likelihood at the smoothed posterior mean
:math:`\mu_{n(i)|N}` of the solution, each observation time matched to its
grid point (:func:`rodeo_tpu_torch.ops.obs_grid.obs_indices`, the grid as
``jnp.linspace`` builds it).  On a chaotic system in float32 the plug-in
value inherits the trajectory's divergence; fenrir and DALTON marginalise
over the path instead.
"""
from rodeo_tpu_torch.ops.linalg import full_matmul_precision
from rodeo_tpu_torch.ops.obs_grid import obs_indices
from rodeo_tpu_torch.solve import solve_mv

__all__ = ["basic"]


@full_matmul_precision
def basic(key, ode_fun, ode_weight, ode_init, t_min, t_max, n_steps,
          interrogate, prior_pars, obs_data, obs_times, obs_loglik,
          kalman_type="standard", temporal="sequential", **params):
    r"""
    Basic approximate log-likelihood of :math:`p(Y_{0:M} \mid Z_{1:N})`.

    Args:
        obs_data (Tensor(n_obs, ...)): Observations.
        obs_times (Tensor(n_obs,)): Observation times.
        obs_loglik (Callable): ``obs_loglik(obs_data, ode_data, **params)``,
            ``ode_data`` the smoothed means at the observation times
            ``(n_obs, n_block, n_bstate)``.
        (other arguments as :func:`rodeo_tpu_torch.solve.solve_mv`)

    Returns:
        (tuple): the log-likelihood and the smoothed solution ``Xt``.
    """
    Xt, _ = solve_mv(
        key=key, ode_fun=ode_fun, ode_weight=ode_weight, ode_init=ode_init,
        t_min=t_min, t_max=t_max, n_steps=n_steps, interrogate=interrogate,
        prior_pars=prior_pars, kalman_type=kalman_type, temporal=temporal,
        **params)
    ode_data = Xt[obs_indices(t_min, t_max, n_steps, obs_times).to(
        Xt.device)]
    return obs_loglik(obs_data, ode_data, **params), Xt
