#!/usr/bin/env python3
"""
The pointwise audits of chip_smoke.py's coverage phase: the fused solves of
the configurations that the kernels K1, K3, K2r and K4 took last (the
Chkrebtii ODE at q = 4 and 5, Hes1, SEIRAH, schober), held to the port's
float64 torch-op solve (ops.precond.solve_mv), and their float32 errors on
the CPU, which set the audits' tolerances; and the likelihood audits of its
coverage_value phase, where K6, K7a, K7b and K8 took the same models.

    python3 tools/torch_coverage_reference.py [--device cpu] [--out FILE]
        [--parts solve,value,lanes,grad,daltonng]

Each fixture (FIXTURES) is one configuration of a model's setup and an
interrogation:

- chkrebtii_q4: bench.py's q = 4 row (``sec_chkrebtii_fitz``), Chkrebtii's
  ODE, 1024 steps to t = 10, EK1;
- chkrebtii_q5: the same at q = 5, W the same and x0 padded with a zero;
- hes1, seirah: their setups' full size, 120 steps to t = 240 and 80 steps
  to t = 60, EK1;
- fitz_schober: bench.py's ``fitz_accuracy`` fixture, FitzHugh-Nagumo, 800
  steps to t = 10, under schober.

It also holds the bitwise checks of those instances at small shapes, which
tests/test_torch_cuda.py and chip_smoke.py share: INSTANCE_CHECKS,
new_filter_instances, instance_case and filter_instance_outputs.

The value fixtures (VALUE_FIXTURES) observe the first four of those solves
in derivative 0 of every block at steps on the grid, with data from the
float64 torch-op solve plus noise (value_lanes, value_obs): fenrir through
``fenrir_fused_batch`` (K1, K7b) and ``fenrir_fused`` (K3, K7a), DALTON
through ``dalton_fused_batch`` (K8), under kramer and rodeo.

The gradient fixtures (GRAD_FIXTURES) of chip_smoke.py's coverage_grad
phase are the value fixtures and FitzHugh-Nagumo at q = 4 and 5 on
bench.py's 200-step gradient fixture (``fenrir_fitz_grad``: 21
observations of y_fitz_mcmc, variance 0.04), its weight and initial state
padded with zeros past the third derivative: fenrir through
``fenrir_fused_batch_grad`` (K11a, K11b), basic through
``basic_fused_batch_grad`` (K11a, K11e) and DALTON through
``dalton_fused_batch_grad`` (K11c, chip_smoke.py's coverage_dalton
phase), under kramer and rodeo.

Prints one JSON line: for each fixture, the largest error of the float32
solve's x (the mean's 0th derivative, every step and block) against the
float64 torch-op solve, the solve run by ``solve_mv_fused`` on ``--device``
(the CPU: the kernels' plain twins).  chip_smoke.py holds the card's fused
solves to the float64 torch-op on the card within max(3 x these CPU errors,
1e-3), bench.py's rule for FitzHugh-Nagumo (``bench.py:1948-1956``), and
keeps the errors as ``COVERAGE_F32_CPU_ERR``.  Under "value", for each
value fixture and mode, the absolute error of lane 0's float32 fenrir
(batched and single) and DALTON values on ``--device`` against the float64
torch-ops ``ops.precond.fenrir`` and ``dalton`` at lane 0's parameters;
chip_smoke.py holds the card's to the float64 torch-ops on the card within
the likelihood rule, max(3 x these errors, 1e-4 x |the float64 value|),
and keeps them as ``VALUE_F32_CPU_ERR``.  Under "lanes", for each value
fixture and mode at chip_smoke.py's 2048 lanes: the draws
at the setup's parameters against their posterior by the sim rule, in
float32 and by the twins in float64 on the same normals (the witness where
float32 does not resolve the draws), and the lanes on which float32 DALTON
is not finite (``VALUE_NAN_LANES``; Hes1's lanes 1 % apart,
``VALUE_WIDE_LANES``).  Under "grad", for each gradient fixture and
mode, lane 0's float32 fenrir, basic and DALTON values and gradients on
``--device`` against the float64 torch-ops ``ops.precond.fenrir``,
``basic`` and ``dalton`` with ``torch.autograd`` at lane 0's parameters:
the absolute error of the value and the relative L2 error of the
gradient, which chip_smoke.py keeps as ``GRAD_F32_CPU_ERR`` (bench.py's
gradient rule); for DALTON also the float32 result's move under a one-ulp
move of lane 0's theta and initial state, and the errors of K11c's twins
in float64 on the same operands (``dalton_float64_twins``), the witness
where float32 does not resolve DALTON (``DALTON_F32_UNRESOLVED``).
Under "daltonng" (not among the default parts), for each gradient fixture
and mode, lane 0's float32 non-Gaussian DALTON and its gradient
(``daltonng_fused_batch_grad``, Gaussian data in derivative 0) on
``--device`` against the float64 torch-op ``ops.precond.daltonng`` with
``torch.autograd``, as under "grad", which chip_smoke.py keeps as
``DALTONNG_F32_CPU_ERR``; the same of the entries' twins in float64 on
the same operands (``daltonng_float64_twins``), the witness where float32
does not resolve them; and the lanes on which the float32 value is not
finite at 2048 lanes.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

# name: (model, q, n_steps, t_max, interrogation)
FIXTURES = {
    "chkrebtii_q4": ("chkrebtii", 4, 1024, 10.0, "kramer"),
    "chkrebtii_q5": ("chkrebtii", 5, 1024, 10.0, "kramer"),
    "hes1": ("hes1", 3, 120, 240.0, "kramer"),
    "seirah": ("seirah", 3, 80, 60.0, "kramer"),
    "fitz_schober": ("fitzhugh", 3, 800, 10.0, "schober"),
}


# The bitwise checks of the instances that K1 and K3 took last: for each
# model functor (model, steps, t_max, prior sigma), a short horizon on which
# every mode stays finite.  Lorenz63 runs chkrebtii at prior sigma
# CHKREBTII_SIGMA: at the setup's 5e7 the draws from the predictive
# distribution carry the ODE off, and the JAX package's solve overflows as
# the port's does.
INSTANCE_CHECKS = {"Lorenz63": ("lorenz", 64, 0.16, 5e7),
                   "FitzHughNagumo": ("fitzhugh", 50, 5.0, 0.1),
                   "Hes1": ("hes1", 40, 4.0, 0.1),
                   "Seirah": ("seirah", 40, 7.5, 0.1),
                   "Chkrebtii": ("chkrebtii", 40, 10.0, 0.1)}
CHKREBTII_SIGMA = 10.0
# FitzHugh-Nagumo at q = 4 and 5 (its weight and initial state padded with
# zeros past the third derivative) steps at dt = 0.025: at the q = 3
# check's dt = 0.1 schober (no measurement noise) diverges at q = 4 and 5,
# in the float64 torch-op solve as in float32 (it overflows by step 18).
INSTANCE_CHECKS_Q = {("FitzHughNagumo", 4): ("fitzhugh", 50, 1.25, 0.1),
                     ("FitzHughNagumo", 5): ("fitzhugh", 50, 1.25, 0.1)}
# the models whose setup takes n_deriv (q): Chkrebtii's ODE at q = 4 and 5,
# FitzHugh-Nagumo padded with zeros past its third derivative
PADDED = ("chkrebtii", "fitzhugh")


def new_filter_instances():
    """The (model functor, mode, q) instances of K1 and K3 but the first
    four (kramer and rodeo on Lorenz63 and FitzHugh-Nagumo at q = 3), in
    order of q, functor and mode: FitzHugh-Nagumo at q = 4 and 5 among
    them."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    first = {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
             for md in ("kramer", "rodeo")}
    return sorted(fk._INSTANCES["filter_batch"] - first,
                  key=lambda k: (k[2], k[0], k[1]))


def instance_case(functor, mode, q, n_lane, device, seed):
    """The operands of the bitwise check of one instance (``functor``,
    ``mode``, ``q``) on ``device``: ``n_lane`` lanes of the functor's
    INSTANCE_CHECKS setup, thetas 1 % apart, and under chkrebtii its
    standard normals, drawn with numpy seed ``seed`` (FitzHugh-Nagumo at
    q = 4 and 5 on its INSTANCE_CHECKS_Q setup).  Returns a dict:
    ``fused`` (the FusedModel), ``n_steps``, ``cfg`` (the setup, theta
    popped out), ``config`` (the check's row for a report), ``batch`` (K1's
    operands as fused_filter_batch's keywords, ``eps`` included) and
    ``single`` (lane 0's, as fused_filter's)."""
    import importlib

    import numpy as np

    from rodeo_tpu_torch.ops import fused_kalman as fk
    model, n, t_max, sigma = INSTANCE_CHECKS_Q.get((functor, q),
                                                  INSTANCE_CHECKS[functor])
    if functor == "Lorenz63" and mode == "chkrebtii":
        sigma = CHKREBTII_SIGMA
    mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
    cfg = mod.setup(n_steps=n, t_max=t_max, prior_sigma=sigma,
                    dtype=torch.float32, device=device,
                    **({"n_deriv": q} if model in PADDED else {}))
    theta = cfg.pop("theta")
    if theta is None:
        theta = torch.zeros(1, device=device)
    rng = np.random.default_rng(seed)
    thetas = theta * (1 + 0.01 * torch.tensor(
        rng.standard_normal((n_lane, theta.shape[0])), dtype=torch.float32,
        device=device))
    batch = fk._kernel_operands(
        thetas, cfg["ode_weight"],
        cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape), 0.0,
        t_max, n, cfg["prior_pars"])
    fused = mod.FUSED
    batch["eps"] = torch.tensor(
        rng.standard_normal((n, q, fused.n_block, n_lane)),
        dtype=torch.float32, device=device) if mode == "chkrebtii" else None
    single = {k: v for k, v in batch.items()
              if k not in ("x0_lanes", "theta_lanes", "eps")}
    single.update(x0=batch["x0_lanes"][..., 0].T.contiguous(),
                  theta=batch["theta_lanes"][:, 0].contiguous(),
                  eps=None if batch["eps"] is None
                  else batch["eps"][..., 0].permute(0, 2, 1).contiguous())
    return {"fused": fused, "n_steps": n, "cfg": cfg, "batch": batch,
            "single": single,
            "config": {"model": functor, "mode": mode, "q": q,
                       "n_steps": n, "t_max": t_max, "prior_sigma": sigma,
                       "n_lane": n_lane}}


def filter_instance_outputs(case, mode):
    """K1 on ``case``'s lanes and K3 on its lane 0, each beside its plain
    twin on the same operands: ``((K1's outputs, the twin's), (K3's, the
    twin's))``."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    fused, n = case["fused"], case["n_steps"]
    return ((fk.fused_filter_batch(fused, n, **case["batch"], mode=mode),
             fk._filter_batch_plain(fused, n, **case["batch"], mode=mode)),
            (fk.fused_filter(fused, n, **case["single"], mode=mode),
             fk._filter_single_plain(fused, n, **case["single"], mode=mode)))


def fixture_config(name, dtype, device):
    """The setup of fixture ``name`` in ``dtype`` on ``device``, its theta
    (a zero for Chkrebtii's ODE, which has none) popped out."""
    import importlib
    model, q, n_steps, t_max, _ = FIXTURES[name]
    mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
    extra = {"n_deriv": q} if model == "chkrebtii" else {}
    cfg = mod.setup(n_steps=n_steps, t_max=t_max, dtype=dtype,
                    device=device, **extra)
    theta = cfg.pop("theta")
    if theta is None:
        theta = torch.zeros(1, dtype=dtype, device=device)
    return cfg, theta


def float64_solve(name, device):
    """The float64 torch-op posterior mean ``(N+1, n_block, q)`` of fixture
    ``name`` (ops.precond.solve_mv) on ``device``."""
    from rodeo_tpu_torch import interrogate
    from rodeo_tpu_torch.ops import precond
    model, *_, mode = FIXTURES[name]
    cfg, theta = fixture_config(name, torch.float64, device)
    params = {} if model == "chkrebtii" else {"theta": theta}
    mu, _ = precond.solve_mv(
        key=None, interrogate=getattr(interrogate, f"interrogate_{mode}"),
        **cfg, **params)
    return mu


def float32_call(name, device, n_lane=None):
    """A call of fixture ``name``'s float32 fused solve, its configuration
    built once: ``solve_mv_fused`` (K3, K4), or ``solve_mv_fused_batch``
    (K1, K2r) over ``n_lane`` lanes of it; the call returns the posterior
    mean ``(N+1, n_block, q[, n_lane])``."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    model, *_, mode = FIXTURES[name]
    cfg, theta = fixture_config(name, torch.float32, device)
    args = dict(ode_weight=cfg["ode_weight"], t_min=cfg["t_min"],
                t_max=cfg["t_max"], n_steps=cfg["n_steps"],
                prior_pars=cfg["prior_pars"], model=model,
                interrogation=mode, device=device)
    if n_lane is None:
        return lambda: fk.solve_mv_fused(theta, ode_init=cfg["ode_init"],
                                         **args)[0]
    thetas = theta.expand(n_lane, theta.shape[0])
    inits = cfg["ode_init"].expand((n_lane,) + tuple(cfg["ode_init"].shape))
    return lambda: fk.solve_mv_fused_batch(thetas, ode_inits=inits,
                                           **args)[0]


def max_err_x(mu32, mu64):
    """The largest error of x (the 0th derivative), every step and block."""
    return float((mu32[:, :, 0].double() - mu64[:, :, 0]).abs().max())


# The value fixtures of chip_smoke.py's coverage_value phase: FIXTURES' solve
# of the same name, observed in derivative 0 of every block at every
# every-th step (17 times on Chkrebtii's ODE, 21 on Hes1 and SEIRAH) with
# variance VALUE_OBS_VAR; name -> every.
VALUE_FIXTURES = {"chkrebtii_q4": 64, "chkrebtii_q5": 64, "hes1": 6,
                  "seirah": 4}
VALUE_OBS_VAR = 0.005
VALUE_MODES = ("kramer", "rodeo")
# The lanes' relative spread about the setup (value_lanes): 1 % of theta
# for SEIRAH, as chip_smoke.py's seeded_thetas; 0.1 % of x0 for
# Chkrebtii's ODE and of theta for Hes1, whose EK1 likelihoods at 1 %
# (VALUE_WIDE_LANES) float32 does not resolve: on the CPU a one-ulp move of
# one theta moves lane 0's fenrir by up to 0.16 and its DALTON by up to
# 0.34, where the float64 values move by 3e-4 and 5e-3, and DALTON is NaN
# on some lanes.
VALUE_LANE_SCALE = {"chkrebtii_q4": 1e-3, "chkrebtii_q5": 1e-3,
                    "hes1": 1e-3, "seirah": 1e-2}
# The fixtures whose DALTON chip_smoke.py also runs on lanes this far
# apart, and the lanes on which it is not finite there in float32, by
# fixture and mode, as the twins count them on the CPU at 2048 lanes
# (lane_readings): Hes1's EK1 DALTON, whose sum with data turns NaN on 441
# (the JAX package's fused path too).  Every other mode is finite there.
VALUE_WIDE_LANES = {"hes1": 1e-2}
VALUE_NAN_LANES = {("hes1", "kramer"): 441}


def value_lanes(name, n_lane, device, seed, scale=None):
    """``n_lane`` float32 lanes of value fixture ``name`` on ``device``:
    ``(thetas (B, n_theta), inits (B, n_block, q))``.  Chkrebtii's ODE has
    no parameter: its lanes' initial values are the setup's x (1 + s x
    normals); the other models' lanes take the setup's initial value and
    its theta x (1 + s x normals), s ``scale`` (the fixture's
    VALUE_LANE_SCALE unless given) and the normals from numpy seed
    ``seed``."""
    import numpy as np
    cfg, theta = fixture_config(name, torch.float32, device)
    rng = np.random.default_rng(seed)
    s = VALUE_LANE_SCALE[name] if scale is None else scale
    x0 = cfg["ode_init"]
    if FIXTURES[name][0] == "chkrebtii":
        noise = torch.tensor(rng.standard_normal((n_lane,) + x0.shape),
                             dtype=torch.float32, device=device)
        return (theta.expand(n_lane, theta.shape[0]).contiguous(),
                x0 * (1 + s * noise))
    noise = torch.tensor(rng.standard_normal((n_lane, theta.shape[0])),
                         dtype=torch.float32, device=device)
    return (theta * (1 + s * noise),
            x0.expand((n_lane,) + x0.shape).contiguous())


def value_obs(name, mu64, dtype, device, seed):
    """The observations of value fixture ``name`` in ``dtype`` on
    ``device`` (their times on the CPU, float64): derivative 0 of every
    block at every VALUE_FIXTURES[name]-th step, variance VALUE_OBS_VAR,
    the data ``mu64`` (the float64 torch-op solve's mean, float64_solve)
    there plus normals of that variance from numpy seed ``seed``."""
    import numpy as np
    _, q, n_steps, t_max, _ = FIXTURES[name]
    idx = np.arange(0, n_steps + 1, VALUE_FIXTURES[name])
    nb = mu64.shape[1]
    weight = torch.zeros((len(idx), nb, 1, q), dtype=dtype, device=device)
    weight[..., 0] = 1.0
    noise = np.random.default_rng(seed).standard_normal((len(idx), nb, 1))
    data = mu64[torch.from_numpy(idx).to(mu64.device), :, 0:1].to(
        "cpu", torch.float64) + torch.from_numpy(noise) * VALUE_OBS_VAR ** 0.5
    return dict(obs_data=data.to(device, dtype),
                obs_times=torch.from_numpy(np.linspace(0.0, t_max,
                                                       n_steps + 1)[idx]),
                obs_weight=weight,
                obs_var=torch.full((len(idx), nb, 1, 1), VALUE_OBS_VAR,
                                   dtype=dtype, device=device))


def value_float64(name, mode, theta, init, obs, device):
    """The float64 torch-ops ``ops.precond.fenrir`` and ``dalton`` of value
    fixture ``name`` under ``mode`` at one lane's ``theta`` and ``init`` on
    ``device``: ``{"fenrir": value, "dalton": value}``."""
    from rodeo_tpu_torch import interrogate
    from rodeo_tpu_torch.ops import precond
    cfg, _ = fixture_config(name, torch.float64, device)
    cfg["ode_init"] = init.to(device, torch.float64)
    params = {} if FIXTURES[name][0] == "chkrebtii" else {
        "theta": theta.to(device, torch.float64)}
    obs64 = {k: v.to(torch.float64) if k == "obs_times" else v.to(
        device, torch.float64) for k, v in obs.items()}
    how = getattr(interrogate, f"interrogate_{mode}")
    return {fn: float(getattr(precond, fn)(key=None, interrogate=how,
                                            **cfg, **obs64, **params))
            for fn in ("fenrir", "dalton")}


def value_float32_calls(name, mode, thetas, inits, obs, device):
    """The float32 fused likelihoods of value fixture ``name`` under
    ``mode`` over the lanes ``thetas``, ``inits`` on ``device``:
    ``{"fenrir_batch": fenrir_fused_batch (K1, K7b), "dalton_batch":
    dalton_fused_batch (K8), "fenrir_single": fenrir_fused on lane 0 (K3,
    K7a)}``, each a call returning its values."""
    from rodeo_tpu_torch.ops import fused_dalton as fd
    from rodeo_tpu_torch.ops import fused_fenrir as ff
    model = FIXTURES[name][0]
    cfg, _ = fixture_config(name, torch.float32, device)
    args = dict(t_min=cfg["t_min"], t_max=cfg["t_max"],
                n_steps=cfg["n_steps"], prior_pars=cfg["prior_pars"],
                model=model, interrogation=mode, device=device, **obs)
    return {"fenrir_batch": lambda: ff.fenrir_fused_batch(
                thetas, cfg["ode_weight"], inits, **args),
            "dalton_batch": lambda: fd.dalton_fused_batch(
                thetas, cfg["ode_weight"], inits, **args),
            "fenrir_single": lambda: ff.fenrir_fused(
                thetas[0], cfg["ode_weight"], inits[0], **args)}


def value_errors(device, n_lane=4, seed=28):
    """For each value fixture and mode, the absolute error of lane 0's
    float32 likelihoods (value_float32_calls) against the float64 torch-ops
    (value_float64) on ``device``, and those values."""
    out = {}
    for name in VALUE_FIXTURES:
        obs = value_obs(name, float64_solve(name, device), torch.float32,
                        device, seed + 1)
        thetas, inits = value_lanes(name, n_lane, device, seed)
        for mode in VALUE_MODES:
            ref = value_float64(name, mode, thetas[0], inits[0], obs, device)
            row = {"float64": ref}
            for call, fn in value_float32_calls(name, mode, thetas, inits,
                                                obs, device).items():
                lane0 = float(fn().reshape(-1)[0])
                row[call] = abs(lane0 - ref[call.split("_")[0]])
            out[f"{name}/{mode}"] = row
    return out


def draw_stats(draws, post_mean, post_var, var_min, sd_rel=0.0):
    """chip_smoke.py's sim rule on draws ``(N+1, nb, q, B)`` against a
    posterior ``(N+1, nb, q)`` (row 0, the initial value, left out), on the
    entries whose posterior variance exceeds ``var_min`` and whose standard
    deviation exceeds ``sd_rel`` of the mean's magnitude: the largest z of
    the lane mean (its distance from the posterior mean over the standard
    error, the posterior variance / B) and the range of the lane variance
    over the posterior's."""
    d = draws[1:].double()
    pm, pv = post_mean[1:].double(), post_var[1:].double()
    keep = (pv > var_min) & (pv.sqrt() > sd_rel * pm.abs())
    if not keep.any():
        return {"entries_checked": 0, "entries": int(keep.numel())}
    z = ((d.mean(-1) - pm).abs() / (pv / d.shape[-1]).sqrt())[keep]
    ratio = (d.var(-1) / pv)[keep]
    return {"entries_checked": int(keep.sum()),
            "entries": int(keep.numel()), "max_z": z.max().item(),
            "var_ratio": (ratio.min().item(), ratio.max().item())}


def draw_normals(name, n_lane, generator, device):
    """The standard normals of one ``solve_sim_fused_batch`` of value
    fixture ``name`` over ``n_lane`` lanes, drawn from ``generator`` as the
    entry draws them: ``(eps (N-1, q, n_block, B), eps_term (q, n_block,
    B))``."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    model, q, n_steps, _, _ = FIXTURES[name]
    shape = (q, fk.resolve_model(model).n_block, n_lane)
    normal = dict(generator=generator, dtype=torch.float32, device=device)
    eps = torch.randn((n_steps - 1,) + shape, **normal)
    return eps, torch.randn(shape, **normal)


def float64_draws(name, mode, n_lane, eps, eps_term, device):
    """The draws of value fixture ``name`` under ``mode`` at the setup's
    parameters on ``n_lane`` lanes, given their normals, by the port's
    plain twins in float64 on the float32 operands of
    ``solve_sim_fused_batch`` (K1's twin, the draw's noise as
    ``fused_sim._draw_operands`` forms it, K6's twin), and the posterior of
    lane 0 by K1's and K2r's twins: ``(draws (N+1, n_block, q, B), mean
    (N+1, n_block, q), variance (N+1, n_block, q))``, float64 on
    ``device``.  The kernels are bitwise the float32 twins; this is the
    same arithmetic without float32's rounding, the witness of the draws'
    distribution where float32 does not resolve it."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    from rodeo_tpu_torch.ops import fused_sim as fs
    model, q, n_steps, t_max, _ = FIXTURES[name]
    cfg, theta = fixture_config(name, torch.float32, device)
    fused = fk.resolve_model(model)
    inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
    ops = fk._kernel_operands(theta.expand(n_lane, theta.shape[0]),
                              cfg["ode_weight"], inits, 0.0, t_max, n_steps,
                              cfg["prior_pars"])
    ops = {k: v.double() if isinstance(v, torch.Tensor) else v
           for k, v in ops.items()}
    A, b, C, m_last, p_last = fk._filter_batch_plain(fused, n_steps, **ops,
                                                     mode=mode)
    pairs, where = fk._tri_idx(q)
    Lc = fk._chol_cols(q, [C[1:, k] for k in range(len(pairs))], where)
    eta = fk._chol_matvec(q, Lc, [eps.double()[:, j] for j in range(q)])
    c = torch.stack([b[1:, i] + eta[i] for i in range(q)], dim=1)
    LN = fk._chol_cols(q, list(p_last), where)
    etaN = fk._chol_matvec(q, LN, list(eps_term.double()))
    xN = torch.stack([m_last[j] + etaN[j] for j in range(q)])
    xs = fs._sampler_batch_plain(c, A[1:], xN)
    t_vec = ops["t_vec"]
    draws = torch.cat([ops["x0_lanes"].permute(1, 0, 2)[None],
                       xs.permute(0, 2, 1, 3), xN.permute(1, 0, 2)[None]])
    draws *= t_vec[:, None]
    lane0 = [a[..., :1] for a in (b[1:], A[1:], C[1:], m_last, p_last,
                                  ops["x0_lanes"])]
    mean, var = fk._smoother_batch_rows_plain(*lane0, t_vec,
                                              fk._tri_scale(t_vec))
    diag = [where[(j, j)] for j in range(q)]
    return draws, mean[..., 0], var[:, :, diag, 0]


def lane_readings(device, var_min, sd_rel, n_lane=2048, seed=30):
    """For each value fixture and mode at chip_smoke.py's ``n_lane``
    lanes on ``device``: the float32 draws of ``solve_sim_fused_batch`` at
    the setup's parameters against its posterior (``solve_mv_fused_batch``)
    by draw_stats, with ``sd_rel`` and without (``float32``,
    ``float32_all``), the float64 twins' draws on the same normals against
    their posterior without it (``float64``), and the lanes on which its
    float32 DALTON (``dalton_fused_batch`` on value_lanes, as far apart as
    VALUE_WIDE_LANES where it names the fixture) is not finite."""
    from rodeo_tpu_torch.ops import fused_dalton as fd
    from rodeo_tpu_torch.ops import fused_kalman as fk
    from rodeo_tpu_torch.ops import fused_sim as fs
    out = {}
    for name in VALUE_FIXTURES:
        model, q, n_steps, t_max, _ = FIXTURES[name]
        cfg, theta = fixture_config(name, torch.float32, device)
        obs = value_obs(name, float64_solve(name, device), torch.float32,
                        device, 29)
        thetas, inits = value_lanes(name, n_lane, device, 28,
                                    VALUE_WIDE_LANES.get(name))
        base = (theta.expand(n_lane, theta.shape[0]), cfg["ode_weight"],
                cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape),
                0.0, t_max, n_steps, cfg["prior_pars"])
        _, where = fk._tri_idx(q)
        diag = [where[(j, j)] for j in range(q)]
        for mode in VALUE_MODES:
            gen = torch.Generator(device).manual_seed(seed)
            eps, eps_term = draw_normals(name, n_lane, gen, device)
            kw = dict(model=model, interrogation=mode, device=device)
            draws = fs.solve_sim_fused_batch(*base, **kw, eps=eps,
                                             eps_term=eps_term)
            mean, var = fk.solve_mv_fused_batch(
                *[a[:1] if i in (0, 2) else a for i, a in enumerate(base)],
                **kw)
            post = (mean[..., 0], var[:, :, diag, 0])
            d64 = float64_draws(name, mode, n_lane, eps, eps_term, device)
            ld = fd.dalton_fused_batch(thetas, cfg["ode_weight"], inits, 0.0,
                                       t_max, n_steps, cfg["prior_pars"],
                                       **obs, **kw)
            out[f"{name}/{mode}"] = {
                "float32": draw_stats(draws, *post, var_min, sd_rel),
                "float32_all": draw_stats(draws, *post, var_min),
                "float64": draw_stats(*d64, var_min),
                "dalton_nonfinite_lanes": int((~torch.isfinite(ld)).sum())}
            if name in VALUE_WIDE_LANES:
                out[f"{name}/{mode}"]["lane0_ulp_moves"] = ulp_moves(
                    name, mode, thetas[:4], inits[:4], obs, device)
    return out


def ulp_moves(name, mode, thetas, inits, obs, device):
    """The largest move of lane 0's float32 likelihoods
    (value_float32_calls) and of the float64 torch-ops' (value_float64)
    when one entry of lane 0's theta moves by one float32 ulp, up or down:
    how far float32 resolves them there."""
    import numpy as np

    def values(ths):
        v32 = {c: float(f().reshape(-1)[0]) for c, f in value_float32_calls(
            name, mode, ths, inits, obs, device).items()}
        return v32, value_float64(name, mode, ths[0], inits[0], obs, device)

    base32, base64 = values(thetas)
    moves = {k: 0.0 for k in (*base32, *base64)}
    for k in range(thetas.shape[1]):
        for way in (np.inf, -np.inf):
            moved = thetas.clone()
            moved[0, k] = float(np.nextafter(np.float32(thetas[0, k].item()),
                                             np.float32(way)))
            v32, v64 = values(moved)
            for c, v in [*v32.items(), *v64.items()]:
                ref = base32[c] if c in base32 else base64[c]
                moves[c] = max(moves[c], abs(v - ref))
    return moves


# The gradient fixtures of chip_smoke.py's coverage_grad phase: the value
# fixtures, and FitzHugh-Nagumo at q = 4 and 5 on bench.py's 200-step
# gradient fixture (fenrir_fitz_grad: t in [0, 10], 21 observations of
# y_fitz_mcmc in derivative 0 of both blocks, variance 0.04, theta x (1 +
# 1e-6 x lane)), its weight and initial state padded with zeros past the
# third derivative; name -> (model, q, n_steps, t_max).
GRAD_FIXTURES = {**{k: FIXTURES[k][:4] for k in VALUE_FIXTURES},
                 "fitz_grad_q4": ("fitzhugh", 4, 200, 10.0),
                 "fitz_grad_q5": ("fitzhugh", 5, 200, 10.0)}
FITZ_GRAD_VAR = 0.04
# The gradient fixtures on which float32 does not resolve DALTON (the
# difference of two float32 sums, "grad"'s errors): Chkrebtii's ODE at
# q = 5, whose value float32 loses (sums of ~1e10), and FitzHugh-Nagumo at
# q = 4 and 5, whose value and, but under rodeo at q = 4, gradient it loses
# (sums of ~1e8 and ~1e12 that round to whole numbers, to 0 at q = 5).
# The twins in float64 on the same operands (dalton_float64_twins) are
# their witness.
DALTON_F32_UNRESOLVED = ("chkrebtii_q5", "fitz_grad_q4", "fitz_grad_q5")


def gauss_loglik(var):
    """The basic likelihood's observation log-density of the gradient
    fixtures: independent Gaussians of variance ``var`` in derivative 0
    (an ``obs_loglik(obs_data, ode_data, **params)``)."""
    def obs_loglik(obs_data, ode_data, **params):
        r = obs_data[..., 0] - ode_data[..., 0]
        return torch.sum(-0.5 * r * r / var)
    return obs_loglik


def grad_config(name, dtype, device):
    """The setup of gradient fixture ``name`` in ``dtype`` on ``device``,
    its theta popped out: a value fixture's (fixture_config), or
    FitzHugh-Nagumo's padded to q derivatives."""
    import importlib
    if name in VALUE_FIXTURES:
        return fixture_config(name, dtype, device)[0]
    model, q, n_steps, t_max = GRAD_FIXTURES[name]
    mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
    cfg = mod.setup(n_steps=n_steps, t_max=t_max, dtype=dtype,
                    device=device, n_deriv=q)
    cfg.pop("theta")
    return cfg


def grad_fixture(name, n_lane, dtype, device, seed=28, mu64=None):
    """Gradient fixture ``name`` in ``dtype`` on ``device``: ``(cfg, lanes,
    obs, var)``, the setup (theta popped out), the lanes ``(thetas (B,
    n_theta), inits (B, n_block, q))`` in float32, the observations as
    fenrir_fused_batch takes them, and their variance.  A value fixture's
    lanes and observations are value_lanes' and value_obs' (seeds ``seed``
    and ``seed`` + 1, the data from ``mu64``, float64_solve's unless
    given); FitzHugh-Nagumo's are bench.py's."""
    import importlib

    import numpy as np
    model, q, n_steps, t_max = GRAD_FIXTURES[name]
    cfg = grad_config(name, dtype, device)
    if name in VALUE_FIXTURES:
        lanes = value_lanes(name, n_lane, device, seed)
        mu64 = float64_solve(name, device) if mu64 is None else mu64
        obs = value_obs(name, mu64, dtype, device, seed + 1)
        return cfg, lanes, obs, VALUE_OBS_VAR
    mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
    theta = torch.tensor(mod.THETA, dtype=torch.float32, device=device)
    ref = np.load(REPO / ".bench_ref_v8.npz")
    lane = torch.arange(n_lane, dtype=torch.float32, device=device)
    thetas = theta.expand(n_lane, 3) * (1 + 1e-6 * lane[:, None])
    inits = cfg["ode_init"].to(torch.float32).expand(
        (n_lane,) + cfg["ode_init"].shape).contiguous()
    weight = torch.zeros((21, 2, 1, q), dtype=dtype, device=device)
    weight[..., 0] = 1.0
    obs = dict(
        obs_data=torch.tensor(ref["y_fitz_mcmc"], dtype=dtype,
                              device=device)[:, :, None],
        obs_times=torch.from_numpy((10.0 * np.arange(0, 201, 10) / 200)
                                   .astype(np.float32)),
        obs_weight=weight,
        obs_var=torch.full((21, 2, 1, 1), FITZ_GRAD_VAR, dtype=dtype,
                           device=device))
    return cfg, (thetas, inits), obs, FITZ_GRAD_VAR


def grad_float64(name, mode, theta, init, obs, var, device,
                 fns=("fenrir", "basic")):
    """The float64 torch-ops ``ops.precond.<fn>`` for fn in ``fns`` (of
    ``fenrir``, ``basic`` and ``dalton``) of gradient fixture ``name`` under
    ``mode`` at one lane's ``theta`` and ``init`` on ``device``, with their
    ``torch.autograd`` gradients in theta: ``{fn: (value, grad)}``, grad a
    list (zeros for Chkrebtii's ODE, which has no parameter)."""
    from rodeo_tpu_torch import interrogate
    from rodeo_tpu_torch.ops import precond
    model = GRAD_FIXTURES[name][0]
    cfg = grad_config(name, torch.float64, device)
    cfg["ode_init"] = init.to(device, torch.float64)
    obs64 = {k: v.to(torch.float64) if k == "obs_times" else v.to(
        device, torch.float64) for k, v in obs.items()}
    how = getattr(interrogate, f"interrogate_{mode}")
    out = {}
    for fn in fns:
        th = theta.to(device, torch.float64).clone().requires_grad_(True)
        params = {} if model == "chkrebtii" else {"theta": th}
        extra = dict(obs64) if fn != "basic" else dict(
            obs_data=obs64["obs_data"], obs_times=obs64["obs_times"],
            obs_loglik=gauss_loglik(var))
        value = getattr(precond, fn)(key=None, interrogate=how, **cfg,
                                     **extra, **params)
        value = value[0] if fn == "basic" else value
        if model == "chkrebtii":
            out[fn] = (float(value.detach()), [0.0])
            continue
        value.backward()
        out[fn] = (float(value.detach()), th.grad.tolist())
    return out


def grad_float32_calls(name, mode, thetas, inits, obs, var, device):
    """The float32 fused gradient entries of gradient fixture ``name`` under
    ``mode`` over the lanes ``thetas``, ``inits`` on ``device``:
    ``{"fenrir": fenrir_fused_batch_grad (K11a, K11b), "basic":
    basic_fused_batch_grad (K11a, K11e), "solve":
    solve_mv_fused_batch_grad (K11a, K11e), "dalton":
    dalton_fused_batch_grad (K11c)}``, each a call returning its outputs
    (fenrir's, basic's and DALTON's value and gradient first)."""
    from rodeo_tpu_torch.ops import fused_dalton as fd
    from rodeo_tpu_torch.ops import fused_fenrir as ff
    from rodeo_tpu_torch.ops import fused_kalman as fk
    model = GRAD_FIXTURES[name][0]
    cfg = grad_config(name, torch.float32, device)
    args = (thetas, cfg["ode_weight"], inits, cfg["t_min"], cfg["t_max"],
            cfg["n_steps"], cfg["prior_pars"])
    kw = dict(model=model, interrogation=mode, device=device)
    return {"fenrir": lambda: ff.fenrir_fused_batch_grad(*args, **obs, **kw),
            "basic": lambda: fk.basic_fused_batch_grad(
                *args, obs_data=obs["obs_data"], obs_times=obs["obs_times"],
                obs_loglik=gauss_loglik(var), **kw),
            "solve": lambda: fk.solve_mv_fused_batch_grad(*args, **kw),
            "dalton": lambda: fd.dalton_fused_batch_grad(*args, **obs,
                                                         **kw)}


def dalton_operands(name, thetas, inits, obs, device):
    """The operands of DALTON's two K11c launches for gradient fixture
    ``name`` over the lanes ``thetas``, ``inits``, as
    ``dalton_fused_batch_grad`` makes them on ``device`` (float32):
    ``fused_dalton._dalton_prepare``'s ``(ops, grid, ld0)``."""
    from rodeo_tpu_torch.ops import fused_dalton as fd
    cfg = grad_config(name, torch.float32, device)
    return fd._dalton_prepare(
        thetas, cfg["ode_weight"], inits, cfg["t_min"], cfg["t_max"],
        cfg["n_steps"], cfg["prior_pars"], *obs.values())


def dalton_float64_twins(model, mode, n_steps, ops, grid, ld0,
                         tangent=True):
    """DALTON's log-likelihood and its gradient by the plain twins of K11c
    (``_dalton_filter_tan_plain``, K8's twin on Duals) in float64, on the
    float32 operands ``(ops, grid, ld0)`` of dalton_operands (on their
    device): ``(value (B,), grad (B, n_theta))``, float64; with ``tangent``
    False K8's twin alone and grad None.  The kernels are bitwise the
    float32 twins; this is the same arithmetic without float32's rounding,
    the witness of the result where float32 does not resolve it (a
    difference of two sums that float32 rounds to whole numbers)."""
    from rodeo_tpu_torch.ops import fused_dalton as fd
    from rodeo_tpu_torch.ops import fused_kalman as fk
    fused = fk.resolve_model(model)
    f64 = {k: v.double() if isinstance(v, torch.Tensor) else v
           for k, v in {**ops, **grid}.items()}
    ld0 = ld0.double()
    if not tangent:
        lds = [fd._dalton_filter_plain(fused, n_steps, **f64, ld0=seed,
                                       mode=mode, with_obs=w)
               for seed, w in ((ld0, True), (torch.zeros_like(ld0), False))]
        return lds[0] - lds[1], None
    zeros = ld0.new_zeros((fused.n_theta + 1, ld0.shape[0]))
    seed = torch.cat([ld0[None], zeros[1:]])
    diff = (fd._dalton_filter_tan_plain(fused, n_steps, **f64, ld0=seed,
                                        mode=mode, with_obs=True)
            - fd._dalton_filter_tan_plain(fused, n_steps, **f64, ld0=zeros,
                                          mode=mode, with_obs=False))
    return diff[0], diff[1:].T


def _grad_errs(value, grad, ref):
    """The absolute error of lane 0's ``value`` and the relative L2 error of
    its ``grad`` (bench.py's audit_grad; the norm of grad where the
    float64 gradient is zero) against the float64 ``(value, grad)``
    ``ref``."""
    import numpy as np
    g64 = np.asarray(ref[1], np.float64)
    g = np.asarray(grad, np.float64)
    norm = np.linalg.norm(g64)
    return {"value": abs(float(value) - ref[0]),
            "grad": float(np.linalg.norm(g - g64) / norm) if norm > 0
            else float(np.linalg.norm(g))}


def grad_errors(device, n_lane=4):
    """For each gradient fixture and mode, lane 0's float32 fenrir, basic
    and DALTON (grad_float32_calls) against the float64 torch-ops
    (grad_float64) on ``device``: the absolute error of the value, the
    relative L2 error of the gradient (bench.py's audit_grad), and the
    float64 values; for DALTON also the float64 twins' (dalton_float64_
    twins, the value alone on Chkrebtii's ODE) and the float32 result's
    move under a one-ulp move of lane 0's theta and initial state
    (``ulp_move``: the largest change of the value, and of the gradient
    relative to its norm)."""
    import numpy as np
    out = {}
    for name in GRAD_FIXTURES:
        model, _, n_steps, _ = GRAD_FIXTURES[name]
        cfg, (thetas, inits), obs, var = grad_fixture(name, n_lane,
                                                      torch.float32, device)
        for mode in VALUE_MODES:
            ref = grad_float64(name, mode, thetas[0], inits[0], obs, var,
                               device, fns=("fenrir", "basic", "dalton"))
            calls = grad_float32_calls(name, mode, thetas, inits, obs, var,
                                       device)
            row = {"float64": ref}
            for fn in ("fenrir", "basic", "dalton"):
                ll, g = calls[fn]()[:2]
                row[fn] = _grad_errs(ll[0], g[0].double().cpu(), ref[fn])
            ll, g = calls["dalton"]()
            moved = dict(zip(("thetas", "inits"), (
                torch.where(a != 0, torch.nextafter(a, torch.full_like(
                    a, float("inf"))), a) for a in (thetas, inits))))
            ll_m, g_m = grad_float32_calls(name, mode, moved["thetas"],
                                           moved["inits"], obs, var,
                                           device)["dalton"]()
            norm = float(np.linalg.norm(g[0].double().cpu().numpy()))
            row["dalton"]["ulp_move"] = {
                "value": abs(float(ll_m[0]) - float(ll[0])),
                "grad": float(np.linalg.norm((g_m[0] - g[0]).double().cpu()
                                             .numpy())) / norm
                if norm > 0 else float(np.linalg.norm(
                    g_m[0].double().cpu().numpy()))}
            tangent = model != "chkrebtii"
            v64, g64 = dalton_float64_twins(
                model, mode, n_steps,
                *dalton_operands(name, thetas, inits, obs, device),
                tangent=tangent)
            row["dalton"]["f64_twins"] = _grad_errs(
                v64[0], g64[0].cpu() if tangent else [0.0], ref["dalton"])
            out[f"{name}/{mode}"] = row
    return out



# --- non-Gaussian DALTON on the gradient fixtures (chip_smoke.py's
# coverage_daltonng phase) ----------------------------------------------------

def daltonng_args(name, thetas, inits, obs, var):
    """The leading arguments of ``daltonng_fused_batch(_grad)`` for gradient
    fixture ``name`` over the lanes ``thetas``, ``inits`` (on their device):
    its observations as one datum per block, Gaussian of variance ``var``
    in derivative 0 (``obs_dims`` (0,))."""
    from rodeo_tpu_torch.models import obs as obs_models
    model = GRAD_FIXTURES[name][0]
    cfg = grad_config(name, torch.float32, thetas.device)
    return (thetas, cfg["ode_weight"], inits, cfg["t_min"], cfg["t_max"],
            cfg["n_steps"], cfg["prior_pars"], obs["obs_data"],
            obs["obs_times"], obs_models.gauss(var), (0,), model)


def daltonng_float64(name, mode, theta, init, obs, var, device):
    """The float64 torch-op ``ops.precond.daltonng`` of gradient fixture
    ``name`` under ``mode`` at one lane's ``theta`` and ``init`` on
    ``device``, with its ``torch.autograd`` gradient in theta: ``(value,
    grad)``, grad a list (zeros for Chkrebtii's ODE, which has no
    parameter)."""
    from rodeo_tpu_torch import interrogate
    from rodeo_tpu_torch.ops import precond
    model = GRAD_FIXTURES[name][0]
    cfg = grad_config(name, torch.float64, device)
    cfg["ode_init"] = init.to(device, torch.float64)

    def obs_loglik_i(o, s, i, **params):
        return torch.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2 / var)

    th = theta.to(device, torch.float64).clone().requires_grad_(True)
    value = precond.daltonng(
        key=None, interrogate=getattr(interrogate, f"interrogate_{mode}"),
        obs_data=obs["obs_data"].to(device, torch.float64),
        obs_times=obs["obs_times"].to(torch.float64),
        obs_loglik_i=obs_loglik_i, **cfg,
        **({} if model == "chkrebtii" else {"theta": th}))
    if model == "chkrebtii":
        return float(value.detach()), [0.0]
    value.backward()
    return float(value.detach()), th.grad.tolist()


def daltonng_float64_twins(args, mode, tangent=True):
    """Non-Gaussian DALTON's log-likelihood and its gradient by the entries'
    own code with every kernel replaced by its plain twin (K9's or K11d's,
    K2r's or K11e's, K1's or K11a's) and every operand widened to float64
    after the entry forms its float32 operands: ``daltonng_fused_batch_grad``
    (``daltonng_fused_batch`` with ``tangent`` False, grad None) on
    daltonng_args' ``args``, on their device.  The kernels are bitwise the
    float32 twins; this is the same arithmetic without float32's rounding,
    the witness of the result where float32 does not resolve it."""
    from unittest import mock

    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    from rodeo_tpu_torch.ops import fused_kalman as fk

    def wide(tree):
        return {k: v.double() if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v for k, v in tree.items()}

    float32_prepare = fdn._daltonng_prepare

    def prepare(*a):
        ops, grid, obs_ind, y_obs = float32_prepare(*a)
        return wide(ops), wide(grid), obs_ind, y_obs.double()

    with mock.patch.multiple(
            fdn, _daltonng_prepare=prepare,
            filter_nn_batch=fdn._filter_nn_batch_plain,
            filter_nn_batch_tan=fdn._filter_nn_batch_tan_plain,
            smoother_recursion_batch_rows=fk._smoother_batch_rows_plain,
            fused_filter_batch=fk._filter_batch_plain,
            smoother_mean_recursion_batch_tan=fk._smoother_mean_tan_plain,
            fused_filter_batch_tan=fk._filter_batch_tan_plain):
        if tangent:
            return fdn.daltonng_fused_batch_grad(*args, interrogation=mode,
                                                 device=args[0].device)
        return fdn.daltonng_fused_batch(*args, interrogation=mode,
                                        device=args[0].device), None


def daltonng_worker_init():
    """The start of a worker process that runs daltonng_float64 or
    daltonng_lane0_twins: one intra-op thread (the processes run beside
    each other and the caller) and the package's modules imported."""
    torch.set_num_threads(1)
    from rodeo_tpu_torch import interrogate  # noqa: F401
    from rodeo_tpu_torch.ops import fused_daltonng, precond  # noqa: F401


def daltonng_lane0_twins(name, mode, theta, init, obs, var):
    """daltonng_float64_twins of gradient fixture ``name`` under ``mode`` on
    one lane, ``theta`` and ``init`` (float32, on the CPU, with the
    observations ``obs`` of variance ``var``), as a worker process runs it:
    ``(value (1,), grad (1, n_theta))``, float64 (grad None on Chkrebtii's
    ODE, which has no parameter)."""
    chk = GRAD_FIXTURES[name][0] == "chkrebtii"
    return daltonng_float64_twins(
        daltonng_args(name, theta[None], init[None], obs, var), mode,
        tangent=not chk)


def daltonng_errors(device, n_lane=4, nan_lanes=2048):
    """For each gradient fixture and mode, lane 0's float32
    ``daltonng_fused_batch_grad`` on ``device`` against the float64 torch-op
    (daltonng_float64): the absolute error of the value and the relative L2
    error of the gradient (bench.py's audit_grad), which chip_smoke.py keeps
    as ``DALTONNG_F32_CPU_ERR``; the same of the twins in float64 on lane
    0's float32 operands (daltonng_float64_twins, the value alone on
    Chkrebtii's ODE), the witness where float32 does not resolve the
    result; the float64 values; and the lanes of the float32
    ``daltonng_fused_batch`` at ``nan_lanes`` lanes that are not finite
    (chip_smoke.py's lanes)."""
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    out = {}
    for name in GRAD_FIXTURES:
        model = GRAD_FIXTURES[name][0]
        _, (thetas, inits), obs, var = grad_fixture(name, n_lane,
                                                    torch.float32, device)
        _, (thetas_w, inits_w), _, _ = grad_fixture(name, nan_lanes,
                                                    torch.float32, device)
        for mode in VALUE_MODES:
            t0 = time.perf_counter()
            ref = daltonng_float64(name, mode, thetas[0], inits[0], obs, var,
                                   device)
            ll, g = fdn.daltonng_fused_batch_grad(
                *daltonng_args(name, thetas, inits, obs, var),
                interrogation=mode, device=device)
            v64, g64 = daltonng_lane0_twins(name, mode, thetas[0], inits[0],
                                            obs, var)
            wide_ll = fdn.daltonng_fused_batch(
                *daltonng_args(name, thetas_w, inits_w, obs, var),
                interrogation=mode, device=device)
            out[f"{name}/{mode}"] = {
                "float64": ref,
                "float32": _grad_errs(ll[0], g[0].double().cpu(), ref),
                "f64_twins": _grad_errs(v64[0], [0.0] if g64 is None
                                        else g64[0].cpu(), ref),
                "nonfinite_lanes": int((~torch.isfinite(wide_ll)).sum()),
                "seconds": time.perf_counter() - t0}
            print(json.dumps({f"{name}/{mode}": out[f"{name}/{mode}"]}),
                  file=sys.stderr, flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", default=None)
    parser.add_argument("--parts", default="solve,value,lanes,grad")
    args = parser.parse_args()
    parts = args.parts.split(",")
    sys.path.insert(0, str(REPO))
    out = {"device": args.device}
    t0 = time.perf_counter()
    if "solve" in parts:
        for name in FIXTURES:
            out[name] = max_err_x(float32_call(name, args.device)(),
                                  float64_solve(name, args.device))
    if "value" in parts:
        out["value"] = value_errors(args.device)
    if "lanes" in parts:
        # chip_smoke.py's SIM_VAR_MIN and SIM_SD_REL
        out["lanes"] = lane_readings(args.device, 1e-8, 1e-4)
    if "grad" in parts:
        out["grad"] = grad_errors(args.device)
    if "daltonng" in parts:
        out["daltonng"] = daltonng_errors(args.device)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
