#!/usr/bin/env python3
"""
The pointwise audits of chip_smoke.py's coverage phase: the fused solves of
the configurations that the kernels K1, K3, K2r and K4 took last (the
Chkrebtii ODE at q = 4 and 5, Hes1, SEIRAH, schober), held to the port's
float64 torch-op solve (ops.precond.solve_mv), and their float32 errors on
the CPU, which set the audits' tolerances.

    python3 tools/torch_coverage_reference.py [--device cpu] [--out FILE]

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

Prints one JSON line: for each fixture, the largest error of the float32
solve's x (the mean's 0th derivative, every step and block) against the
float64 torch-op solve, the solve run by ``solve_mv_fused`` on ``--device``
(the CPU: the kernels' plain twins).  chip_smoke.py holds the card's fused
solves to the float64 torch-op on the card within max(3 x these CPU errors,
1e-3), bench.py's rule for FitzHugh-Nagumo (``bench.py:1948-1956``), and
keeps the errors as ``COVERAGE_F32_CPU_ERR``.
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


def new_filter_instances():
    """The (model functor, mode, q) instances of K1 and K3 but the first
    four (kramer and rodeo on Lorenz63 and FitzHugh-Nagumo at q = 3), in
    order of q, functor and mode."""
    from rodeo_tpu_torch.ops import fused_kalman as fk
    first = {(m, md, 3) for m in ("Lorenz63", "FitzHughNagumo")
             for md in ("kramer", "rodeo")}
    return sorted(fk._INSTANCES["filter_batch"] - first,
                  key=lambda k: (k[2], k[0], k[1]))


def instance_case(functor, mode, q, n_lane, device, seed):
    """The operands of the bitwise check of one instance (``functor``,
    ``mode``, ``q``) on ``device``: ``n_lane`` lanes of the functor's
    INSTANCE_CHECKS setup, thetas 1 % apart, and under chkrebtii its
    standard normals, drawn with numpy seed ``seed``.  Returns a dict:
    ``fused`` (the FusedModel), ``n_steps``, ``cfg`` (the setup, theta
    popped out), ``config`` (the check's row for a report), ``batch`` (K1's
    operands as fused_filter_batch's keywords, ``eps`` included) and
    ``single`` (lane 0's, as fused_filter's)."""
    import importlib

    import numpy as np

    from rodeo_tpu_torch.ops import fused_kalman as fk
    model, n, t_max, sigma = INSTANCE_CHECKS[functor]
    if functor == "Lorenz63" and mode == "chkrebtii":
        sigma = CHKREBTII_SIGMA
    mod = importlib.import_module(f"rodeo_tpu_torch.models.{model}")
    cfg = mod.setup(n_steps=n, t_max=t_max, prior_sigma=sigma,
                    dtype=torch.float32, device=device,
                    **({"n_deriv": q} if model == "chkrebtii" else {}))
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    out = {"device": args.device}
    t0 = time.perf_counter()
    for name in FIXTURES:
        out[name] = max_err_x(float32_call(name, args.device)(),
                              float64_solve(name, args.device))
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
