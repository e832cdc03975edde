#!/usr/bin/env python3
"""
The MCMC fixture of bench.py's sections mcmc_fused, mala, hmc, nuts and
mcmc_xla (bench.py:1477-1721), for the port, and the agreement of its
gradient samplers.

    python3 tools/torch_mcmc_reference.py [--device cpu] [--sampler mala]
        [--out FILE]
    python3 tools/torch_mcmc_reference.py --agree FILE [FILE ...]

The fixture: FitzHugh-Nagumo, 200 steps to t = 10, theta from the setup,
the 21 observations y_fitz_mcmc of .bench_ref_v8.npz at every 10th step,
sigma_obs = 0.2; the gradient samplers run over fenrir_fused_batch_grad on
GRAD_LANES lanes from theta, each at a step size from a short
adapt_step_size (ADAPT), then MALA and HMC (5 leapfrog steps) for 100
steps and NUTS (max_depth 4) for 40 proposals (SAMPLERS).  With
``--sampler`` the script runs one sampler and prints one JSON line: its
adapted step, acceptance, seconds and summary() of its draws (each theta
component's mean, ESS and standard error).  With ``--agree`` it reads such
lines and prints agreement(): the largest pairwise distance of the
samplers' theta means in standard errors.  chip_smoke.py's phase mcmc runs
the same fixture and samplers on the card and holds that distance to
AGREE_Z.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

N_STEPS, T_MAX, SIGMA_OBS = 200, 10.0, 0.2
OBS_IDX = np.arange(0, N_STEPS + 1, 10)
GRAD_LANES = 128
# each sampler: its main run's length, its extra arguments, bench.py's
# candidate step nearest its target, and the acceptance it adapts to
SAMPLERS = {
    "mala": dict(n_samples=100, init_step=0.01, target=0.57, extra={}),
    "hmc": dict(n_samples=100, init_step=0.01, target=0.8,
                extra={"n_leapfrog": 5}),
    "nuts": dict(n_samples=40, init_step=0.01, target=0.8,
                 extra={"max_depth": 4}),
}
# the short adaptation: windows of ADAPT_WINDOW steps (proposals)
ADAPT_WINDOW, ADAPT_WINDOWS = 10, 5
# the agreement rule of the samplers' theta means, in standard errors
AGREE_Z = 5.0


def fixture(truth, device):
    """bench.py's MCMC fixture on ``device`` in float32: the solver
    configuration, theta, and fenrir's observation arguments."""
    from rodeo_tpu_torch.models import fitzhugh
    cfg = fitzhugh.setup(n_steps=N_STEPS, t_max=T_MAX, dtype=torch.float32,
                         device=device)
    theta = cfg.pop("theta")
    n_obs = len(OBS_IDX)
    weight = torch.zeros((n_obs, 2, 1, 3), device=device)
    weight[..., 0] = 1.0
    y = torch.tensor(truth["y_fitz_mcmc"], dtype=torch.float32,
                     device=device)
    obs = dict(obs_data=y[:, :, None],
               obs_times=(T_MAX * OBS_IDX / N_STEPS).astype(np.float32),
               obs_weight=weight,
               obs_var=torch.full((n_obs, 2, 1, 1), np.float32(SIGMA_OBS ** 2),
                                  device=device))
    return dict(cfg=cfg, theta=theta, obs=obs, y=y)


def path_loglik(fix):
    """bench.py's log-likelihood of each lane's sampled path (sec
    mcmc_fused): ``loglik(positions, paths)``."""
    idx = torch.as_tensor(OBS_IDX, device=fix["y"].device)
    y = fix["y"]

    def loglik(positions, paths):
        resid = paths[idx, :, 0, :] - y[:, :, None]
        return -0.5 * torch.sum(resid * resid, dim=(0, 1)) / SIGMA_OBS ** 2

    return loglik


def logpost_grad(fix, n_lane, likelihood="fenrir"):
    """The fused fenrir (or DALTON) value-and-gradient over ``n_lane``
    lanes (flat prior), the runners' ``logpost_grad_fn``."""
    from rodeo_tpu_torch.parallel.chains import _fused_theta_logpost_grad
    cfg = fix["cfg"]
    device = fix["theta"].device
    return _fused_theta_logpost_grad(
        likelihood, n_lane, cfg["ode_weight"], cfg["ode_init"], 0.0, T_MAX,
        N_STEPS, cfg["prior_pars"], fix["obs"]["obs_data"],
        fix["obs"]["obs_times"], fix["obs"]["obs_weight"],
        fix["obs"]["obs_var"], "fitzhugh", None, device)


def make_runner(name, lpg, n_lane, n_samples, step):
    from rodeo_tpu_torch.parallel import (make_hmc_runner, make_mala_runner,
                                          make_nuts_runner)
    make = {"mala": make_mala_runner, "hmc": make_hmc_runner,
            "nuts": make_nuts_runner}[name]
    return make(lpg, n_lane, n_samples, step, **SAMPLERS[name]["extra"])


def adapt(name, lpg, n_lane, init, generator):
    """The short adapt_step_size of a sampler from ``init``: its step size,
    warmed positions and final-window acceptance."""
    from rodeo_tpu_torch.parallel import adapt_step_size
    spec = SAMPLERS[name]
    runner = make_runner(name, lpg, n_lane, ADAPT_WINDOW, spec["init_step"])
    return adapt_step_size(runner, init, generator, spec["init_step"],
                           target_accept=spec["target"],
                           n_windows=ADAPT_WINDOWS)


def summary(positions):
    """Each theta component's mean over (samples x lanes), the port's
    multi-chain ESS of it, and the mean's standard error sd / sqrt(ESS)."""
    from rodeo_tpu_torch.parallel import ess
    x = np.asarray(positions.detach().cpu(), np.float64)
    n_eff = np.asarray(ess(x))
    flat = x.reshape(-1, x.shape[-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        se = flat.std(0) / np.sqrt(n_eff)
    return {"mean": flat.mean(0).tolist(), "ess": n_eff.tolist(),
            "se": se.tolist()}


def agreement(summaries):
    """The pairwise distances of the samplers' theta means, in standard
    errors sqrt(se_a^2 + se_b^2), per component, and the largest; the rule
    holds where it is at most AGREE_Z and every sampler's chains moved."""
    names = sorted(summaries)
    pairs = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            sa, sb = summaries[a], summaries[b]
            pairs[f"{a}-{b}"] = [
                abs(ma - mb) / float(np.hypot(ea, eb))
                for ma, mb, ea, eb in zip(sa["mean"], sb["mean"], sa["se"],
                                          sb["se"])]
    worst = max(max(z) for z in pairs.values())
    # a chain that never moved has no ESS and no standard error
    moved = all(np.isfinite(s["se"]).all() for s in summaries.values())
    return {"z": pairs, "max_z": worst, "rule": AGREE_Z,
            "ok": moved and worst <= AGREE_Z}


def run_sampler(name, device):
    """One sampler on the fixture: adaptation from theta, then its main
    run; returns its JSON record."""
    truth = np.load(REPO / ".bench_ref_v8.npz")
    fix = fixture(truth, device)
    lpg = logpost_grad(fix, GRAD_LANES)
    gen = torch.Generator(device).manual_seed(0)
    init = fix["theta"].expand(GRAD_LANES, 3).contiguous()
    t0 = time.perf_counter()
    step, pos, acc_adapt = adapt(name, lpg, GRAD_LANES, init, gen)
    t1 = time.perf_counter()
    positions, ll, acc = make_runner(
        name, lpg, GRAD_LANES, SAMPLERS[name]["n_samples"], step)(pos, gen)
    t2 = time.perf_counter()
    return {"sampler": name, "device": str(device), "lanes": GRAD_LANES,
            "step": float(step), "adapt_accept": acc_adapt,
            "accept": float(acc.mean()), "adapt_s": t1 - t0,
            "run_s": t2 - t1, "finite": bool(torch.isfinite(ll).all()),
            **summary(positions)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--sampler", choices=sorted(SAMPLERS))
    parser.add_argument("--agree", nargs="+", default=None)
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    if args.agree:
        records = [json.loads(Path(p).read_text()) for p in args.agree]
        result = agreement({r["sampler"]: r for r in records})
    elif args.sampler:
        result = run_sampler(args.sampler, torch.device(args.device))
    else:
        parser.error("give --sampler or --agree")
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
