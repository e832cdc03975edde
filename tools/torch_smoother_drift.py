#!/usr/bin/env python3
"""
Float32 rounding of the single-solve smoothers of rodeo_tpu_torch on one
NVIDIA GPU: does the plain reverse recursion drift over long horizons, as
the JAX package's k-step composition guards against?

    python3 tools/torch_smoother_drift.py [--out PATH]

For each configuration (model, interrogation, steps, horizon, seed) the
single-solve filter K3 runs once on the card.  On its float32 filter states
three smoothers run: the plain recursion (``fused_smoother``, kernel K4 over
every step), the composed one (``fused_smoother_composed``, k = 16, K4 over
the groups' boundary steps), and, as the reference, the plain recursion in
float64 on the CPU on the same states cast to float64.  The difference to the
reference is the smoother's own float32 rounding, apart from the filter's.
Seed 0 is the model's published theta; seed s > 0 multiplies it by
(1 + 0.01 N(0, 1)) drawn from numpy's generator s.

Per configuration and smoother it prints one JSON line: the largest error of
the mean's 0th derivative in original coordinates, the same over the first
and the last tenth of the rows (a drift grows away from the seed at the
last row, towards row 0), the largest scaled error of the mean and of the
packed covariance (over max |reference| per entry), and the smoother's
median time on the card by CUDA events.  The card's name and power limit
come first; the lines are also written to ``--out`` (default
build/smoother_drift.jsonl).  Exits non-zero without a CUDA device.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

# (model, interrogation, steps, t_max, seeds): the chip_smoke.py solve's
# step size on Lorenz63 (10 000 steps to t = 20) and bench.py's on
# FitzHugh-Nagumo (800 steps to t = 10), each at 10 000 steps and over a
# five times longer horizon
CONFIGS = [
    ("lorenz", "kramer", 10000, 20.0, (0, 1, 2)),
    ("lorenz", "kramer", 50000, 100.0, (0,)),
    ("fitzhugh", "kramer", 10000, 125.0, (0, 1, 2)),
    ("fitzhugh", "rodeo", 10000, 125.0, (0,)),
    ("fitzhugh", "kramer", 50000, 625.0, (0,)),
]
K_COMPOSE = 16


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(REPO / "build"
                                             / "smoother_drift.jsonl"))
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("torch_smoother_drift.py: no CUDA device", file=sys.stderr)
        return 1
    from rodeo_tpu_torch.models import fitzhugh, lorenz
    from rodeo_tpu_torch.ops import fused_kalman as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__})

    def cuda_ms(fn, repeats=3):
        fn()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def reference(Qs, R, mf, pf, mp, pp, mfN, pfN):
        """The plain recursion in float64 on the CPU."""
        c64 = [a.cpu().double() for a in (Qs, R, mf, pf, mp, pp, mfN, pfN)]
        return fk._smoother_single_plain(*fk._smoother_gains(*c64[:6]),
                                         *c64[6:])

    def errors(ms, ps, ms64, ps64, t_vec):
        ms, ps = ms.cpu().double(), ps.cpu().double()
        err0 = (ms[..., 0] - ms64[..., 0]).abs() * float(t_vec[0])
        tenth = max(1, ms.shape[0] // 10)
        scaled_m = max(((ms[..., d] - ms64[..., d]).abs().max()
                        / ms64[..., d].abs().max()).item()
                       for d in range(ms.shape[-1]))
        scaled_p = max(((ps[..., k] - ps64[..., k]).abs().max()
                        / ps64[..., k].abs().max()).item()
                       for k in range(ps.shape[-1]))
        return {"mean_d0_max_abs_err": err0.max().item(),
                "mean_d0_err_first_tenth": err0[:tenth].max().item(),
                "mean_d0_err_last_tenth": err0[-tenth:].max().item(),
                "mean_scaled_err": scaled_m, "cov_scaled_err": scaled_p}

    mods = {"lorenz": lorenz, "fitzhugh": fitzhugh}
    for model, mode, n_steps, t_max, seeds in CONFIGS:
        for seed in seeds:
            cfg = mods[model].setup(n_steps=n_steps, t_max=t_max,
                                    dtype=torch.float32, device=dev)
            theta = cfg["theta"]
            if seed:
                noise = np.random.default_rng(seed).standard_normal(3)
                theta = theta * (1 + 0.01 * torch.tensor(
                    noise, dtype=torch.float32, device=dev))
            ops, Qs = fk._single_operands(theta, cfg["ode_weight"],
                                          cfg["ode_init"], 0.0, t_max,
                                          n_steps, cfg["prior_pars"])
            fused = fk.resolve_model(model)
            mf, pf, mp, pp = fk.fused_filter(fused, n_steps, **ops,
                                             mode=mode)
            states = (ops["prior_var"], mf[:-1], pf[:-1], mp[1:], pp[1:],
                      mf[-1], pf[-1])
            finite = bool(torch.isfinite(mf).all() and
                          torch.isfinite(pf).all())
            ms64, ps64 = reference(Qs, *states)
            runs = {
                "plain": lambda: fk.fused_smoother(Qs, *states),
                "composed": lambda: fk.fused_smoother_composed(
                    ops["q_const"], *states, k_compose=K_COMPOSE),
            }
            for name, run in runs.items():
                ms, ps = run()
                emit({"model": model, "interrogation": mode,
                      "n_steps": n_steps, "t_max": t_max, "seed": seed,
                      "filter_finite": finite, "smoother": name,
                      "k_compose": K_COMPOSE if name == "composed" else 1,
                      **errors(ms, ps, ms64, ps64, ops["t_vec"]),
                      "smoother_ms": cuda_ms(run)})
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
