#!/usr/bin/env python3
"""
The float32 condition of non-Gaussian DALTON's gradient on bench.py's
Lorenz63 fixture (EK1, 4000 steps to t = 20, 21 observations of
rng(1).normal x 5, Gaussian data of variance 0.005), apart from any float32
arithmetic: the float64 torch-op ops.precond.daltonng and its
torch.autograd gradient at theta and at theta rounded to float32 (lane 0 of
chip_smoke.py's daltonng phase), each against the cached float64 truth
``daltonng_grad`` of .bench_ref_v8.npz, relative L2.  chip_smoke.py states
the second as GRAD_THETA_ROUNDING["daltonng"].

    python3 tools/daltonng_theta_rounding.py

Runs on the CPU in float64 (a few minutes); prints one JSON line.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from rodeo_tpu_torch.interrogate import interrogate_kramer  # noqa: E402
from rodeo_tpu_torch.models import lorenz  # noqa: E402
from rodeo_tpu_torch.ops import precond  # noqa: E402


def main():
    truth = np.load(REPO / ".bench_ref_v8.npz")
    n_steps, t_max, n_obs = 4000, 20.0, 21
    cfg = lorenz.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float64,
                       device="cpu")
    theta = cfg.pop("theta")
    y = torch.tensor(np.random.default_rng(1).normal(size=(n_obs, 3, 1)) * 5)
    times = torch.linspace(0.0, t_max, n_obs, dtype=torch.float64)

    def loglik(o, s, i, **p):
        return torch.sum(-0.5 * (o[:, 0] - s[:, 0]) ** 2 / 0.005)

    ref = np.asarray(truth["daltonng_grad"], np.float64)
    out = {"n_steps": n_steps, "truth_ll": float(truth["daltonng_ll"])}
    for name, th in (("theta", theta),
                     ("theta_f32", theta.float().double())):
        t0 = time.perf_counter()
        th = th.clone().requires_grad_(True)
        ll = precond.daltonng(key=None, interrogate=interrogate_kramer,
                              theta=th, obs_data=y, obs_times=times,
                              obs_loglik_i=loglik, **cfg)
        (grad,) = torch.autograd.grad(ll, th)
        grad = grad.numpy()
        out[name] = {"ll": ll.item(), "grad": grad.tolist(),
                     "grad_rel_to_truth": float(np.linalg.norm(grad - ref)
                                                / np.linalg.norm(ref)),
                     "seconds": time.perf_counter() - t0}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
