#!/usr/bin/env python3
"""
The float64 torch-op likelihoods of rodeo_tpu_torch on bench.py's fixtures,
held to the cached float64 truth of the JAX package (.bench_ref_v8.npz).

    python3 tools/torch_op_reference.py [--device cpu] [--out FILE]

Runs ops.precond.fenrir, ops.precond.dalton and ops.precond.basic on the
likelihood fixture (Lorenz63 EK1, 4000 steps to t = 20, 21 observations of
x, y and z with variance 0.005; data rng(0) x 5 for fenrir and DALTON,
rng(1) x 5 for basic), each with its torch.autograd gradient in theta, and
ops.precond.basic on the FitzHugh-Nagumo control (800 steps to t = 10, 21
observations, data rng(2)).  Prints one JSON line: each value's relative
error against the cache's fenrir_ll, dalton_ll, basic_ll and basic_fitz_ll,
and each gradient's relative L2 error against fenrir_grad, dalton_grad and
basic_grad.  chip_smoke.py's torch_op phase runs the same fixtures on the
card through likelihood_calls().
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]

N_OBS = 21
OBS_VAR = 0.005


def _obs_times(t_max):
    """jnp.linspace(0, t_max, N_OBS) in float64, as bench.py's truth used."""
    from rodeo_tpu_torch.ops.obs_grid import _solver_grid
    return torch.from_numpy(_solver_grid(0.0, t_max, N_OBS - 1))


def likelihood_calls(device):
    """The float64 value-and-gradient calls of bench.py's likelihood
    fixtures on ``device``: ``{name: call}``, each call returning
    ``(value, gradient)`` (the gradient ``None`` for basic_fitz, whose
    cache holds no gradient)."""
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.models import fitzhugh, lorenz
    from rodeo_tpu_torch.ops import precond

    f64 = dict(dtype=torch.float64, device=device)
    cfg = lorenz.setup(n_steps=4000, t_max=20.0, dtype=torch.float64,
                       device=device)
    theta = cfg.pop("theta")
    weight = torch.zeros((N_OBS, 3, 1, 3), **f64)
    weight[..., 0] = 1.0
    gauss = dict(obs_times=_obs_times(20.0), obs_weight=weight,
                 obs_var=torch.full((N_OBS, 3, 1, 1), OBS_VAR, **f64))

    def data(seed, shape, scale):
        return torch.tensor(np.random.default_rng(seed).normal(size=shape)
                            * scale, **f64)

    y_f = data(0, (N_OBS, 3, 1), 5.0)
    y_b = data(1, (N_OBS, 3, 1), 5.0)

    def b_loglik(obs_data, ode_data, **params):
        return torch.sum(-0.5 * (obs_data[..., 0] - ode_data[..., 0]) ** 2)

    def value_and_grad(fn, th):
        th = th.clone().requires_grad_(True)
        val = fn(th)
        (grad,) = torch.autograd.grad(val, th)
        return val.detach(), grad

    def fenrir(th):
        return precond.fenrir(key=None, interrogate=interrogate_kramer,
                              theta=th, obs_data=y_f, **gauss, **cfg)

    def dalton(th):
        return precond.dalton(key=None, interrogate=interrogate_kramer,
                              theta=th, obs_data=y_f, **gauss, **cfg)

    def basic(th):
        return precond.basic(key=None, interrogate=interrogate_kramer,
                             theta=th, obs_data=y_b,
                             obs_times=gauss["obs_times"],
                             obs_loglik=b_loglik, **cfg)[0]

    cfg_fh = fitzhugh.setup(n_steps=800, t_max=10.0, dtype=torch.float64,
                            device=device)
    th_fh = cfg_fh.pop("theta")
    y_fh = data(2, (N_OBS, 2, 1), 1.0)

    def basic_fitz():
        with torch.no_grad():
            val = precond.basic(key=None, interrogate=interrogate_kramer,
                                theta=th_fh, obs_data=y_fh,
                                obs_times=_obs_times(10.0),
                                obs_loglik=b_loglik, **cfg_fh)[0]
        return val, None

    return {"fenrir": lambda: value_and_grad(fenrir, theta),
            "dalton": lambda: value_and_grad(dalton, theta),
            "basic": lambda: value_and_grad(basic, theta),
            "basic_fitz": basic_fitz}


def errors(name, value, grad, truth):
    """The value's relative error against the cache's ``{name}_ll`` and the
    gradient's relative L2 error against ``{name}_grad``."""
    ref = float(truth[f"{name}_ll"])
    out = {"value": float(value), "ref": ref,
           "value_rel_err": abs(float(value) - ref) / abs(ref)}
    if grad is not None:
        g_ref = np.asarray(truth[f"{name}_grad"], np.float64)
        g = grad.detach().cpu().numpy()
        out.update(grad=g.tolist(), grad_ref=g_ref.tolist(),
                   grad_rel_err=float(np.linalg.norm(g - g_ref)
                                      / np.linalg.norm(g_ref)))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    truth = np.load(REPO / ".bench_ref_v8.npz")
    result = {"device": args.device, "dtype": "float64"}
    for name, call in likelihood_calls(args.device).items():
        t0 = time.perf_counter()
        value, grad = call()
        result[name] = errors(name, value, grad, truth)
        result[name]["seconds"] = time.perf_counter() - t0
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
