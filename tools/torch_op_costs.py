#!/usr/bin/env python3
"""
What two choices of the float64 torch-ops cost, and the spread of the draw
statistic that chip_smoke.py's torch_op phase holds Lorenz63's draws to.

    python3 tools/torch_op_costs.py [--device cuda] [--parts eigh,matmul]
                                    [--draws 12] [--out FILE]

Parts (comma-separated):

- ``eigh``: the peak memory and the time (CUDA events, median of 3) of
  ``torch.linalg.eigh`` over the 29 997 3 x 3 float64 covariances of a
  10 000-step Lorenz63 draw in one call and in chunks of 256, 1024 and 4096
  matrices, of ``ops.linalg.psd_factor_eigh`` on them (chunked by
  ``EIGH_CHUNK``), and of one ``ops.precond.solve_sim(method="eigh")`` draw
  at 10 000 steps with ``EIGH_CHUNK`` as it is and as large as the batch.
- ``matmul``: ``ops.precond.fenrir`` and ``ops.precond.dalton`` with their
  ``torch.autograd`` gradients on tools/torch_op_reference.py's fixture
  (Lorenz63 EK1, 4000 steps), with ``utils.matmul`` (one ``torch.bmm`` for
  two 3-D operands) and with ``torch.matmul`` in its place, in turns
  (port, plain, plain, port); whether the results are bitwise alike.
- ``spread``: ``--draws`` eigh draws of Lorenz63 at 10 000 steps from one
  seeded generator, each draw's mean of (x - mu)^2 / sigma^2 over the
  entries whose posterior variance exceeds 1e-8 (mu, sigma^2 from
  ``ops.precond.solve_mv``), and their mean and standard deviation.

Prints one JSON line.  Needs a card for ``eigh`` and ``matmul``; ``spread``
runs on any device.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
N_COV = 9999 * 3


def _timed(call, n=3):
    """The last output of n calls, the median ms by CUDA events and the
    peak memory in bytes above what was allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return out, statistics.median(ms), torch.cuda.max_memory_allocated() - base


def part_eigh(dev):
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.models import lorenz
    from rodeo_tpu_torch.ops import linalg, precond

    rng = np.random.default_rng(0)
    a = rng.standard_normal((N_COV, 3, 2))      # rank 2: one zero eigenvalue
    cov = torch.tensor(a @ np.swapaxes(a, -1, -2), dtype=torch.float64,
                       device=dev)
    out = {"n_matrices": N_COV, "eigh_chunk": linalg.EIGH_CHUNK}
    for chunk in (N_COV, 4096, 1024, 256):
        def call(chunk=chunk):
            return [torch.linalg.eigh(c) for c in cov.split(chunk)]
        _, ms, peak = _timed(call)
        out[f"eigh_chunk_{chunk}"] = {"ms": ms, "peak_bytes": peak}
    _, ms, peak = _timed(lambda: linalg.psd_factor_eigh(cov))
    out["psd_factor_eigh"] = {"ms": ms, "peak_bytes": peak}
    del cov

    cfg = lorenz.setup(n_steps=10000, t_max=20.0, dtype=torch.float64,
                       device=dev)
    theta = cfg.pop("theta")
    chunk = linalg.EIGH_CHUNK
    for name, size in (("chunked", chunk), ("whole", 10 ** 9)):
        linalg.EIGH_CHUNK = size
        gen = torch.Generator(dev).manual_seed(12)
        with torch.no_grad():
            x, ms, peak = _timed(lambda: precond.solve_sim(
                key=gen, interrogate=interrogate_kramer, theta=theta,
                method="eigh", **cfg), n=1)
        out[f"solve_sim_eigh_{name}"] = {
            "ms": ms, "peak_bytes": peak,
            "finite": bool(torch.isfinite(x).all())}
    linalg.EIGH_CHUNK = chunk
    return out


def part_matmul(dev):
    import rodeo_tpu_torch.kalmantv.standard as standard
    import rodeo_tpu_torch.utils as utils
    import torch_op_reference

    port = utils.matmul
    calls = torch_op_reference.likelihood_calls(dev)
    out = {}
    for name in ("fenrir", "dalton"):
        times = {"port": [], "plain": []}
        results = {}
        for which in ("port", "plain", "plain", "port"):
            fn = port if which == "port" else torch.matmul
            utils.matmul = standard.matmul = fn
            try:
                (value, grad), ms, _ = _timed(calls[name], n=1)
            finally:
                utils.matmul = standard.matmul = port
            times[which].append(ms)
            results.setdefault(which, (value, grad))
        same = all(torch.equal(a, b) for a, b in zip(results["port"],
                                                     results["plain"]))
        out[name] = {"ms_port": times["port"], "ms_plain": times["plain"],
                     "bitwise_alike": same}
    return out


def part_spread(dev, n_draws):
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.models import lorenz
    from rodeo_tpu_torch.ops import precond

    cfg = lorenz.setup(n_steps=10000, t_max=20.0, dtype=torch.float64,
                       device=dev)
    theta = cfg.pop("theta")
    with torch.no_grad():
        mu, var = precond.solve_mv(key=None, interrogate=interrogate_kramer,
                                   theta=theta, **cfg)
        var_d = torch.diagonal(var, dim1=-2, dim2=-1)
        live = var_d > 1e-8
        gen = torch.Generator(dev).manual_seed(7)
        stats = []
        for _ in range(n_draws):
            x = precond.solve_sim(key=gen, interrogate=interrogate_kramer,
                                  theta=theta, method="eigh", **cfg)
            z2 = (x - mu) ** 2 / torch.where(live, var_d,
                                             torch.ones_like(var_d))
            stats.append(float(z2[live].mean()))
    return {"n_draws": n_draws, "n_live_entries": int(live.sum()),
            "per_draw": stats, "mean": statistics.mean(stats),
            "stdev": statistics.stdev(stats) if n_draws > 1 else None}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--parts", default="eigh,matmul")
    parser.add_argument("--draws", type=int, default=12)
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    parts = args.parts.split(",")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("tools/torch_op_costs.py: no CUDA device", file=sys.stderr)
        return 1
    if {"eigh", "matmul"} & set(parts) and not args.device.startswith("cuda"):
        print("tools/torch_op_costs.py: eigh and matmul time the card",
              file=sys.stderr)
        return 1
    result = {"device": args.device}
    t0 = time.perf_counter()
    if "eigh" in parts:
        result["eigh"] = part_eigh(args.device)
    if "matmul" in parts:
        result["matmul"] = part_matmul(args.device)
    if "spread" in parts:
        result["spread"] = part_spread(args.device, args.draws)
    result["seconds"] = time.perf_counter() - t0
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
