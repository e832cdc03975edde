#!/usr/bin/env python3
"""
Time kernels K6 (sampler_batch) and K11d (filter_nn_batch_tan) of
rodeo_tpu_torch against the same kernels built from other checkouts'
sources, on one NVIDIA GPU, in turns, on the same inputs.

    python3 tools/torch_kernel_turns.py --other DIR [DIR ...]
        [--kernels {sampler_batch,filter_nn_batch_tan} ...] [--out PATH]

Each DIR is the root of another checkout of the repository (for example the
parent commit unpacked with ``git archive``) whose kernels keep the C entry
points ``rodeo_sampler_batch`` and ``rodeo_filter_nn_batch_tan``.  All
kernel libraries are built with ``nvcc`` and loaded into one process; the
wrappers of this checkout launch any of them.  Inputs are the main paths'
of ``chip_smoke.py``: K6 on the draw operands of Lorenz63 EK1, 10 000 steps
x 2048 lanes (phase ``sim``), K11d on non-Gaussian DALTON's fixture,
Lorenz63 EK1, 4000 steps x 2048 lanes, 21 observations of rng(1).normal x
5, Gaussian variance 0.005 (phase ``daltonng_kernels``).  Each kernel is
timed in three rounds of this checkout's library, then each other's, each
time the median device time of 5 launches by CUDA events (a sleep holds the
stream while the host enqueues the wrapper), and every library's output
must agree bitwise with this checkout's.  Prints the card's name and power
limit, ptxas' report of both kernels in every library, and one JSON line
per kernel, also written to ``--out`` (default build/kernel_turns.jsonl).
Exits non-zero without a CUDA device, or if two outputs differ.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TURNS = 3
REPEATS = 5
HOLD_CYCLES = 20_000_000       # ~10 ms of sleep at the H100's clocks
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM device memory


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, nargs="+")
    parser.add_argument("--kernels", nargs="+",
                        choices=["sampler_batch", "filter_nn_batch_tan"],
                        default=["sampler_batch", "filter_nn_batch_tan"])
    parser.add_argument("--out", default=str(REPO / "build"
                                             / "kernel_turns.jsonl"))
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_turns.py: no CUDA device", file=sys.stderr)
        return 1
    from rodeo_tpu_torch.models import lorenz
    from rodeo_tpu_torch.models import obs as obs_models
    from rodeo_tpu_torch.ops import _build
    from rodeo_tpu_torch.ops import fused_daltonng as fdn
    from rodeo_tpu_torch.ops import fused_kalman as fk
    from rodeo_tpu_torch.ops import fused_sim as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")

    # the libraries: this checkout's, then each other's (_build.load
    # pointed at the other sources and a build directory of their own,
    # declaring only the two entry points timed here), named by directory
    libs = {"this": _build.load()}
    logs = {"this": _build.build_log() or ""}
    here = (_build.CSRC, _build.BUILD_DIR, _build._SIGNATURES)
    _build._SIGNATURES = {k: here[2][k] for k in (
        "rodeo_sampler_batch", "rodeo_filter_nn_batch_tan")}
    for other in args.other:
        root = Path(other).resolve()
        _build.CSRC = root / "rodeo_tpu_torch" / "ops" / "csrc"
        _build.BUILD_DIR = here[1] / "other" / root.name
        _build.load.cache_clear()
        libs[root.name] = _build.load()
        logs[root.name] = _build.build_log() or ""
    _build.CSRC, _build.BUILD_DIR, _build._SIGNATURES = here
    _build.load.cache_clear()
    assert _build.load() is not None
    loader = _build.load
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (
                    "sampler_batch_kernel" in line
                    or "filter_nn_batch_tan" in line):
                print(name, " | ".join(x.strip() for x in lines[i:i + 4]
                                       if "Compiling" in x or "spill" in x
                                       or "registers" in x), flush=True)

    def device_ms(fn):
        fn()
        times = []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def turns(name, fn, n_bytes):
        times, equal, first = [], {}, None
        try:
            for _ in range(TURNS):
                for which in libs:
                    _build.load = lambda which=which: libs[which]
                    times.append((which, device_ms(fn)))
                    if which not in equal:
                        out = fn()
                        out = out if isinstance(out, tuple) else (out,)
                        first = first or out
                        equal[which] = all(torch.equal(a, b)
                                           for a, b in zip(out, first))
                        del out
        finally:
            _build.load = loader
        torch.cuda.synchronize()
        ms = {w: statistics.median(t for v, t in times if v == w)
              for w in libs}
        line = {"kernel": name, "card": smi, "turns": times,
                "median_ms": ms, "bytes": n_bytes,
                "bytes_per_s": {w: 1e3 * n_bytes / t for w, t in ms.items()},
                "share_of_3.35TB/s": {w: 1e3 * n_bytes / t / PEAK_BYTES_PER_S
                                      for w, t in ms.items()},
                "bitwise_equal": equal}
        print(json.dumps(line), flush=True)
        return line

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def lanes(n_steps, n_lane):
        cfg = lorenz.setup(n_steps=n_steps, t_max=20.0, dtype=torch.float32,
                           device=dev)
        index = torch.arange(n_lane, dtype=torch.float32, device=dev)
        thetas = cfg["theta"].expand(n_lane, 3) * (1 + 1e-6 * index[:, None])
        inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
        return cfg, thetas, inits

    def time_sampler():
        """K6 on the sampler's operands."""
        n_s, b_s = 10000, 2048
        cfg, thetas, inits = lanes(n_s, b_s)
        ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0,
                                  20.0, n_s, cfg["prior_pars"])
        gen = torch.Generator(dev).manual_seed(6)
        eps = torch.randn((n_s - 1, 3, 3, b_s), generator=gen, device=dev)
        eps_term = torch.randn((3, 3, b_s), generator=gen, device=dev)
        k6_args = fs._draw_operands(fk.resolve_model("lorenz"), n_s, ops,
                                    "kramer", eps, eps_term)
        del ops, eps, eps_term
        line = turns("sampler_batch", lambda: fs.sampler_batch(*k6_args),
                     nbytes(*k6_args) + nbytes(k6_args[0]))
        del k6_args
        torch.cuda.empty_cache()
        return line

    def time_nn_tan():
        """K11d on non-Gaussian DALTON's fixture."""
        n_ng, b_ng = 4000, 2048
        cfg, thetas, inits = lanes(n_ng, b_ng)
        data = np.random.default_rng(1).normal(size=(21, 3, 1)) * 5
        ops_ng, grid_ng, _, _ = fdn._daltonng_prepare(
            thetas, cfg["ode_weight"], inits, 0.0, 20.0, n_ng,
            cfg["prior_pars"], torch.tensor(data, dtype=torch.float32),
            torch.tensor(np.linspace(0.0, 20.0, 21), dtype=torch.float32))
        nn_args = (fk.resolve_model("lorenz"), obs_models.gauss(0.005),
                   (0,), n_ng)
        operands = [v for v in {**ops_ng, **grid_ng}.values()
                    if isinstance(v, torch.Tensor)]
        out_bytes = n_ng * 4 * (3 + 6 + 3 + 6) * 3 * b_ng * 4
        return turns(
            "filter_nn_batch_tan",
            lambda: fdn.filter_nn_batch_tan(*nn_args, **ops_ng, **grid_ng,
                                            mode="kramer"),
            nbytes(*operands) + out_bytes)

    timed = {"sampler_batch": time_sampler,
             "filter_nn_batch_tan": time_nn_tan}
    lines = [timed[name]() for name in args.kernels]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0 if all(all(line["bitwise_equal"].values())
                    for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
