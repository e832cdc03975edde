#!/usr/bin/env python3
"""
Time kernels of rodeo_tpu_torch against the same kernels built from other
checkouts' sources, on one NVIDIA GPU, in turns, on the same inputs: K1
(filter_batch), K2r (smoother_batch_rows), K3 (filter_single), K4
(smoother_single), K6 (sampler_batch), K7b (fenrir_backward_batch), K7a
(fenrir_backward_single), K9 (filter_nn_batch), K11b
(fenrir_backward_batch_tan), K11d (filter_nn_batch_tan), K10a
(magi_batch, both emits), K10b (magi_adjoint_batch) and K5a, K5b and K5c
(mean_gain_single, mean_boundary_single, mean_recovery_single).

    python3 tools/torch_kernel_turns.py --other DIR [DIR ...]
        [--kernels {filter_batch,smoother_batch_rows,filter_single,
                    smoother_single,sampler_batch,fenrir_backward_batch,
                    fenrir_backward_single,filter_nn_batch,
                    fenrir_backward_batch_tan,filter_nn_batch_tan,
                    magi_batch,magi_adjoint_batch,mean_gain_single,
                    mean_boundary_single,mean_recovery_single} ...]
        [--out PATH]

Each DIR is the root of another checkout of the repository (for example the
parent commit unpacked with ``git archive``, or a copy with a kernel's
constants changed) whose kernels keep the C entry points of the kernels
timed.  All kernel libraries are built with ``nvcc`` and loaded into one
process; the wrappers of this checkout launch any of them.  Inputs are the
main paths' of ``chip_smoke.py``, Lorenz63 EK1: K1 on the batched solve,
10 000 steps x 2048 lanes (phase ``main``); K2r on K1's gains there and at
4000 steps x 2048 lanes (``likelihood``); K3 on one solve of 10 000 and
4000 steps (``single``); K4 on that solve's gains, 9999 rows, and on the
boundary steps of its 16-step groups (``single``); K6 on the draw operands
of the solve (``sim``); K7b and K11b on fenrir's chain at 4000 steps x
2048 lanes, 21 observations of rng(0).normal x 5, variance 0.005
(``likelihood``, ``grad``); K7a on one fenrir evaluation of that fixture
(``single``); K9 and K11d on non-Gaussian DALTON's fixture, 4000 steps x
2048 lanes, 21 observations of rng(1).normal x 5, Gaussian variance 0.005
(``daltonng_kernels``); K10a, emits "ld" and "adjoint", on bench.py's MAGI
fixture, the cached Lorenz63 path plus 1e-4 x lane, 4000 steps x 2048
lanes, n_active 2, and K10b on K10a's adjoint streams there
(``magi_kernels``); K5b and K5c on the 10 000-step stationary solve's
9920-step tail after its 80-step K3 prefix, and K5a on its 150-step
horizon (``stationary_kernels``) and over all 10 000 steps (the
``two_phase=False`` schedule).  Each kernel is timed in three rounds of this
checkout's library, then each other's, each time the median device time
of 5 launches by CUDA events (a sleep holds the stream while the host
enqueues the wrapper), and every library's output must agree bitwise with
this checkout's.  Prints the card's name and power limit, ptxas' report of
the timed kernels in every library, the SASS instructions of K3's, K4's and
K5a-c's step loops in every library (``cuobjdump``, where the toolkit has it), and
one JSON line per kernel and shape, also written to ``--out`` (default
build/kernel_turns.jsonl).  Exits non-zero without a CUDA device, or if
two outputs differ.
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
# each kernel's C entry point and the mangled name of its kernel
KERNELS = {"filter_batch": "19filter_batch_kernel",
           "smoother_batch_rows": "26smoother_batch_rows_kernel",
           "filter_single": "20filter_single_kernel",
           "smoother_single": "22smoother_single_kernel",
           "sampler_batch": "20sampler_batch_kernel",
           "fenrir_backward_batch": "22fenrir_backward_kernel",
           "fenrir_backward_single": "29fenrir_backward_single_kernel",
           "filter_nn_batch": "22filter_nn_batch_kernel",
           "fenrir_backward_batch_tan": "26fenrir_backward_tan_kernel",
           "filter_nn_batch_tan": "26filter_nn_batch_tan_kernel",
           "magi_batch": "11magi_kernel",
           "magi_adjoint_batch": "19magi_adjoint_kernel",
           "mean_gain_single": "16mean_gain_kernel",
           "mean_boundary_single": "20mean_boundary_kernel",
           "mean_recovery_single": "20mean_recovery_kernel"}
# the kernels whose step loop is printed
SASS_KERNELS = ("filter_single", "smoother_single", "mean_gain_single",
                "mean_boundary_single", "mean_recovery_single")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True, nargs="+")
    parser.add_argument("--kernels", nargs="+", choices=list(KERNELS),
                        default=list(KERNELS))
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
    from rodeo_tpu_torch.ops import fused_fenrir as ff
    from rodeo_tpu_torch.ops import fused_kalman as fk
    from rodeo_tpu_torch.ops import fused_magi as fm
    from rodeo_tpu_torch.ops import fused_sim as fs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")

    # the libraries: this checkout's, then each other's (_build.load
    # pointed at the other sources and a build directory of their own,
    # declaring only the entry points timed here), named by directory
    libs = {"this": _build.load()}
    logs = {"this": _build.build_log() or ""}
    paths = {"this": _build._library_path()}
    here = (_build.CSRC, _build.BUILD_DIR, _build._SIGNATURES)
    _build._SIGNATURES = {f"rodeo_{k}": here[2][f"rodeo_{k}"]
                          for k in args.kernels}
    for other in args.other:
        root = Path(other).resolve()
        _build.CSRC = root / "rodeo_tpu_torch" / "ops" / "csrc"
        _build.BUILD_DIR = here[1] / "other" / root.name
        _build.load.cache_clear()
        libs[root.name] = _build.load()
        logs[root.name] = _build.build_log() or ""
        paths[root.name] = _build._library_path()
    _build.CSRC, _build.BUILD_DIR, _build._SIGNATURES = here
    _build.load.cache_clear()
    assert _build.load() is not None
    loader = _build.load
    symbols = [KERNELS[k] for k in args.kernels]
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(s in line for s in symbols):
                print(name, " | ".join(x.strip() for x in lines[i:i + 4]
                                       if "Compiling" in x or "spill" in x
                                       or "registers" in x), flush=True)
    for kernel in SASS_KERNELS:
        if kernel in args.kernels:
            for name, path in paths.items():
                print(json.dumps({"library": name, "kernel": kernel,
                                  "sass": _build.sass_loops(KERNELS[kernel],
                                                            path)}),
                      flush=True)

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

    def turns(name, fn, n_bytes, **info):
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
        line = {"kernel": name, "card": smi, **info, "turns": times,
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

    def time_nn(tangent):
        """K9 (or K11d) on non-Gaussian DALTON's fixture."""
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
        n_aug = 4 if tangent else 1
        out_bytes = n_ng * n_aug * (3 + 6 + 3 + 6) * 3 * b_ng * 4
        wrapper = fdn.filter_nn_batch_tan if tangent else fdn.filter_nn_batch
        return turns(
            wrapper.__name__,
            lambda: wrapper(*nn_args, **ops_ng, **grid_ng, mode="kramer"),
            nbytes(*operands) + out_bytes, shape=f"{n_ng} x {b_ng}")

    def solve_operands(n_s, b_s):
        """The batched solve's kernel operands."""
        cfg, thetas, inits = lanes(n_s, b_s)
        return fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0,
                                   20.0, n_s, cfg["prior_pars"])

    def time_filter_batch():
        """K1 on the batched solve, 10 000 x 2048."""
        n_s, b_s = 10000, 2048
        ops = solve_operands(n_s, b_s)
        fused = fk.resolve_model("lorenz")
        out_bytes = n_s * (9 + 3 + 6) * 3 * b_s * 4 + (3 + 6) * 3 * b_s * 4
        return [turns("filter_batch", lambda: fk.fused_filter_batch(
            fused, n_s, **ops, mode="kramer"),
            nbytes(*[v for v in ops.values() if isinstance(v, torch.Tensor)])
            + out_bytes, shape=f"{n_s} x {b_s}")]

    def time_rows():
        """K2r on K1's gains, 10 000 and 4000 steps x 2048 lanes."""
        out = []
        for n_s in (10000, 4000):
            ops = solve_operands(n_s, 2048)
            G, g, L, mN, pN = fk.fused_filter_batch(
                fk.resolve_model("lorenz"), n_s, **ops, mode="kramer")
            t_vec = ops["t_vec"]
            rows_args = (g[1:], G[1:], L[1:], mN, pN, ops["x0_lanes"],
                         t_vec, fk._tri_scale(t_vec))
            del G, g, L, mN, pN, ops
            out_bytes = (n_s + 1) * (3 + 6) * 3 * 2048 * 4
            out.append(turns(
                "smoother_batch_rows",
                lambda: fk.smoother_recursion_batch_rows(*rows_args),
                nbytes(*rows_args) + out_bytes, shape=f"{n_s} x 2048"))
            del rows_args
            torch.cuda.empty_cache()
        return out

    def time_single():
        """K3 on one solve of 10 000 and 4000 steps."""
        out = []
        for n_s in (10000, 4000):
            cfg = lorenz.setup(n_steps=n_s, t_max=20.0, dtype=torch.float32,
                               device=dev)
            ops, _ = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                         cfg["ode_init"], 0.0, 20.0, n_s,
                                         cfg["prior_pars"])
            fused = fk.resolve_model("lorenz")
            out_bytes = n_s * 3 * (3 + 6) * 2 * 4
            line = turns("filter_single", lambda: fk.fused_filter(
                fused, n_s, **ops, mode="kramer"),
                nbytes(*[v for v in ops.values()
                         if isinstance(v, torch.Tensor)]) + out_bytes,
                shape=f"{n_s} steps")
            line["us_per_step"] = {w: 1e3 * t / n_s
                                   for w, t in line["median_ms"].items()}
            print(json.dumps({"kernel": "filter_single",
                              "shape": f"{n_s} steps",
                              "us_per_step": line["us_per_step"]}),
                  flush=True)
            out.append(line)
        return out

    def single_states(n_s):
        """One solve of n_s steps through K3: its operands, the float32
        transition and the filter's moments."""
        cfg = lorenz.setup(n_steps=n_s, t_max=20.0, dtype=torch.float32,
                           device=dev)
        ops, Qs = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                      cfg["ode_init"], 0.0, 20.0, n_s,
                                      cfg["prior_pars"])
        return ops, Qs, fk.fused_filter(fk.resolve_model("lorenz"), n_s,
                                        **ops, mode="kramer")

    def time_smoother_single():
        """K4 on one solve's gains, 9999 rows, and on the boundary steps of
        its 16-step groups."""
        ops, Qs, (mf, pf, mp, pp) = single_states(10000)
        states = (mf[:-1], pf[:-1], mp[1:], pp[1:])
        comp, _ = fk._composed_suffixes(ops["q_const"], ops["prior_var"],
                                        *states, 16)
        out = []
        for gains, label in (
                (fk._smoother_gains(Qs, ops["prior_var"], *states), "rows"),
                (fk._boundary_operands(comp), "boundary groups of 16")):
            k4_args = (*gains, mf[-1], pf[-1])
            n_rows = k4_args[0].shape[0]
            out.append(turns(
                "smoother_single", lambda: fk.smoother_recursion(*k4_args),
                nbytes(*k4_args) + nbytes(k4_args[0], k4_args[2]),
                shape=f"{n_rows} {label}"))
        return out

    def fenrir_obs(n_obs, seed):
        """bench.py's observation model on Lorenz63 to t = 20."""
        weight = torch.zeros((n_obs, 3, 1, 3), device=dev)
        weight[..., 0] = 1.0
        data = np.random.default_rng(seed).normal(size=(n_obs, 3, 1)) * 5
        return (torch.tensor(data, dtype=torch.float32, device=dev),
                torch.tensor(np.linspace(0.0, 20.0, n_obs),
                             dtype=torch.float32),
                weight, torch.full((n_obs, 3, 1, 1), 0.005, device=dev))

    def time_fenrir(tangent):
        """K7b (or K11b) on fenrir's chain, 4000 steps x 2048 lanes."""
        n_f, b_f = 4000, 2048
        ops = solve_operands(n_f, b_f)
        chain = ff._fenrir_operands(fk.resolve_model("lorenz"), n_f, 0.0,
                                    20.0, ops, *fenrir_obs(21, 0), "kramer",
                                    tangent=tangent)
        del ops
        wrapper = (ff.fenrir_backward_batch_tan if tangent
                   else ff.fenrir_backward_batch)
        n_aug = chain[-1].shape[0] if tangent else 1
        line = turns(wrapper.__name__, lambda: wrapper(*chain),
                     nbytes(*chain) + 4 * n_aug * 3 * b_f,
                     shape=f"{n_f} x {b_f}")
        del chain
        torch.cuda.empty_cache()
        return [line]

    def time_fenrir_single():
        """K7a on one fenrir evaluation, 4000 steps."""
        ops, Qs, _ = single_states(4000)
        ops["q_const"] = ff._const_coefs(Qs)
        chain = ff._fenrir_single_operands(
            fk.resolve_model("lorenz"), 4000, 0.0, 20.0, ops, Qs,
            *fenrir_obs(21, 0), "kramer")
        return [turns("fenrir_backward_single",
                      lambda: ff.fenrir_backward_single(*chain),
                      nbytes(*chain) + 4 * 3, shape="4000 steps")]

    def magi_operands():
        """The operands of K10a on bench.py's MAGI fixture."""
        n_m, b_m, dt = 4000, 2048, 20.0 / 4000
        cfg = lorenz.setup(n_steps=n_m, t_max=20.0, dtype=torch.float32,
                           device=dev)
        mu = torch.tensor(np.load(REPO / ".bench_ref_v8.npz")["solve_mu_4k"],
                          dtype=torch.float32, device=dev)
        index = torch.arange(b_m, dtype=torch.float32, device=dev)
        subs = mu[None, :n_m + 1, :, :2] + 1e-4 * index[:, None, None, None]
        paths = torch.cat([subs, torch.zeros_like(subs[..., :1])], -1)
        return fm._magi_operands(paths, 2, cfg["prior_pars"], dt, None)

    def time_magi():
        """K10a on bench.py's MAGI fixture, 4000 steps x 2048 lanes, in
        both emits."""
        n_m, b_m = 4000, 2048
        q_const, _, R, x, m0 = magi_operands()
        out = []
        for emit in ("ld", "adjoint"):
            # ld (B,) and, with the adjoint, z, S^-1 and G: 2 + 3 + 2 rows
            out_bytes = 4 * b_m + (n_m * 7 * 3 * b_m * 4
                                   if emit == "adjoint" else 0)
            out.append(turns(
                "magi_batch", lambda: fm.magi_filter_batch(
                    x, R, m0, q_const, emit=emit),
                nbytes(x, R, m0) + out_bytes, shape=f"{n_m} x {b_m}",
                emit=emit))
        return out

    def time_magi_adjoint():
        """K10b on K10a's adjoint streams of the MAGI fixture."""
        q_const, _, R, x, m0 = magi_operands()
        _, *streams = fm.magi_filter_batch(x, R, m0, q_const, emit="adjoint")
        del R, x, m0
        # gx (4000, 2, 3, 2048) and lam0 (3, 3, 2048)
        out_bytes = nbytes(streams[0]) + 4 * 3 * 3 * 2048
        line = turns("magi_adjoint_batch",
                     lambda: fm.magi_adjoint_batch(*streams, q_const),
                     nbytes(*streams) + out_bytes, shape="4000 x 2048")
        del streams
        torch.cuda.empty_cache()
        return [line]

    def mean_chain_operands(n_s, t_max):
        """The mean chain's operands as solve_mv_fused_stationary builds
        them for one Lorenz63 EK1 solve of n_s steps to t_max: K5a's over
        the whole solve (the prefix's gains, then the frozen one), K5b's
        over the tail after the exact prefix."""
        cfg = lorenz.setup(n_steps=n_s, t_max=t_max, dtype=torch.float32,
                           device=dev)
        ops, _ = fk._single_operands(cfg["theta"], cfg["ode_weight"],
                                     cfg["ode_init"], 0.0, t_max, n_s,
                                     cfg["prior_pars"])
        fused = fk.resolve_model("lorenz")
        n_warm, _ = fk._stationary_schedule(n_s, 64, True)
        mfw, _, _, ppw = fk.fused_filter(
            fused, n_warm, **{**ops, "tgrid": ops["tgrid"][:n_warm]},
            mode="kramer")
        k_pre = fk._stationary_gains(fused, ops, ppw, "kramer", 0.0)
        chain = (fused, ops["q_const"], ops["ode_weight"], ops["t_vec"])
        frozen = k_pre[-1].expand(n_s - n_warm, *k_pre[-1].shape)
        return ((*chain, ops["x0"], ops["theta"], ops["tgrid"],
                 torch.cat([k_pre, frozen])),
                (*chain, mfw[-1], ops["theta"], ops["tgrid"][n_warm:],
                 k_pre[-1]))

    def operand_bytes(args):
        return nbytes(*[a for a in args if isinstance(a, torch.Tensor)])

    def time_mean_boundary():
        """K5b on the 10 000-step solve's 9920-step tail."""
        _, args = mean_chain_operands(10000, 20.0)
        n_tail = args[6].shape[0]
        line = turns("mean_boundary_single",
                     lambda: fk.mean_boundary_chain(*args),
                     operand_bytes(args) + 4 * (n_tail // 64) * 9,
                     shape=f"{n_tail} steps")
        line["us_per_step"] = {w: 1e3 * t / n_tail
                               for w, t in line["median_ms"].items()}
        return [line]

    def time_mean_recovery():
        """K5c on the groups of K5b's 9920-step tail."""
        _, args = mean_chain_operands(10000, 20.0)
        bnd = fk.mean_boundary_chain(*args)
        rec = (*args[:4], bnd, *args[5:])
        return [turns("mean_recovery_single",
                      lambda: fk.mean_recovery_chain(*rec),
                      operand_bytes(rec) + 4 * args[6].shape[0] * 9,
                      shape=f"{bnd.shape[0]} groups of 64")]

    def time_mean_gain():
        """K5a on the 150-step horizon at the 10 000-step solve's step, and
        over the whole 10 000-step solve."""
        lines = []
        for n_s, t_max in ((150, 0.3), (10000, 20.0)):
            args, _ = mean_chain_operands(n_s, t_max)
            lines.append(turns("mean_gain_single",
                               lambda: fk.mean_gain_chain(*args),
                               operand_bytes(args) + 4 * n_s * 9,
                               shape=f"{n_s} steps"))
            lines[-1]["us_per_step"] = {
                w: 1e3 * t / n_s for w, t in lines[-1]["median_ms"].items()}
        return lines

    timed = {"filter_batch": time_filter_batch,
             "smoother_batch_rows": time_rows,
             "filter_single": time_single,
             "smoother_single": time_smoother_single,
             "sampler_batch": lambda: [time_sampler()],
             "fenrir_backward_batch": lambda: time_fenrir(False),
             "fenrir_backward_single": time_fenrir_single,
             "fenrir_backward_batch_tan": lambda: time_fenrir(True),
             "filter_nn_batch": lambda: [time_nn(False)],
             "filter_nn_batch_tan": lambda: [time_nn(True)],
             "magi_batch": time_magi,
             "magi_adjoint_batch": time_magi_adjoint,
             "mean_gain_single": time_mean_gain,
             "mean_boundary_single": time_mean_boundary,
             "mean_recovery_single": time_mean_recovery}
    lines = [line for name in args.kernels for line in timed[name]()]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0 if all(all(line["bitwise_equal"].values())
                    for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
