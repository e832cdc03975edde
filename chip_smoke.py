#!/usr/bin/env python3
"""
Drive the PyTorch / CUDA port, rodeo_tpu_torch, on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from a checkout: it imports the package beside it and builds the two
CUDA kernels from the checkout's sources.  Each phase prints one JSON line:

1. device    the card, its power limit, TF32 off;
2. build     nvcc of rodeo_tpu_torch/ops/csrc/*.cu: seconds, and ptxas'
             registers and spills per kernel;
3. k1_twin   kernel K1 (filter_batch) against its plain PyTorch twin on the
             same CUDA inputs: Lorenz63 EK1 and FitzHugh-Nagumo EK0, 1000
             steps x 256 lanes;
4. k2_twin   kernel K2 (smoother_batch) against its twin, on seeded inputs
             and on the gains of phase 3;
5. main      the main path: Lorenz63 EK1, 10 000 steps x 2048 lanes through
             solve_mv_fused_batch.  It must launch each kernel once, stay
             finite, and pass the t <= 4 audit of lane 0 against the cached
             float64 truth; then its per-solve time and peak memory, and each
             kernel timed and checked against its twin at these shapes;
6. fitzhugh  the kernel path (800 steps x 128 lanes) and the torch-op
             solve_mv in float64, against the cached FitzHugh-Nagumo truth.

Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failure exits non-zero without that last line; so does a host without
CUDA: the port is never run on the CPU here.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# A kernel and its twin do the same float32 operations in the same order
# (the kernels are built without multiply-add contraction); a division by a
# constant, which PyTorch on CUDA may take through its reciprocal, can still
# round differently.  Bound on max|kernel - twin| / max|twin| per output.
TWIN_TOL = 1e-5
# The solve audit of bench.py: max abs error of the solution path against
# the float64 truth <= max(3 x the same error of float32 on the CPU, 0.05).
AUDIT_FLOOR = 0.05
# The float64 torch-op solve against the float64 truth.
F64_ATOL = 1e-8


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    if not (REPO / "rodeo_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: rodeo_tpu_torch not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port is not run on the "
              "CPU", file=sys.stderr)
        return 1

    import rodeo_tpu_torch
    from rodeo_tpu_torch.interrogate import interrogate_kramer
    from rodeo_tpu_torch.models import fitzhugh, lorenz
    from rodeo_tpu_torch.ops import _build
    from rodeo_tpu_torch.ops import fused_kalman as fk

    dev = torch.device("cuda", 0)
    failures = []

    def check(phase, name, ok):
        if not ok:
            failures.append(f"{phase}: {name}")
        return bool(ok)

    def cuda_ms(fn, repeats):
        """Median milliseconds of fn() by CUDA events, after one warm-up."""
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

    def cuda_once(fn):
        """fn() and its milliseconds by CUDA events, one run."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def compare(names, kernel, plain):
        """Per output: max abs difference and that over max|plain|."""
        errs = {}
        for name, a, b in zip(names, kernel, plain):
            diff = (a.double() - b.double()).abs().max().item()
            scale = b.double().abs().max().item()
            errs[name] = {"max_abs_err": diff,
                          "scaled_err": diff / scale if scale else diff}
        return errs

    def worst(errs):
        return (max(e["max_abs_err"] for e in errs.values()),
                max(e["scaled_err"] for e in errs.values()))

    def max_err_prefix(mu, ref, n_prefix):
        """bench.py's audit: max abs error of the 0th derivative over the
        first n_prefix rows."""
        return float(np.max(np.abs(np.asarray(mu)[:n_prefix, :, 0]
                                   - np.asarray(ref)[:n_prefix, :, 0])))

    def lane_setup(mod, n_steps, t_max, n_lane, thetas_of):
        cfg = mod.setup(n_steps=n_steps, t_max=t_max, dtype=torch.float32,
                        device=dev)
        thetas = thetas_of(cfg["theta"], n_lane)
        inits = cfg["ode_init"].expand((n_lane,) + cfg["ode_init"].shape)
        return cfg, thetas, inits

    def seeded_thetas(seed):
        def make(theta, n_lane):
            rng = np.random.default_rng(seed)
            noise = torch.tensor(rng.standard_normal((n_lane, 3)),
                                 dtype=torch.float32, device=dev)
            return theta * (1 + 0.01 * noise)
        return make

    def bench_thetas(theta, n_lane):
        # bench.py's lane batch: theta * (1 + 1e-6 * lane index)
        lanes = torch.arange(n_lane, dtype=torch.float32, device=dev)
        return theta.expand(n_lane, 3) * (1 + 1e-6 * lanes[:, None])

    truth = dict(np.load(REPO / ".bench_ref_v8.npz"))
    truth.update(np.load(REPO / ".bench_ref_v8_ctrl.npz"))

    # ---- 1. device and precision --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32_off = check("device", "tf32",
                     not torch.backends.cuda.matmul.allow_tf32
                     and not torch.backends.cudnn.allow_tf32)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "tf32_off": tf32_off,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = _build.build_log() or ""
    ptxas = [line.strip() for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line
             or "spill" in line]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    # ---- 3. K1 against its twin ---------------------------------------------
    k1_names = ["G", "g", "L", "m_last", "p_last"]
    gains = None
    for model, mode, t_max, seed in (("lorenz", "kramer", 2.0, 0),
                                     ("fitzhugh", "rodeo", 10.0, 1)):
        n_steps, n_lane = 1000, 256
        mod = {"lorenz": lorenz, "fitzhugh": fitzhugh}[model]
        cfg, thetas, inits = lane_setup(mod, n_steps, t_max, n_lane,
                                        seeded_thetas(seed))
        ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0,
                                  t_max, n_steps, cfg["prior_pars"])
        fused = fk.resolve_model(model)
        out_k = fk.fused_filter_batch(fused, n_steps, **ops, mode=mode)
        out_p = fk._filter_batch_plain(fused, n_steps, **ops, mode=mode)
        torch.cuda.synchronize()
        errs = compare(k1_names, out_k, out_p)
        ok = check("k1_twin", f"{model}/{mode}",
                   worst(errs)[1] <= TWIN_TOL
                   and all(torch.isfinite(a).all().item() for a in out_k))
        emit({"phase": "k1_twin", "model": model, "mode": mode,
              "n_steps": n_steps, "n_lane": n_lane, "tol_scaled": TWIN_TOL,
              "errors": errs, "ok": ok})
        if gains is None:
            gains = out_k

    # ---- 4. K2 against its twin ---------------------------------------------
    rng = np.random.default_rng(2)
    T, q, nb, B = 1000, 3, 3, 256
    G = np.eye(q).reshape(1, q * q, 1, 1) * 0.5 + \
        0.1 * rng.standard_normal((T, q * q, nb, B))
    A = rng.standard_normal((T, nb, B, q, q))
    Lfull = A @ np.swapaxes(A, -1, -2)
    pairs, _ = fk._tri_idx(q)
    L = np.stack([Lfull[..., i, j] for i, j in pairs], axis=1)
    seeded = [torch.tensor(a, dtype=torch.float32, device=dev).contiguous()
              for a in (rng.standard_normal((T, q, nb, B)), G, L,
                        rng.standard_normal((q, nb, B)),
                        np.abs(rng.standard_normal((len(pairs), nb, B))))]
    G1, g1, L1, m1, p1 = gains
    for source, args in (("seeded", seeded),
                         ("k1_gains", (g1[1:], G1[1:], L1[1:], m1, p1))):
        out_k = fk.smoother_recursion_batch(*args)
        out_p = fk._smoother_batch_plain(*args)
        torch.cuda.synchronize()
        errs = compare(["ms", "ps"], out_k, out_p)
        ok = check("k2_twin", source, worst(errs)[1] <= TWIN_TOL)
        emit({"phase": "k2_twin", "inputs": source, "tol_scaled": TWIN_TOL,
              "errors": errs, "ok": ok})
    del gains, G1, g1, L1, m1, p1, seeded

    # ---- 5. the main path --------------------------------------------------
    n_steps, n_lane, t_max = 10000, 2048, 20.0
    cfg, thetas, inits = lane_setup(lorenz, n_steps, t_max, n_lane,
                                    bench_thetas)

    def solve():
        return fk.solve_mv_fused_batch(
            thetas, cfg["ode_weight"], inits, 0.0, t_max, n_steps,
            cfg["prior_pars"], model="lorenz", interrogation="kramer")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in fk.LAUNCHES:
        fk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    mean, var = solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    check("main", "one launch per kernel",
          launches == {"filter_batch": 1, "smoother_batch": 1})
    shapes_ok = check("main", "shapes",
                      tuple(mean.shape) == (n_steps + 1, 3, 3, n_lane)
                      and tuple(var.shape) == (n_steps + 1, 3, 6, n_lane))
    finite = check("main", "finite", torch.isfinite(mean).all().item()
                   and torch.isfinite(var).all().item())
    n_prefix = n_steps // 5              # t <= 4
    err = max_err_prefix(mean[..., 0].cpu().numpy(), truth["solve_mu_10k"],
                         n_prefix)
    control = max_err_prefix(truth["solve_mu_10k_f32cpu"],
                             truth["solve_mu_10k"], n_prefix)
    tol = max(3 * control, AUDIT_FLOOR)
    audit_ok = check("main", "audit", err <= tol)
    del mean, var
    solve_ms = cuda_ms(solve, repeats=5)
    emit({"phase": "main", "model": "lorenz", "interrogation": "kramer",
          "n_steps": n_steps, "n_lane": n_lane, "t_max": t_max,
          "launches": launches, "shapes_ok": shapes_ok, "finite": finite,
          "audit_max_abs_err_t4": err, "audit_control_f32cpu": control,
          "audit_tol": tol, "audit_ok": audit_ok,
          "first_call_s": first_s, "solve_ms": solve_ms,
          "per_solve_us": 1e3 * solve_ms / n_lane,
          "peak_mem_bytes": peak_bytes})

    # each kernel at the main path's shapes, timed and checked against its
    # twin (these launches come after the counts above were read)
    ops = fk._kernel_operands(thetas, cfg["ode_weight"], inits, 0.0, t_max,
                              n_steps, cfg["prior_pars"])
    fused = fk.resolve_model("lorenz")

    def k1():
        return fk.fused_filter_batch(fused, n_steps, **ops, mode="kramer")

    k1_ms = cuda_ms(k1, repeats=3)
    out_k = k1()
    out_p, k1_plain_ms = cuda_once(
        lambda: fk._filter_batch_plain(fused, n_steps, **ops, mode="kramer"))
    k1_errs = compare(k1_names, out_k, out_p)
    del out_p
    G, g, L, mN, pN = out_k
    k2_args = (g[1:], G[1:], L[1:], mN, pN)
    k2_ms = cuda_ms(lambda: fk.smoother_recursion_batch(*k2_args), repeats=3)
    sm_k = fk.smoother_recursion_batch(*k2_args)
    sm_p, k2_plain_ms = cuda_once(lambda: fk._smoother_batch_plain(*k2_args))
    k2_errs = compare(["ms", "ps"], sm_k, sm_p)
    del sm_p, sm_k, out_k, G, g, L, mN, pN, k2_args
    k1_ok = check("main", "K1 vs twin", worst(k1_errs)[1] <= TWIN_TOL)
    k2_ok = check("main", "K2 vs twin", worst(k2_errs)[1] <= TWIN_TOL)
    emit({"phase": "main_kernels", "n_steps": n_steps, "n_lane": n_lane,
          "filter_batch": {"ms": k1_ms, "plain_ms": k1_plain_ms,
                           "errors": k1_errs, "ok": k1_ok},
          "smoother_batch": {"ms": k2_ms, "plain_ms": k2_plain_ms,
                             "errors": k2_errs, "ok": k2_ok}})

    # ---- 6. FitzHugh-Nagumo --------------------------------------------
    n_fh = 800
    cfg_fh, thetas_fh, inits_fh = lane_setup(fitzhugh, n_fh, 10.0, 128,
                                             bench_thetas)
    mean_fh, _ = fk.solve_mv_fused_batch(
        thetas_fh, cfg_fh["ode_weight"], inits_fh, 0.0, 10.0, n_fh,
        cfg_fh["prior_pars"], model="fitzhugh", interrogation="kramer")
    err_fh = max_err_prefix(mean_fh[..., 0].cpu().numpy(),
                            truth["solve_mu_fitz"], n_fh + 1)
    control_fh = max_err_prefix(truth["solve_mu_fitz_f32cpu"],
                                truth["solve_mu_fitz"], n_fh + 1)
    tol_fh = max(3 * control_fh, AUDIT_FLOOR)
    fused_ok = check("fitzhugh", "kernel path audit", err_fh <= tol_fh)
    cfg64 = fitzhugh.setup(n_steps=n_fh, t_max=10.0, dtype=torch.float64,
                           device=dev)
    theta64 = cfg64.pop("theta")
    mu64, _ = rodeo_tpu_torch.solve_mv(interrogate=interrogate_kramer,
                                       theta=theta64, **cfg64)
    err64 = float(np.max(np.abs(mu64.cpu().numpy()
                                - truth["solve_mu_fitz"])))
    f64_ok = check("fitzhugh", "torch-op float64", err64 <= F64_ATOL)
    emit({"phase": "fitzhugh", "n_steps": n_fh, "n_lane": 128,
          "kernel_path_max_abs_err": err_fh, "control_f32cpu": control_fh,
          "tol": tol_fh, "kernel_path_ok": fused_ok,
          "torch_op_f64_max_abs_err": err64, "atol": F64_ATOL,
          "torch_op_f64_ok": f64_ok})

    # ---- summary --------------------------------------------------------
    emit({"kernels": [
        {"name": "filter_batch", "route": "cuda",
         "source": "rodeo_tpu_torch/ops/csrc/filter_batch.cu",
         "replaces": "rodeo_tpu/ops/pallas_kalman.py:1141",
         "launches": launches["filter_batch"],
         "max_abs_err": worst(k1_errs)[0],
         "max_scaled_err": worst(k1_errs)[1], "tol_scaled": TWIN_TOL,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "smoother_batch", "route": "cuda",
         "source": "rodeo_tpu_torch/ops/csrc/smoother_batch.cu",
         "replaces": "rodeo_tpu/ops/pallas_kalman.py:1516",
         "launches": launches["smoother_batch"],
         "max_abs_err": worst(k2_errs)[0],
         "max_scaled_err": worst(k2_errs)[1], "tol_scaled": TWIN_TOL,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]})
    if failures:
        print("chip_smoke.py: failed: " + "; ".join(failures),
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
