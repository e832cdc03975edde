r"""
Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of this package for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use,
into ``build/rodeo_tpu_torch/`` beside the package; ``ctypes`` loads it.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and never mixed up with an old build.  A failed build
raises.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "build_log", "error_string", "sass_loops", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rodeo_tpu_torch"

# -fmad=false: no multiply-add contraction, so each kernel rounds exactly as
# its plain PyTorch twin does, operation for operation
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # model, mode, q, n_steps, n_lane, q_const (host), R, W, t_vec, x0,
    # theta, tgrid, eps (chkrebtii's normals, or NULL), G, g, L, m_last,
    # p_last, stream
    "rodeo_filter_batch": [_I] * 5 + [_P] * 14,
    # q, n_steps, n_block, n_lane, A, b, C, d, y, om, mask, m_seed, p_seed,
    # ld_blocks, stream
    "rodeo_fenrir_backward_batch": [_I] * 4 + [_P] * 11,
    # model, mode, q, with_obs, n_steps, n_lane, q_const (host), R, W,
    # t_vec, x0, theta, tgrid, d, y, om, mask, ld0, ld, stream
    "rodeo_dalton_filter_batch": [_I] * 6 + [_P] * 14,
    # q, n_steps, n_col, c, G, xN, xs, stream
    "rodeo_sampler_batch": [_I] * 3 + [_P] * 5,
    # the tangent kernels, with augmented (value + tangents) operands:
    # model, mode, q, n_steps, n_lane, q_const (host), R, W, t_vec, x0,
    # theta, tgrid, A, b, C, m_last, p_last, stream
    "rodeo_filter_batch_tan": [_I] * 5 + [_P] * 13,
    # q, n_steps, n_block, n_lane, n_tan, then as rodeo_fenrir_backward_batch
    "rodeo_fenrir_backward_batch_tan": [_I] * 5 + [_P] * 11,
    # as rodeo_dalton_filter_batch, ld0 and ld augmented
    "rodeo_dalton_filter_batch_tan": [_I] * 6 + [_P] * 14,
    # the launches of K1: model, mode, q, n_lane, out; of K8: model, mode,
    # q, with_obs, n_lane, out (K11c the same); of K11a: model, mode, q,
    # n_lane, out; of K9 and K11d: model, obs_model, mode, q, n_lane, out;
    # of K6: q, n_col, out; of K3: model, mode, q, out; of K2r: q, n_block,
    # n_lane, out; of K7b: q, n_block, n_lane, out
    "rodeo_filter_batch_geometry": [_I] * 4 + [_P],
    "rodeo_dalton_filter_batch_geometry": [_I] * 5 + [_P],
    "rodeo_filter_batch_tan_geometry": [_I] * 4 + [_P],
    "rodeo_dalton_filter_batch_tan_geometry": [_I] * 5 + [_P],
    "rodeo_filter_nn_batch_geometry": [_I] * 5 + [_P],
    "rodeo_filter_nn_batch_tan_geometry": [_I] * 5 + [_P],
    "rodeo_sampler_batch_geometry": [_I, _I, _P],
    "rodeo_filter_single_geometry": [_I] * 3 + [_P],
    "rodeo_smoother_batch_rows_geometry": [_I] * 3 + [_P],
    "rodeo_fenrir_backward_batch_geometry": [_I] * 3 + [_P],
    # of K4: q, n_block, out; of K7a: q, n_block, out; of K11b: q, n_block,
    # n_lane, n_tan, out; of K11e: q, n_col, n_tan, out; of K10a: act, emit_adjoint, n_block, n_lane, out;
    # of K10b: act, n_block, n_lane, out; of K5a and K5b: model, out; of
    # K5c: model, n_group, out
    "rodeo_smoother_single_geometry": [_I, _I, _P],
    "rodeo_fenrir_backward_single_geometry": [_I, _I, _P],
    "rodeo_fenrir_backward_batch_tan_geometry": [_I] * 4 + [_P],
    "rodeo_smoother_mean_batch_tan_geometry": [_I] * 3 + [_P],
    "rodeo_magi_batch_geometry": [_I] * 4 + [_P],
    "rodeo_magi_adjoint_batch_geometry": [_I] * 3 + [_P],
    "rodeo_mean_gain_single_geometry": [_I, _P],
    "rodeo_mean_boundary_single_geometry": [_I, _P],
    "rodeo_mean_recovery_single_geometry": [_I, _I, _P],
    # q, n_steps, n_col, n_tan, g, G, mN, ms, stream
    "rodeo_smoother_mean_batch_tan": [_I] * 4 + [_P] * 5,
    # the single-solve kernels and the rows-emitting smoother:
    # model, mode, q, n_steps, q_const (host), R, W, t_vec, x0, theta,
    # tgrid, eps (chkrebtii's normals, or NULL), mf, pf, mp, pp, stream
    "rodeo_filter_single": [_I] * 4 + [_P] * 13,
    # q, n_steps, n_block, g, G, L, mN, pN, ms, ps, stream
    "rodeo_smoother_single": [_I] * 3 + [_P] * 8,
    # q, n_steps, n_block, A, b, C, d, y, om, mask, m_seed, p_seed,
    # ld_blocks, stream
    "rodeo_fenrir_backward_single": [_I] * 3 + [_P] * 11,
    # q, n_steps, n_block, n_lane, g, G, L, mN, pN, m0, scales, mean, cov,
    # stream
    "rodeo_smoother_batch_rows": [_I] * 4 + [_P] * 10,
    # the MAGI kernels: act, emit_adjoint, n_steps, n_block, n_lane,
    # r_lane_stride, q_const (host), x, R, m0, ld_blocks, z, s_inv, G, stream
    "rodeo_magi_batch": [_I] * 6 + [_P] * 9,
    # act, n_steps, n_block, n_lane, q_const (host), z, s_inv, G, gx, lam0,
    # stream
    "rodeo_magi_adjoint_batch": [_I] * 4 + [_P] * 7,
    # the stationary solve's mean chain: model, n_steps, q_const (host), W,
    # t_vec, x0, theta, tgrid, gains, mf, stream
    "rodeo_mean_gain_single": [_I] * 2 + [_P] * 9,
    # model, n_group, k_group, q_const (host), W, t_vec, m0 (K5b) or bnd
    # (K5c), theta, tgrid of the tail, K*, bnd (K5b) or mf (K5c), stream
    "rodeo_mean_boundary_single": [_I] * 3 + [_P] * 9,
    "rodeo_mean_recovery_single": [_I] * 3 + [_P] * 9,
    # non-Gaussian DALTON's Laplace-linearised filter and its tangent twin:
    # model, obs_model, mode, q, obs_dims, n_steps, n_lane, q_const (host),
    # obs_pars (host), R, W, t_vec, x0, theta, tgrid, y, iobs, mask, mf, pf,
    # mp, pp, stream
    "rodeo_filter_nn_batch": [_I] * 7 + [_P] * 16,
    "rodeo_filter_nn_batch_tan": [_I] * 7 + [_P] * 16,
}


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "rodeo_tpu_torch need the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sum(_sources(), []):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"librodeo_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load():
    """Build the kernels if this source tree has not been built yet, and
    return the loaded library with its argument types declared."""
    lib_path = _library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{lib_path.stem}.{os.getpid()}"
        cus, _ = _sources()
        objs = [BUILD_DIR / f"{stem}.{cu.stem}.o" for cu in cus]
        compiles = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)]
                    for cu, obj in zip(cus, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(" ".join(cmd) + "\n" + out
                      for cmd, out in zip(compiles, outs))
        failed = [proc.returncode for proc in procs if proc.returncode]
        tmp = BUILD_DIR / f"{stem}.tmp"
        if not failed:
            link = [_nvcc(), "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                    *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + proc.stdout + proc.stderr
            failed = [proc.returncode] if proc.returncode else []
        for obj in objs:
            obj.unlink(missing_ok=True)
        lib_path.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rodeo_error_string.argtypes = [ctypes.c_int]
    lib.rodeo_error_string.restype = ctypes.c_char_p
    return lib


def build_log():
    """nvcc's command line and output (registers and spills per kernel, from
    ``-Xptxas -v``) for the current sources, or None if not built here."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else None


def error_string(code):
    """CUDA's description of an error code returned by a C entry point."""
    return load().rodeo_error_string(code).decode()


def sass_loops(symbol, lib_path=None):
    """For each kernel of the library (this source tree's by default) whose
    mangled name holds ``symbol``: its name, its SASS instructions, and the
    instructions of its largest loop, the span of its longest backward
    branch, as ``cuobjdump -sass`` shows them.  None where the toolkit has
    no ``cuobjdump``."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    lib_path = _library_path() if lib_path is None else Path(lib_path)
    return [_largest_loop(name, body)
            for name, body in _sass_functions(str(tool), str(lib_path))
            if symbol in name]


@functools.lru_cache(maxsize=None)
def _sass_functions(tool, lib_path):
    """Each kernel of the library at ``lib_path`` and its SASS lines, from
    one run of ``cuobjdump -sass`` (the dump of every instance, which takes
    tens of seconds to produce and split, is done once a library)."""
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    functions, name, body = [], None, []
    for line in text.splitlines() + ["Function : "]:
        head = re.search(r"Function : (\S*)", line) \
            if "Function : " in line else None
        if head:
            if name is not None:
                functions.append((name, tuple(body)))
            name, body = head[1], []
        elif name is not None:
            body.append(line)
    return tuple(functions)


def _largest_loop(name, lines):
    """A kernel's SASS instruction count and the span, in instructions, of
    its longest backward branch (to a label or to an address)."""
    labels, pending, branches, addr = {}, [], [], None
    for line in lines:
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label[1])
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if not ins:
            continue
        addr = int(ins[1], 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        if re.search(r"\bBRA\b", ins[2]):
            target = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", ins[2])
            if target:
                branches.append((addr, target[1] or int(target[2], 16)))
    loop = 0
    for at, target in branches:
        target = labels.get(target) if isinstance(target, str) else target
        if target is not None and target <= at:
            loop = max(loop, (at - target) // 16 + 1)
    return {"kernel": name,
            "instructions": 0 if addr is None else addr // 16 + 1,
            "loop_instructions": loop}
