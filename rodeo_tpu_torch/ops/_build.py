r"""
Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` of this package for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first
use, into ``build/rodeo_tpu_torch/`` beside the package; ``ctypes`` loads
it.  The library's name carries a hash of the sources and flags, so an
edited source is rebuilt and never mixed up with an old build.  A failed
build raises.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["load", "build_log", "error_string", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rodeo_tpu_torch"

# -fmad=false: no multiply-add contraction, so each kernel rounds exactly as
# its plain PyTorch twin does, operation for operation
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # model, mode, n_steps, n_lane, q_const (host), R, W, t_vec, x0, theta,
    # tgrid, G, g, L, m_last, p_last, stream
    "rodeo_filter_batch": [_I, _I, _I, _I] + [_P] * 13,
    # n_steps, n_col, g, G, L, mN, pN, ms, ps, stream
    "rodeo_smoother_batch": [_I, _I] + [_P] * 8,
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
        tmp = lib_path.parent / f"{lib_path.stem}.{os.getpid()}.tmp"
        cus, _ = _sources()
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cus)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        lib_path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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
