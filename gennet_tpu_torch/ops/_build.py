"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``gennet_tpu_torch/csrc/`` is compiled with
``nvcc`` for Hopper (``sm_90a``), one process per file, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``. The library lives under
``build/gennet_tpu_torch/`` at the repository root and is keyed by a hash
of the sources and flags, so an edit forces a rebuild and an unchanged
tree reuses the last build. Nothing is built when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gennet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_LOG = ""          # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """Return the kernel library, compiling it first if the sources changed.

    Raises ``RuntimeError`` with nvcc's output if the build fails.
    """
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = BUILD_DIR / f"libgennet_kernels_{_digest()}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        tmp = lib_path.with_suffix(f".{tag}")
        nvcc = _nvcc()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [f"{src.name}:\n{proc.communicate()[0]}" for src, proc in zip(sources, procs)]
        BUILD_LOG = "\n".join(logs)
        failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}\n{BUILD_LOG}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    lib.phasor_irdft_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.phasor_irdft_f32.restype = ctypes.c_int
    lib.phasor_irdft_workspace.argtypes = [ctypes.c_int] * 3
    lib.phasor_irdft_workspace.restype = ctypes.c_longlong
    lib.conv1d_same_f32.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                                    + [ctypes.c_float, ctypes.c_void_p])
    lib.conv1d_same_f32.restype = ctypes.c_int
    lib.conv1d_pack_weight_f32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.conv1d_pack_weight_f32.restype = ctypes.c_int
    lib.conv1d_dx_s2_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.conv1d_dx_s2_f32.restype = ctypes.c_int
    lib.conv1d_dx_s2_pack_f32.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.conv1d_dx_s2_pack_f32.restype = ctypes.c_int
    lib.conv1d_dw_s2_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.conv1d_dw_s2_f32.restype = ctypes.c_int
    lib.gennet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gennet_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
