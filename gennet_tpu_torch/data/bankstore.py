"""The native bank store through ctypes (port of
``gennet_tpu.data.bankstore``).

Checksummed, memory-mapped template-bank files (``.gntb``) with a
multithreaded writer and batch gather, from ``native/bankstore.cpp``
(ref: gw_template_maker.py:842-863, bbhMahoGANy.py:969-1005). The C ABI
and the file format are the JAX package's, so the two packages read each
other's files. The library is compiled from that source with ``g++`` on
first use, into ``build/gennet_tpu_torch/`` at the repository root, keyed by
a hash of the source and flags; nothing is built when this module is
imported, and a failed build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "native" / "bankstore.cpp"
BUILD_DIR = _REPO / "build" / "gennet_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread"]

PARAM_ORDER = ("mc", "q", "m1", "m2", "eta", "M", "idx")

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = 0.0     # g++'s time in this process; 0.0 when an earlier build was reused


def _build() -> Path:
    """Compile ``native/bankstore.cpp`` unless this source and these flags
    were built before; returns the library's path."""
    global BUILD_SECONDS
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib_path = BUILD_DIR / f"libbankstore_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builds race harmlessly
        BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.gntb_write.restype = ctypes.c_int
        lib.gntb_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_int,
        ]
        lib.gntb_open.restype = ctypes.c_void_p
        lib.gntb_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.gntb_n.restype = ctypes.c_uint64
        lib.gntb_n.argtypes = [ctypes.c_void_p]
        lib.gntb_n_pix.restype = ctypes.c_uint32
        lib.gntb_n_pix.argtypes = [ctypes.c_void_p]
        lib.gntb_n_par.restype = ctypes.c_uint32
        lib.gntb_n_par.argtypes = [ctypes.c_void_p]
        lib.gntb_templates.restype = ctypes.POINTER(ctypes.c_float)
        lib.gntb_templates.argtypes = [ctypes.c_void_p]
        lib.gntb_params.restype = ctypes.POINTER(ctypes.c_float)
        lib.gntb_params.argtypes = [ctypes.c_void_p]
        lib.gntb_gather.restype = ctypes.c_int
        lib.gntb_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.gntb_close.restype = None
        lib.gntb_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_bank(path: str, templates: np.ndarray, params: dict | np.ndarray, n_threads: int = 8):
    """Write a bank file. ``params`` is a dict of per-template arrays
    (stored in PARAM_ORDER where present) or an (n, n_par) array."""
    lib = _load()
    templates = np.ascontiguousarray(templates, np.float32)
    if templates.ndim != 2:
        raise ValueError(f"templates must be (n, n_pix), got shape {templates.shape}")
    if isinstance(params, dict):
        cols = [np.asarray(params[k], np.float32) for k in PARAM_ORDER if k in params]
        pmat = (np.ascontiguousarray(np.stack(cols, -1)) if cols
                else np.zeros((len(templates), 0), np.float32))
    else:
        pmat = np.ascontiguousarray(params, np.float32)
    if pmat.ndim != 2 or pmat.shape[0] != templates.shape[0]:
        raise ValueError(f"params of shape {pmat.shape} for {templates.shape[0]} templates")
    rc = lib.gntb_write(path.encode(), _fptr(templates), templates.shape[0], templates.shape[1],
                        _fptr(pmat), pmat.shape[1], n_threads)
    if rc != 0:
        raise OSError(f"gntb_write failed with code {rc}")


class BankStore:
    """Memory-mapped read handle: zero-copy numpy views and a threaded
    gather."""

    def __init__(self, path: str, verify: bool = True, n_threads: int = 8):
        self._lib = _load()
        self._h = self._lib.gntb_open(path.encode(), int(verify), n_threads)
        if not self._h:
            raise OSError(f"failed to open bank {path!r} (corrupt or missing)")
        self.n = int(self._lib.gntb_n(self._h))
        self.n_pix = int(self._lib.gntb_n_pix(self._h))
        self.n_par = int(self._lib.gntb_n_par(self._h))
        self._n_threads = n_threads

    @property
    def templates(self) -> np.ndarray:
        """Zero-copy view of the template matrix (n, n_pix); valid until
        :meth:`close`."""
        ptr = self._lib.gntb_templates(self._h)
        return np.ctypeslib.as_array(ptr, shape=(self.n, self.n_pix))

    @property
    def params(self) -> np.ndarray:
        """Zero-copy view of the parameter matrix (n, n_par), columns in
        PARAM_ORDER; valid until :meth:`close`."""
        ptr = self._lib.gntb_params(self._h)
        return np.ctypeslib.as_array(ptr, shape=(self.n, self.n_par))

    def gather(self, idx: np.ndarray):
        """Threaded random-row batch fetch → (templates, params) copies."""
        idx = np.ascontiguousarray(idx, np.uint64)
        out_t = np.empty((len(idx), self.n_pix), np.float32)
        out_p = np.empty((len(idx), self.n_par), np.float32)
        rc = self._lib.gntb_gather(self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                                   len(idx), _fptr(out_t), _fptr(out_p), self._n_threads)
        if rc != 0:
            raise IndexError("gather index out of range")
        return out_t, out_p

    def close(self):
        if self._h:
            self._lib.gntb_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
