"""ctypes binding to the native C++ Matrix Market parser (libdasp_host).

The reference's loader is native C (``mmio.h``, ``mmio_highlevel.h``); ours
is C++ (``native/mmio.cpp``), exposed through a C ABI and loaded here.  The
library is built by ``make -C native`` at first use; without a toolchain
``load_matrix`` falls back to the Python parser.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..sparse import CSRMatrix

_LIB = None
_TRIED = False


def _stale(so_path: str, srcdir: str) -> bool:
    """The .so predates a source file (make only reruns on first use)."""
    try:
        so_m = os.path.getmtime(so_path)
        return any(os.path.getmtime(os.path.join(srcdir, f)) > so_m
                   for f in os.listdir(srcdir)
                   if f.endswith(".cpp") or f == "Makefile")
    except OSError:
        return False


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    srcdir = os.path.join(os.path.dirname(here), "native")
    lib = os.path.join(srcdir, "libdasp_host.so")
    if os.path.exists(lib) and not _stale(lib, srcdir):
        return lib
    # The .so is a build artifact (gitignored); (re)build it from the
    # committed sources on first use, so a fresh checkout never silently
    # falls back to the slow Python parser and a stale .so never hides a
    # source change.
    if os.path.exists(os.path.join(srcdir, "Makefile")):
        import subprocess
        import sys
        try:
            subprocess.run(["make", "-C", srcdir], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:
            # A broken toolchain must not SILENTLY fall back to the slow
            # Python parser — say why the build failed, once.
            tail = ""
            stderr = getattr(e, "stderr", None)
            if stderr:
                tail = ": " + stderr.decode("utf-8", "replace").strip(
                    ).splitlines()[-1][:200]
            print(f"dasp_tpu: native build failed ({e.__class__.__name__}"
                  f"{tail}); using the slow Python fallback",
                  file=sys.stderr)
            return None
        if os.path.exists(lib):
            return lib
    return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.dasp_read_mtx.restype = ctypes.c_void_p
    lib.dasp_read_mtx.argtypes = [ctypes.c_char_p]
    lib.dasp_csr_dims.restype = None
    lib.dasp_csr_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
    lib.dasp_csr_export.restype = None
    lib.dasp_csr_export.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_double)]
    lib.dasp_csr_free.restype = None
    lib.dasp_csr_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_mtx(path, dtype=np.float64) -> CSRMatrix:
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser not built")
    handle = lib.dasp_read_mtx(os.fsencode(path))
    if not handle:
        raise ValueError(f"native parser failed on {path}")
    try:
        m = ctypes.c_int64()
        n = ctypes.c_int64()
        nnz = ctypes.c_int64()
        lib.dasp_csr_dims(handle, ctypes.byref(m), ctypes.byref(n),
                          ctypes.byref(nnz))
        row_ptr = np.empty(m.value + 1, dtype=np.int64)
        col_idx = np.empty(nnz.value, dtype=np.int32)
        values = np.empty(nnz.value, dtype=np.float64)
        lib.dasp_csr_export(
            handle,
            row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    finally:
        lib.dasp_csr_free(handle)
    return CSRMatrix(int(m.value), int(n.value), row_ptr, col_idx,
                     values.astype(dtype, copy=False))
