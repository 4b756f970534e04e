"""Native (C++) runtime components, loaded via ctypes.

The reference's native tier is C++ (the DuckDB extension + FAISS).  Here the
device compute path is JAX/XLA/Pallas; the host-side runtime pieces that are
genuinely CPU-bound — the selection-bitmap builder with its 8-wide packing
loop (src/faiss_extension.cpp:789-796) and the top-k result merge used by the
multi-host driver — are C++ (native/bitmapper.cpp), built on demand with g++
and loaded through ctypes.  Everything degrades to numpy when the toolchain
is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bitmapper.cpp")
_SO = os.path.join(_HERE, "_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.dfx_build_bitmap.restype = None
        lib.dfx_build_bitmap.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.dfx_merge_topk.restype = None
        lib.dfx_merge_topk.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ]

    def build_bitmap(self, flags: np.ndarray, ids: np.ndarray, n: int,
                     out: np.ndarray, nbytes: int) -> None:
        self._lib.dfx_build_bitmap(
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            nbytes,
        )

    def merge_topk(self, dists: np.ndarray, labels: np.ndarray,
                   descending: bool) -> tuple[np.ndarray, np.ndarray]:
        """Merge S sorted shards of per-query top-k lists.

        dists/labels: (S, nq, k) contiguous; returns (nq, k)."""
        s, nq, k = dists.shape
        out_d = np.empty((nq, k), np.float32)
        out_l = np.empty((nq, k), np.int64)
        self._lib.dfx_merge_topk(
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            s, nq, k, 1 if descending else 0,
            out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out_d, out_l


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def load_native() -> _NativeLib | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        if not os.path.exists(_SO) or (os.path.getmtime(_SO)
                                       < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            _lib = _NativeLib(ctypes.CDLL(_SO))
        except OSError:
            _lib = None
        return _lib
