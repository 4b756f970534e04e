"""Global runtime configuration.

``precision`` selects the matmul mode of the distance scans:

* ``"parity"``  — lax.Precision.HIGHEST: fp32 products, required to match
  the reference's fp32 BLAS distances (the golden-value tests,
  test/sql/faiss.test:16-38).
* ``"fast"``    — lax.Precision.DEFAULT: TF32 matmul products on the
  GPU, the throughput mode.  Scans that rank in fast mode re-score their
  widened top-k at HIGHEST, so returned distances stay fp32.

The reference has no such switch because CPU BLAS is always fp32; on an
accelerator the parity/throughput trade-off is real, so it is explicit.
"""

from __future__ import annotations

import dataclasses
import functools

from jax import lax

_PRECISIONS = {
    "parity": lax.Precision.HIGHEST,
    "fast": lax.Precision.DEFAULT,
}

#: device-memory figure used where the backend reports no allocator limit
#: (the CPU backend the tests run on); budgets derived from it keep the
#: CPU tests' tile and layout shapes fixed.
CPU_TEST_MEMORY_BYTES = 16 << 30


@dataclasses.dataclass
class Config:
    precision_mode: str = "parity"
    #: minimum padded corpus capacity (power of two); keeps jit cache small
    min_capacity: int = 128
    #: minimum padded query-batch bucket
    min_query_bucket: int = 8
    #: SQ8 scan arithmetic: "auto" = int8 digit dots in fast mode (codes
    #: read as int8, no decode intermediate; query-side-only quantization
    #: recovered by the built-in exact rerank), decode path in parity
    #: mode; "int8" / "decode" force one path.
    sq_dot: str = "auto"
    #: host->device query wire format: "auto" = fp16 in fast mode for
    #: uploads > 1 MB (cast back to f32 on device; ~6e-4 relative query
    #: error, far below storage quantization noise), f32 in parity mode;
    #: "f32" / "f16" force one format.
    query_wire: str = "auto"

    @property
    def precision(self):
        return _PRECISIONS[self.precision_mode]


config = Config()


def set_precision(mode: str) -> None:
    if mode not in _PRECISIONS:
        raise ValueError(f"precision mode must be one of {sorted(_PRECISIONS)}")
    config.precision_mode = mode


def set_sq_dot(mode: str) -> None:
    if mode not in ("auto", "int8", "decode"):
        raise ValueError("sq dot mode must be auto, int8, or decode")
    config.sq_dot = mode


def sq_int8_active() -> bool:
    """Whether the SQ8 scan should take the int8 digit-dot path right now."""
    if config.sq_dot == "int8":
        return True
    if config.sq_dot == "decode":
        return False
    return config.precision != lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def device_memory_bytes() -> int:
    """Allocator limit of the default device (``memory_stats()
    ["bytes_limit"]``), or CPU_TEST_MEMORY_BYTES where the backend
    reports none."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit") or CPU_TEST_MEMORY_BYTES)


def memory_budget(fraction: float) -> int:
    """``fraction`` of the default device's memory, in bytes."""
    return int(device_memory_bytes() * fraction)


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def next_capacity(n: int) -> int:
    """Device-buffer capacity schedule: powers of two up to 1M rows
    (amortised growth, few jit shapes), then 1M-row increments — pow2
    padding wastes up to 2× device memory at 10M+ rows.  All returned
    values are divisible by every power-of-two block size ≤ 2^20 the
    scans pick."""
    n = int(n)
    if n <= (1 << 20):
        return next_pow2(max(n, 1))
    step = 1 << 20
    return step * -(-n // step)


def pad_rows(arr, target: int, fill=0.0):
    """Pad (n, ...) array with fill rows up to target rows."""
    import numpy as np

    n = arr.shape[0]
    if n == target:
        return arr
    pad = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)
