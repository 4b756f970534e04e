"""Pairwise distance tiles for all nine metrics.

This is the device replacement for FAISS's distance kernels (BLAS sgemm
for L2/IP plus scalar loops in extra_distances for the rest; used by the
reference via ``Index::search``, src/faiss_extension.cpp:631).

Design: every metric is computed as a (Q, C) tile of scores from a (Q, D)
query block and a (C, D) corpus block.

* ``L2`` and ``INNER_PRODUCT`` lower to a single matmul.  L2 uses the
  ``‖x‖² − 2·x·yᵀ + ‖y‖²`` decomposition so the FLOPs ride the matrix units.
  FAISS's METRIC_L2 is the *squared* L2 distance — we keep that.
* The seven remaining metrics are elementwise (Q, C, D) reductions.
  Callers bound C so the broadcast tile fits on chip.

All computations are fp32.  ``precision`` selects the matmul mode: HIGHEST
(6-pass bf16 ≈ fp32, required for parity with FAISS's fp32 BLAS path) or
DEFAULT (fast bf16) for throughput mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Metrics whose pairwise tile is a matmul (matmul path).
MXU_METRICS = ("INNER_PRODUCT", "L2")


def pairwise_tile(
    xq: jax.Array,  # (Q, D) fp32
    xb: jax.Array,  # (C, D) fp32
    metric: str,
    metric_arg: float | jax.Array = 0.0,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:  # (Q, C) fp32 distances (or similarities for IP/Jaccard)
    if metric == "INNER_PRODUCT":
        if xq.dtype == jnp.int8 and xb.dtype == jnp.int8:
            # Exact int8 matmul dot (±1 LSH sign codes, FlatIndex pm1_i8
            # storage): int32 accumulation, no rounding at any precision
            # mode, 4× less HBM traffic than the fp32 corpus.
            return jax.lax.dot_general(
                xq, xb, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32).astype(jnp.float32)
        return jnp.dot(xq, xb.T, precision=precision,
                       preferred_element_type=jnp.float32)
    if metric == "L2":
        # Squared L2 via matmul decomposition; clamp rounding negatives.
        qn = jnp.sum(xq * xq, axis=-1, keepdims=True)        # (Q, 1)
        bn = jnp.sum(xb * xb, axis=-1, keepdims=True).T      # (1, C)
        xy = jnp.dot(xq, xb.T, precision=precision,
                     preferred_element_type=jnp.float32)
        return jnp.maximum(qn - 2.0 * xy + bn, 0.0)
    return _elementwise_tile(xq, xb, metric, metric_arg)


def _elementwise_tile(xq, xb, metric, metric_arg):
    # (Q, 1, D) vs (1, C, D) broadcast; XLA fuses the reduce so the (Q, C, D)
    # intermediate never hits HBM for moderate C.
    return elementwise_scores(xq[:, None, :], xb[None, :, :], metric,
                              metric_arg)


def elementwise_scores(x, y, metric, metric_arg=0.0):
    """Elementwise-metric distances over any broadcastable operand pair
    whose last axis is the vector dimension (single source of truth for the
    seven non-matmul metric formulas; flat and IVF scans both call this)."""
    if metric == "L1":
        return jnp.sum(jnp.abs(x - y), axis=-1)
    if metric == "Linf":
        return jnp.max(jnp.abs(x - y), axis=-1)
    if metric == "Lp":
        # FAISS sums |x-y|^p without the 1/p root; p = Index::metric_arg.
        p = jnp.asarray(metric_arg, jnp.float32)
        return jnp.sum(jnp.abs(x - y) ** p, axis=-1)
    if metric == "Canberra":
        num = jnp.abs(x - y)
        den = jnp.abs(x) + jnp.abs(y)
        return jnp.sum(jnp.where(den > 0, num / den, 0.0), axis=-1)
    if metric == "BrayCurtis":
        num = jnp.sum(jnp.abs(x - y), axis=-1)
        den = jnp.sum(jnp.abs(x + y), axis=-1)
        return jnp.where(den > 0, num / den, 0.0)
    if metric == "JensenShannon":
        # 0.5 * Σ x·log(2x/(x+y)) + y·log(2y/(x+y)); zero terms where the
        # numerator mass is zero (matches the KL convention FAISS uses).
        m = x + y
        safe = lambda a: jnp.where(
            a > 0, a * jnp.log(jnp.where(a > 0, 2.0 * a, 1.0)
                               / jnp.where(m > 0, m, 1.0)), 0.0)
        return 0.5 * jnp.sum(safe(x) + safe(y), axis=-1)
    if metric == "Jaccard":
        # Similarity: Σ min / Σ max (FAISS treats Jaccard like IP: max-heap).
        num = jnp.sum(jnp.minimum(x, y), axis=-1)
        den = jnp.sum(jnp.maximum(x, y), axis=-1)
        return jnp.where(den > 0, num / den, 0.0)
    raise ValueError(f"unknown metric {metric}")
