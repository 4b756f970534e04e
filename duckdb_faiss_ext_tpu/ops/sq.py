"""Scalar-quantizer codecs: SQ8, SQ4, SQ6 (bit-packed) and SQfp16.

Equivalent of faiss::IndexScalarQuantizer as reachable through factory
strings (``SQ8``, ``SQ4``, ``SQ6``, ``SQfp16``).  The quantized codecs train
per-dimension [vmin, vmax] ranges (FAISS's RS_minmax default) and store
8/4/6 bits per dimension; search decodes chunks on the fly and rides the
same matmul distance tile as Flat — the same decode-don't-LUT design
as ops/pq.py, at 4×/8×/5.3× (SQ8/SQ4/SQ6) or 2× (fp16) less HBM traffic
than fp32.

Packing layouts (host packs with numpy at ingest; device unpacks with
vectorized shift/mask ops inside the scan):
* SQ4: two 4-bit codes per byte, low nibble first → (n, ceil(d/2));
* SQ6: four 6-bit codes per 3 bytes (big-endian bit order) →
  (n, 3·ceil(d/4)).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .distance import pairwise_tile
from .flat_search import _NEG_INF, SIMILARITY_METRICS, exact_topk

#: quantization levels per codec (code range [0, levels])
SQ_LEVELS = {"sq8": 255, "sq4": 15, "sq6": 63}

#: training-free float codecs (stored as raw half-width rows);
#: bf16 is the matmul storage type.
FLOAT_CODECS = ("fp16", "bf16")


def float_codec_dtype(codec: str):
    """numpy dtype for a float codec name ('fp16' | 'bf16')."""
    if codec == "bf16":
        import ml_dtypes

        return ml_dtypes.bfloat16
    return np.float16


def sq_train(x, levels: int) -> tuple[jax.Array, jax.Array]:
    """Per-dim (vmin (d,), scale (d,)) from training data."""
    x = jnp.asarray(x, jnp.float32)
    vmin = jnp.min(x, axis=0)
    vmax = jnp.max(x, axis=0)
    scale = jnp.maximum(vmax - vmin, 1e-20) / float(levels)
    return vmin, scale


def sq8_train(x) -> tuple[jax.Array, jax.Array]:
    return sq_train(x, 255)


@functools.partial(jax.jit, static_argnames=("levels",))
def sq_quantize(x, vmin, scale, *, levels: int = 255):
    q = jnp.round((jnp.asarray(x, jnp.float32) - vmin[None, :])
                  / scale[None, :])
    return jnp.clip(q, 0, levels).astype(jnp.uint8)


def sq8_encode(x, vmin, scale):
    return sq_quantize(x, vmin, scale, levels=255)


def sq8_decode(codes, vmin, scale):
    return codes.astype(jnp.float32) * scale[None, :] + vmin[None, :]


# --- bit packing (host, ingest path) --------------------------------------

def sq4_pack(q: np.ndarray) -> np.ndarray:
    """(n, d) codes 0..15 → (n, ceil(d/2)) packed bytes, low nibble first."""
    q = np.asarray(q, np.uint8)
    n, d = q.shape
    if d % 2:
        q = np.concatenate([q, np.zeros((n, 1), np.uint8)], axis=1)
    return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)


def sq6_pack(q: np.ndarray) -> np.ndarray:
    """(n, d) codes 0..63 → (n, 3·ceil(d/4)) packed bytes."""
    q = np.asarray(q, np.uint16)
    n, d = q.shape
    pad = (-d) % 4
    if pad:
        q = np.concatenate([q, np.zeros((n, pad), np.uint16)], axis=1)
    g = q.reshape(n, -1, 4)
    b0 = (g[..., 0] << 2) | (g[..., 1] >> 4)
    b1 = ((g[..., 1] & 15) << 4) | (g[..., 2] >> 2)
    b2 = ((g[..., 2] & 3) << 6) | g[..., 3]
    return np.stack([b0, b1, b2], axis=-1).reshape(n, -1).astype(np.uint8)


def sq_code_width(d: int, codec: str) -> int:
    """Packed bytes per row for a codec."""
    if codec == "sq4":
        return (d + 1) // 2
    if codec == "sq6":
        return 3 * ((d + 3) // 4)
    return d  # sq8 and fp16 (fp16 rows are (d,) float16, not bytes)


# --- device decode (inside the scan kernels) ------------------------------

def _interleave_lanes(parts, step: int):
    """[p0..p_{step-1}] each (c, m) → (c, step*m) with part x at lanes
    x::step, via interior-dilated pads OR'd together.  The obvious
    ``jnp.stack(parts, -1).reshape`` materialises a (c, m, step) minor-
    step intermediate that a tiled layout can pad many times over — at
    an 8.8M-row graph walk's per-iteration decode, a multi-GB temp."""
    out = None
    for x, p in enumerate(parts):
        q = jax.lax.pad(p, p.dtype.type(0),
                        ((0, 0, 0), (x, step - 1 - x, step - 1)))
        out = q if out is None else out | q
    return out


def sq4_decode(packed, vmin, scale):
    d = vmin.shape[0]
    lo = packed & jnp.uint8(15)
    hi = packed >> jnp.uint8(4)
    q = _interleave_lanes((lo, hi), 2)[:, :d]
    return q.astype(jnp.float32) * scale[None, :] + vmin[None, :]


def sq6_decode(packed, vmin, scale):
    d = vmin.shape[0]
    b0 = packed[:, 0::3]
    b1 = packed[:, 1::3]
    b2 = packed[:, 2::3]
    c0 = b0 >> jnp.uint8(2)
    c1 = ((b0 & jnp.uint8(3)) << jnp.uint8(4)) | (b1 >> jnp.uint8(4))
    c2 = ((b1 & jnp.uint8(15)) << jnp.uint8(2)) | (b2 >> jnp.uint8(6))
    c3 = b2 & jnp.uint8(63)
    q = _interleave_lanes((c0, c1, c2, c3), 4)[:, :d]
    return q.astype(jnp.float32) * scale[None, :] + vmin[None, :]


def sq_decode(codes, vmin, scale, codec: str):
    """Codec dispatch: packed/quantized codes → (c, d) fp32."""
    if codec == "sq8":
        return sq8_decode(codes, vmin, scale)
    if codec == "sq4":
        return sq4_decode(codes, vmin, scale)
    if codec == "sq6":
        return sq6_decode(codes, vmin, scale)
    return codes.astype(jnp.float32)  # fp16


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "chunk", "precision", "codec"))
def sq_search(codes, nvalid, vmin, scale, xq, mask, metric_arg, *, k, metric,
              chunk, precision, codec="sq8"):
    """Fused decode+distance+top-k scan over quantized codes.

    codes: (cap, w) packed uint8 (sq8/sq4/sq6) or (cap, d) float16; same
    output conventions as flat_search."""
    cap, w = codes.shape
    nq = xq.shape[0]
    sim = metric in SIMILARITY_METRICS

    def body(i, carry):
        best_s, best_p = carry
        start = i * chunk
        cchunk = lax.dynamic_slice(codes, (start, 0), (chunk, w))
        xc = sq_decode(cchunk, vmin, scale, codec)
        dist = pairwise_tile(xq, xc, metric, metric_arg, precision)
        rowid = start + lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        valid = rowid < nvalid
        if mask is not None:
            mc = lax.dynamic_slice(mask, (start,), (chunk,))
            valid = jnp.logical_and(valid, mc[None, :])
        score = dist if sim else -dist
        score = jnp.where(valid, score, _NEG_INF)
        local_s, local_i = exact_topk(score, min(k, chunk))
        cat_s = jnp.concatenate([best_s, local_s], axis=1)
        cat_p = jnp.concatenate([best_p, start + local_i], axis=1)
        new_s, sel = lax.top_k(cat_s, k)
        return new_s, jnp.take_along_axis(cat_p, sel, axis=1)

    init = (jnp.full((nq, k), _NEG_INF, jnp.float32),
            jnp.full((nq, k), -1, jnp.int32))
    return lax.fori_loop(0, cap // chunk, body, init)


# --- int8 matmul scan (SQ8 / SQ4 / SQ6) -----------------------------------

#: code shift per codec: c' = c − shift keeps codes in int8 range
SQ_INT8_SHIFT = {"sq8": 128, "sq4": 8, "sq6": 32}


def sq_query_digits(u):
    """Two-digit int8 quantization of the query vector u (15-bit effective).

    A single int8 digit (u ≈ su·ui) carries ~0.4% relative error on the
    u·c term — far above the distance gaps between near-duplicate
    candidates in clustered corpora, where the true top-k then ranks
    ~randomly inside the int8 noise band and even a widened rerank pool
    misses it (the round-2 clustered-data regression).  Two digits drive
    the error down 128×: recentre u by its per-query mean μ (shrinks the
    digit scale), then ũ = u − μ ≈ su2·(128·hi + lo) with hi, lo int8
    (lo ∈ [−64, 64]), so ũ·c ≈ su2·(128·(hi·c) + (lo·c)) — two int8
    dots over the same code bytes.  The μ·Σc cross-term is exact via the
    per-row code sum (sq_row_sums).

    Returns (hi (nq,d) int8, lo (nq,d) int8, su2 (nq,), mu (nq,),
    sum_ut (nq,) = Σũ)."""
    mu = jnp.mean(u, axis=1)
    ut = u - mu[:, None]
    su2 = jnp.maximum(jnp.max(jnp.abs(ut), axis=1), 1e-30) / 16256.0
    q15 = jnp.clip(jnp.round(ut / su2[:, None]), -16256, 16256)
    hi = jnp.clip(jnp.round(q15 / 128.0), -127, 127)
    lo = q15 - 128.0 * hi
    return (hi.astype(jnp.int8), lo.astype(jnp.int8), su2, mu,
            jnp.sum(ut, axis=1))


def sq_row_sums(codes: np.ndarray, d: int, codec: str) -> np.ndarray:
    """Host-side per-row Σ_d c_d fp32 (raw code sum) for the recentred
    int8 scans, chunked like sq_row_norms."""
    n = codes.shape[0]
    rs = np.empty((n,), np.float32)
    step = max(1, (1 << 27) // max(d, 1))
    for i in range(0, n, step):
        c = sq_unpack_host(codes[i:i + step], d, codec)
        rs[i:i + step] = c.astype(np.float32).sum(axis=1)
    return rs


def sq4_unpack_host(packed: np.ndarray, d: int) -> np.ndarray:
    """Inverse of sq4_pack: (n, ceil(d/2)) bytes → (n, d) codes 0..15."""
    lo = packed & np.uint8(15)
    hi = packed >> 4
    return np.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)[:, :d]


def sq6_unpack_host(packed: np.ndarray, d: int) -> np.ndarray:
    """Inverse of sq6_pack: (n, 3·ceil(d/4)) bytes → (n, d) codes 0..63."""
    n = packed.shape[0]
    g = packed.reshape(n, -1, 3)
    b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
    c0 = b0 >> 2
    c1 = ((b0 & 3) << 4) | (b1 >> 4)
    c2 = ((b1 & 15) << 2) | (b2 >> 6)
    c3 = b2 & 63
    return np.stack([c0, c1, c2, c3], axis=-1).reshape(n, -1)[:, :d]


def sq_unpack_host(packed: np.ndarray, d: int, codec: str) -> np.ndarray:
    if codec == "sq4":
        return sq4_unpack_host(packed, d)
    if codec == "sq6":
        return sq6_unpack_host(packed, d)
    return packed                                    # sq8: already (n, d)


def sq_unpack_i8(packed, d: int, codec: str):
    """Device unpack: packed uint8 chunk → (chunk, d) int8 shifted codes
    (c − SQ_INT8_SHIFT[codec]) for the int8 matmul dot."""
    if codec == "sq8":
        return (packed.astype(jnp.int16) - 128).astype(jnp.int8)
    if codec == "sq4":
        lo = packed & jnp.uint8(15)
        hi = packed >> jnp.uint8(4)
        q = jnp.stack([lo, hi], axis=-1).reshape(packed.shape[0], -1)[:, :d]
        return (q.astype(jnp.int16) - 8).astype(jnp.int8)
    c = packed.shape[0]
    g = packed.reshape(c, -1, 3)
    b0, b1, b2 = g[..., 0], g[..., 1], g[..., 2]
    c0 = b0 >> jnp.uint8(2)
    c1 = ((b0 & jnp.uint8(3)) << jnp.uint8(4)) | (b1 >> jnp.uint8(4))
    c2 = ((b1 & jnp.uint8(15)) << jnp.uint8(2)) | (b2 >> jnp.uint8(6))
    c3 = b2 & jnp.uint8(63)
    q = jnp.stack([c0, c1, c2, c3], axis=-1).reshape(c, -1)[:, :d]
    return (q.astype(jnp.int16) - 32).astype(jnp.int8)


@functools.partial(
    jax.jit, static_argnames=("k", "k_scan", "metric", "chunk", "codec"))
def sq_int8_search(codes, row_norm, row_sum, nvalid, vmin, scale, xq, mask,
                   metric_arg, *, k, k_scan, metric, chunk, codec):
    """Int8-native scan for the quantized SQ codecs (L2 / INNER_PRODUCT).

    Reads the SAME packed uint8 code buffer as the decode path (no second
    corpus copy) and unpacks each chunk to shifted int8 in-register — the
    matmul runs its int8 mode and no fp32/bf16 decode intermediate ever
    materializes.  Codes are EXACT in the int8 dots (int32 accumulation);
    the query side uses the two-digit recentred quantization of
    sq_query_digits (15-bit effective — a single digit's noise swamps the
    tiny distance gaps between near-duplicate rows in clustered corpora),
    and a final decode+fp32 rerank of the widened top-k restores exact
    distances.

        L2: ‖q−x‖² = ‖t‖² − 2·u·c + Σscale²c²   (t = q−vmin, u = t⊙scale)
        IP: q·x     = q·vmin + u·c               (u = q⊙scale)
        u·c = ũ·c' + shift·Σũ + μ·Σc,  ũ = u − μ,  c' = c − shift
        ũ·c' ≈ su2·(128·(hi·c') + lo·c')

    ``row_norm``: per-row Σ_d (scale_d c_d)² fp32; ``row_sum``: per-row
    Σ_d c_d fp32 — both precomputed at ingest.  Returns the search_scan
    convention (max-oriented scores, -inf/-1 missing)."""
    cap = codes.shape[0]
    d = vmin.shape[0]
    nq = xq.shape[0]
    shift = float(SQ_INT8_SHIFT[codec])
    sim = metric == "INNER_PRODUCT"
    if sim:
        u = xq * scale[None, :]
        base = xq @ vmin                                   # (nq,) q·vmin
    else:
        t = xq - vmin[None, :]
        u = t * scale[None, :]
        base = jnp.sum(t * t, axis=1)                      # (nq,) ‖t‖²
    hi, lo, su2, mu, sum_ut = sq_query_digits(u)

    w = codes.shape[1]

    def body(i, carry):
        best_s, best_p = carry
        start = i * chunk
        cchunk = lax.dynamic_slice(codes, (start, 0), (chunk, w))
        ci8 = sq_unpack_i8(cchunk, d, codec)
        rchunk = lax.dynamic_slice(row_norm, (start,), (chunk,))
        rschunk = lax.dynamic_slice(row_sum, (start,), (chunk,))
        dot_hi = lax.dot_general(hi, ci8, (((1,), (1,)), ((), ())),
                                 preferred_element_type=jnp.int32)
        dot_lo = lax.dot_general(lo, ci8, (((1,), (1,)), ((), ())),
                                 preferred_element_type=jnp.int32)
        utc = su2[:, None] * (128.0 * dot_hi.astype(jnp.float32)
                              + dot_lo.astype(jnp.float32))
        uc = (utc + shift * sum_ut[:, None]
              + mu[:, None] * rschunk[None, :])
        if sim:
            score = base[:, None] + uc
        else:
            score = -jnp.maximum(base[:, None] - 2.0 * uc + rchunk[None, :],
                                 0.0)
        rowid = start + lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        valid = rowid < nvalid
        if mask is not None:
            mc = lax.dynamic_slice(mask, (start,), (chunk,))
            valid = jnp.logical_and(valid, mc[None, :])
        score = jnp.where(valid, score, _NEG_INF)
        local_s, local_i = exact_topk(score, min(k_scan, chunk))
        cat_s = jnp.concatenate([best_s, local_s], axis=1)
        cat_p = jnp.concatenate([best_p, start + local_i], axis=1)
        new_s, sel = lax.top_k(cat_s, k_scan)
        return new_s, jnp.take_along_axis(cat_p, sel, axis=1)

    init = (jnp.full((nq, k_scan), _NEG_INF, jnp.float32),
            jnp.full((nq, k_scan), -1, jnp.int32))
    s, pos = lax.fori_loop(0, cap // chunk, body, init)

    # Exact rerank: decode only the k_scan selected rows and score fp32
    # (same decode as the reference path, so distances match it).
    safe = jnp.maximum(pos, 0)
    xs = sq_decode(codes[safe].reshape(-1, w), vmin, scale,
                   codec).reshape(nq, k_scan, d)
    if sim:
        s2 = jnp.einsum("qd,qcd->qc", xq, xs,
                        precision=lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32)
    else:
        diff = xs - xq[:, None, :]
        s2 = -jnp.sum(diff * diff, axis=-1)
    s2 = jnp.where(pos >= 0, s2, _NEG_INF)
    s, sel = lax.top_k(s2, k)
    return s, jnp.take_along_axis(pos, sel, axis=1)


def sq_row_norms(codes: np.ndarray, scale: np.ndarray, d: int,
                 codec: str) -> np.ndarray:
    """Host-side per-row Σ_d (scale_d c_d)² fp32 for the int8 scans,
    computed in ≤512 MB staging chunks (codes may be bit-packed)."""
    n = codes.shape[0]
    rn = np.empty((n,), np.float32)
    s2 = (np.asarray(scale) * np.asarray(scale)).astype(np.float32)
    step = max(1, (1 << 27) // max(d, 1))
    for i in range(0, n, step):
        c = sq_unpack_host(codes[i:i + step], d, codec).astype(np.float32)
        rn[i:i + step] = (c * c) @ s2
    return rn
