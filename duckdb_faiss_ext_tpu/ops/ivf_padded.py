"""IVF scan over the padded list layout built by device-resident ingest.

Device-resident IVF (models/ivf_device.py) stores its lists as one padded
``(nlist, lmax, w)`` payload (SQ6: plane-major ``(nlist, 3·lmax, d4)``)
plus ``row_pos (nlist, lmax)`` (original row of each slot, -1 padding)
and ``counts (nlist,)``.  A probed list is one contiguous block of that
payload, so fetching a query's probes is ``payload[probe_ids]`` — a
gather of whole ``(lmax, w)`` blocks, which the GPU serves as coalesced
copies.  Scoring follows the sorted-layout scans of ops/ivf_scan.py:

* Flat payloads score at ``precision`` and, in fast mode, re-score a
  widened top-k at HIGHEST (inchunk_exact_rerank);
* SQ8/SQ4/SQ6 payloads score with the recentred two-digit int8 dots of
  ops/sq.py::sq_query_digits straight from the code bytes, then decode
  only the widened top-k and re-score it exactly in fp32.

The scan is chunked over queries so the gathered candidate tile stays
within a fixed share of device memory (utils/config.memory_budget).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.config import memory_budget
from .flat_search import _NEG_INF, exact_topk
from .ivf_scan import inchunk_exact_rerank, inchunk_rerank_kscan
from .sq import SQ_INT8_SHIFT, sq_decode, sq_query_digits, sq_unpack_i8

#: share of device memory one query chunk's gathered candidate tile
#: (packed rows plus their int8 or fp32 working copy) may take.
TILE_MEMORY_FRACTION = 1 / 64


def choose_lmax(counts_max: int) -> int:
    """Padded list length: powers of two from 128 up to 512, then the next
    multiple of 512 (pure power-of-two padding wastes up to 2x the payload
    on long lists)."""
    if counts_max <= 512:
        lmax = 128
        while lmax < counts_max:
            lmax *= 2
        return lmax
    return 512 * -(-counts_max // 512)


def padded_lmax(payload, codec: str | None) -> int:
    """List length of a padded payload (SQ6 folds 3 planes into axis 1)."""
    return payload.shape[1] // 3 if codec == "sq6" else payload.shape[1]


def choose_padded_q_chunk(nq: int, ncand: int, row_bytes: int) -> int:
    """Queries per scan step: the largest power of two dividing ``nq``
    whose gathered (q, ncand, row_bytes) tile fits the memory share."""
    budget = max(1, memory_budget(TILE_MEMORY_FRACTION)
                 // max(ncand * row_bytes, 1))
    q = 1
    while q * 2 <= min(budget, nq) and nq % (q * 2) == 0:
        q *= 2
    return q


def gather_lists(payload, probes, *, codec: str | None):
    """Probed list blocks as row-major rows: (qc, nprobe·lmax, w).

    SQ6 payloads are plane-major (byte b of every 3-byte group of slot s
    at row b·lmax + s); the gathered planes are interleaved back into the
    packed row layout sq_unpack_i8 / sq_decode read."""
    qc, nprobe = probes.shape
    blocks = payload[probes]                  # (qc, nprobe, rows, w')
    if codec == "sq6":
        _, _, l3, d4 = blocks.shape
        lmax = l3 // 3
        blocks = (blocks.reshape(qc, nprobe, 3, lmax, d4)
                  .transpose(0, 1, 3, 4, 2)
                  .reshape(qc, nprobe, lmax, 3 * d4))
    return blocks.reshape(qc, -1, blocks.shape[-1])


@functools.partial(
    jax.jit,
    static_argnames=("k", "k_scan", "metric", "codec", "q_chunk",
                     "precision"),
)
def ivf_padded_search(
    payload,       # (nlist, lmax, w) fp32 rows / uint8 codes; SQ6 plane-major
    counts,        # (nlist,) int32 valid slots per list
    row_pos,       # (nlist, lmax) int32 original row of each slot, -1 padding
    row_norm,      # (nlist, lmax) fp32 Σ(scale·c)² per slot (SQ) or None
    row_sum,       # (nlist, lmax) fp32 Σc per slot (SQ) or None
    vmin,          # (d,) fp32 SQ ranges or None
    scale,
    probe_ids,     # (nq, nprobe) int32
    xq,            # (nq, d) fp32
    mask,          # (nlist, lmax) int8 selector mask or None
    *,
    k: int,
    k_scan: int,
    metric: str,
    codec: str | None,
    q_chunk: int,
    precision,
):
    """Exact scan of the probed lists.  Returns (scores (nq, k)
    max-oriented with -inf missing, original row positions (nq, k) int32
    with -1 missing).  ``k_scan`` is the int8 ranking pool of SQ codecs
    (ignored for Flat payloads, whose pool follows ``precision``)."""
    nq, d = xq.shape
    nprobe = probe_ids.shape[1]
    lmax = padded_lmax(payload, codec)
    ncand = nprobe * lmax
    sim = metric == "INNER_PRODUCT"
    lane = lax.broadcasted_iota(jnp.int32, (1, 1, lmax), 2)

    if codec is None:
        k_scan = inchunk_rerank_kscan(k, ncand, metric, precision)
    else:
        shift = float(SQ_INT8_SHIFT[codec])
        if sim:
            u = xq * scale[None, :]
            base = xq @ vmin
        else:
            t = xq - vmin[None, :]
            u = t * scale[None, :]
            base = jnp.sum(t * t, axis=1)
        hi, lo, su2, mu, sum_ut = sq_query_digits(u)

    def scan_chunk(i, carry):
        best_s, best_p = carry
        q0 = i * q_chunk
        xq_c = lax.dynamic_slice(xq, (q0, 0), (q_chunk, d))
        probes_c = lax.dynamic_slice(probe_ids, (q0, 0), (q_chunk, nprobe))
        rows = gather_lists(payload, probes_c, codec=codec)
        valid = (lane < counts[probes_c][:, :, None]).reshape(q_chunk, ncand)
        if mask is not None:
            valid = jnp.logical_and(
                valid, mask[probes_c].reshape(q_chunk, ncand) != 0)
        pos = row_pos[probes_c].reshape(q_chunk, ncand)
        if codec is None:
            xy = jnp.einsum("qd,qcd->qc", xq_c, rows, precision=precision,
                            preferred_element_type=jnp.float32)
            if sim:
                score = xy
            else:
                qn = jnp.sum(xq_c * xq_c, axis=1, keepdims=True)
                bn = jnp.sum(rows * rows, axis=2)
                score = -jnp.maximum(qn - 2.0 * xy + bn, 0.0)
            score = jnp.where(valid, score, _NEG_INF)
            s, sel = inchunk_exact_rerank(xq_c, rows, score, k=k,
                                          k_scan=k_scan, metric=metric)
        else:
            w = rows.shape[2]
            xc8 = sq_unpack_i8(rows.reshape(-1, w), d,
                               codec).reshape(q_chunk, ncand, d)
            hi_c = lax.dynamic_slice(hi, (q0, 0), (q_chunk, d))
            lo_c = lax.dynamic_slice(lo, (q0, 0), (q_chunk, d))
            dot_hi = jnp.einsum("qd,qcd->qc", hi_c, xc8,
                                preferred_element_type=jnp.int32)
            dot_lo = jnp.einsum("qd,qcd->qc", lo_c, xc8,
                                preferred_element_type=jnp.int32)
            su2_c = lax.dynamic_slice(su2, (q0,), (q_chunk,))
            mu_c = lax.dynamic_slice(mu, (q0,), (q_chunk,))
            sumut_c = lax.dynamic_slice(sum_ut, (q0,), (q_chunk,))
            base_c = lax.dynamic_slice(base, (q0,), (q_chunk,))
            rs = row_sum[probes_c].reshape(q_chunk, ncand)
            uc = (su2_c[:, None] * (128.0 * dot_hi.astype(jnp.float32)
                                    + dot_lo.astype(jnp.float32))
                  + shift * sumut_c[:, None] + mu_c[:, None] * rs)
            if sim:
                score = base_c[:, None] + uc
            else:
                rn = row_norm[probes_c].reshape(q_chunk, ncand)
                score = -jnp.maximum(base_c[:, None] - 2.0 * uc + rn, 0.0)
            score = jnp.where(valid, score, _NEG_INF)
            s, sel = exact_topk(score, k_scan)
            # Exact rerank: decode only the selected rows, score in fp32.
            picked = jnp.take_along_axis(rows, sel[:, :, None], axis=1)
            xs = sq_decode(picked.reshape(-1, w), vmin, scale,
                           codec).reshape(q_chunk, k_scan, d)
            if sim:
                s2 = jnp.einsum("qd,qcd->qc", xq_c, xs,
                                precision=lax.Precision.HIGHEST,
                                preferred_element_type=jnp.float32)
            else:
                diff = xs - xq_c[:, None, :]
                s2 = -jnp.sum(diff * diff, axis=-1)
            s2 = jnp.where(jnp.isneginf(s), _NEG_INF, s2)
            s, sel2 = lax.top_k(s2, k)
            sel = jnp.take_along_axis(sel, sel2, axis=1)
        p = jnp.take_along_axis(pos, sel, axis=1)
        p = jnp.where(jnp.isneginf(s), -1, p)
        best_s = lax.dynamic_update_slice(best_s, s, (q0, 0))
        best_p = lax.dynamic_update_slice(best_p, p, (q0, 0))
        return best_s, best_p

    init = (jnp.full((nq, k), _NEG_INF, jnp.float32),
            jnp.full((nq, k), -1, jnp.int32))
    return lax.fori_loop(0, nq // q_chunk, scan_chunk, init)
