"""Range search: all neighbors within a radius (faiss::Index::range_search).

Not reachable through the reference's SQL surface (its 12 functions cover
k-NN only) but part of the FAISS capability set behind it — provided for
completeness as a Python-level API (api.faiss_range_search).

Device design: result sizes are data-dependent, which XLA cannot shape.  The
split is: device computes dense distance tiles (the same matmul pairwise tile
as k-NN search, chunked over the corpus); the host thresholds each fetched
tile and builds the CSR (lims, labels, distances) result.  Exact for Flat /
SQ; IVF scans the probed lists only (same contract as
faiss::IndexIVF::range_search with a finite nprobe).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from .distance import pairwise_tile
from .flat_search import SIMILARITY_METRICS


class RangeSearchResult(NamedTuple):
    """CSR result: query q's neighbors are labels[lims[q]:lims[q+1]]
    (faiss::RangeSearchResult layout)."""

    lims: np.ndarray        # (nq + 1,) int64
    labels: np.ndarray      # (nres,) int64
    distances: np.ndarray   # (nres,) float32


def empty_range_result(nq: int) -> "RangeSearchResult":
    return RangeSearchResult(np.zeros((nq + 1,), np.int64),
                             np.empty((0,), np.int64),
                             np.empty((0,), np.float32))


@functools.partial(jax.jit, static_argnames=("metric", "precision"))
def _range_tile(xb_c, xq, metric_arg, *, metric, precision):
    return pairwise_tile(xq, xb_c, metric, metric_arg, precision)


@functools.partial(jax.jit,
                   static_argnames=("metric", "precision", "codec"))
def _range_tile_sq(codes_c, vmin, scale, xq, metric_arg, *, metric,
                   precision, codec):
    """SQ corpus chunk: decode on the fly, then the same pairwise tile."""
    from .sq import sq_decode

    return pairwise_tile(xq, sq_decode(codes_c, vmin, scale, codec), metric,
                         metric_arg, precision)


@functools.partial(jax.jit, static_argnames=("metric", "precision", "codec"))
def _range_tile_pq(codes_c, codebooks, xq, metric_arg, *, metric, precision,
                   codec="pq"):
    """Quantized corpus chunk: decode codes, then the pairwise tile."""
    if codec == "rq":
        from .rq import rq_decode as decode
    else:
        from .pq import pq_decode as decode

    return pairwise_tile(xq, decode(codes_c, codebooks), metric,
                         metric_arg, precision)


@functools.partial(jax.jit, static_argnames=("metric", "precision", "lmax"))
def _ivf_range_chunk(xb_sorted, offsets, counts, probes_c, xq_c,
                     metric_arg, *, metric, precision, lmax):
    """Distances of one query chunk against its probed lists' members.

    Probed lists are fetched as contiguous block slices of the row-sorted
    buffer (ivf_scan.slice_probed_lists).  Returns (dist (qc, nprobe·L),
    cand (qc, nprobe·L) sorted-row positions); invalid slots (rows outside
    the probed list's window) get a radius-failing distance (+inf for
    dissimilarity, -inf for similarity)."""
    from .ivf_scan import slice_probed_lists

    qc, nprobe = probes_c.shape
    L = min(lmax, xb_sorted.shape[0])
    ncand = nprobe * L
    xc, cand, valid = slice_probed_lists(xb_sorted, offsets, counts,
                                         probes_c, lmax=L)
    xc = xc.reshape(qc, ncand, xb_sorted.shape[1])
    cand = cand.reshape(qc, ncand)
    valid = valid.reshape(qc, ncand)
    if metric == "INNER_PRODUCT":
        dist = jnp.einsum("qd,qcd->qc", xq_c, xc, precision=precision,
                          preferred_element_type=jnp.float32)
    elif metric == "L2":
        diff = xc - xq_c[:, None, :]
        dist = jnp.sum(diff * diff, axis=-1)
    else:
        from .distance import elementwise_scores

        dist = elementwise_scores(xq_c[:, None, :], xc, metric, metric_arg)
    bad = jnp.float32(-np.inf if metric in SIMILARITY_METRICS else np.inf)
    dist = jnp.where(valid, dist, bad)
    return dist, cand


def range_scan_dense(get_tile, nchunks: int, chunk: int, ntotal: int,
                     nq: int, radius: float, metric: str,
                     passing: np.ndarray | None) -> RangeSearchResult:
    """Host driver: threshold device tiles chunk by chunk.

    get_tile(i) → (nq_pad, chunk) float32 distances for corpus rows
    [i·chunk, (i+1)·chunk); ``passing`` is the selector's per-row boolean
    (length ntotal) or None.  FAISS strictness: dissimilarity metrics keep
    d < radius, similarity metrics keep d > radius."""
    sim = metric in SIMILARITY_METRICS
    per_q: list[list[np.ndarray]] = [[] for _ in range(nq)]
    per_d: list[list[np.ndarray]] = [[] for _ in range(nq)]
    for i in range(nchunks):
        base = i * chunk
        nrows = min(chunk, ntotal - base)
        if nrows <= 0:
            break
        tile = np.asarray(get_tile(i))[:nq, :nrows]
        hit = (tile > radius) if sim else (tile < radius)
        if passing is not None:
            hit &= passing[base:base + nrows][None, :]
        qs, rs = np.nonzero(hit)
        for q in range(nq):
            sel = qs == q
            if np.any(sel):
                per_q[q].append(rs[sel] + base)
                per_d[q].append(tile[q, rs[sel]])
    lims = np.zeros((nq + 1,), np.int64)
    labels_parts, dist_parts = [], []
    for q in range(nq):
        rows = (np.concatenate(per_q[q]) if per_q[q]
                else np.empty((0,), np.int64))
        dists = (np.concatenate(per_d[q]) if per_d[q]
                 else np.empty((0,), np.float32))
        lims[q + 1] = lims[q] + rows.size
        labels_parts.append(rows.astype(np.int64))
        dist_parts.append(dists.astype(np.float32))
    return RangeSearchResult(
        lims,
        np.concatenate(labels_parts) if labels_parts
        else np.empty((0,), np.int64),
        np.concatenate(dist_parts) if dist_parts
        else np.empty((0,), np.float32))


def choose_range_chunk(cap: int) -> int:
    """Corpus rows per tile: bound the fetched (nq_pad, chunk) buffer.

    Chunks need NOT divide the capacity — the last tile is simply shorter
    (one extra jit shape).  Requiring exact division collapsed 1M-multiple
    capacities (small power-of-2 factors) into tiny chunks and tens of
    thousands of per-chunk round-trip fetches."""
    return max(1, min(cap, 1 << 16))


def range_num_chunks(cap: int, chunk: int) -> int:
    return -(-cap // chunk)
