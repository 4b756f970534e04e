"""Fused brute-force k-NN search: blocked distance scan + top-k.

Device replacement for the reference's hot path — ``Index::search`` under
``faiss_lock`` (src/faiss_extension.cpp:629-638), which in FAISS is a BLAS
GEMM plus a per-query heap select.  On a single GPU, L2/inner-product
searches with small k take the fused kernel of ops/flat_topk.py instead;
this scan serves every other case.

Blocking strategy: query-blocked, corpus-wide — for each block of ≤256
queries, one matmul produces a (qb, C) score tile (bounded to a share of
device memory, SCORE_TILE_FRACTION) and ONE top-k selects from it.  The
score tile is transient and XLA reuses the buffer across blocks.

Semantics mirrored from FAISS:
* Results are sorted best-first ("rank" order in the output schema).
* Fewer than k valid candidates → position -1 and a sentinel distance
  (+inf for distance metrics, -inf for similarity metrics).
* Similarity metrics (INNER_PRODUCT, Jaccard) select max; others select min.

``search_scan`` is the same computation against one (local) corpus buffer
returning max-oriented scores (-inf = missing) and *global* row positions
(``row_offset``) so parallel/sharded.py can merge shard results with one
more top-k under shard_map.  An optional ``mask`` (bool per corpus row)
implements filtered search as a semi-join fused into the scan — the device
equivalent of FAISS's IDSelector consulted inside scan loops
(src/faiss_extension.cpp:959,1008).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.config import memory_budget
from .distance import pairwise_tile

# Metrics where larger is better (FAISS is_similarity_metric).
SIMILARITY_METRICS = frozenset({"INNER_PRODUCT", "Jaccard"})

_NEG_INF = float("-inf")

#: share of device memory the (q_block, c_block) fp32 score tile may take
SCORE_TILE_FRACTION = 1 / 16


from ..utils.config import next_pow2 as _next_pow2


def choose_blocks(cap: int, nq: int, d: int, metric: str,
                  k: int = 1) -> tuple[int, int]:
    """(q_block, c_block): per-step tile is (q_block, c_block) fp32 scores.

    Matmul metrics: bound the score tile to SCORE_TILE_FRACTION of device
    memory so the corpus-wide top_k stays a single call for corpora of
    millions of rows.  Elementwise metrics also
    bound the (q, c, d) broadcast.  Both blocks are powers of two dividing
    the (power-of-two) padded shapes; c_block is never below k (the
    per-block top-k needs k candidates per step)."""
    qb = min(nq, 256)
    if metric in ("INNER_PRODUCT", "L2"):
        budget_elems = memory_budget(SCORE_TILE_FRACTION) // 4
        cb = max(1024, budget_elems // qb)
    else:
        cb = max(128, (1 << 24) // max(qb * d, 1))
    cb = max(cb, k)
    return qb, min(cap, _next_pow2(min(cb, cap)))


def exact_topk(scores, k: int):
    """Exact top-k over a wide score matrix via window-max prefiltering.

    Reshape (Q, N) → (Q, N/128, 128) windows; every element of the true
    top-k lives in one of the top-k windows ranked by window max (≤ k
    windows can have max ≥ the k-th best value), so selecting k windows and
    rescanning k·128 candidates is exact.  The window max is a cheap
    reduction, so this replaces one TopK over N with one over N/128 plus
    one over k·128 — much cheaper for large N."""
    q, n = scores.shape
    w = 128
    if n % w or n // w < k or n <= 4096:
        return lax.top_k(scores, k)
    win = scores.reshape(q, n // w, w)
    wmax = jnp.max(win, axis=2)
    _, widx = lax.top_k(wmax, k)                           # (q, k)
    cand = jnp.take_along_axis(win, widx[:, :, None], axis=1)
    vals, ci = lax.top_k(cand.reshape(q, k * w), k)
    wsel = jnp.take_along_axis(widx, ci // w, axis=1)
    return vals, wsel * w + (ci % w)


def search_scan(xb, nvalid, xq, mask, metric_arg, row_offset,
                *, k, metric, q_block, c_block, precision):
    """Blocked scan over a (cap, d) corpus buffer; returns (scores (nq, k),
    positions (nq, k) int32).  Scores are max-oriented (negated distances for
    min metrics) with -inf marking missing; positions are global
    (``row_offset`` + local row).  ``nvalid`` bounds the *global* row id."""
    cap, d = xb.shape
    nq = xq.shape[0]
    sim = metric in SIMILARITY_METRICS
    n_qb = nq // q_block
    n_cb = cap // c_block

    def query_block(qi, out):
        out_s, out_p = out
        q0 = qi * q_block
        xqc = lax.dynamic_slice(xq, (q0, 0), (q_block, d))

        def corpus_block(ci, carry):
            best_s, best_p = carry
            c0 = ci * c_block
            xc = lax.dynamic_slice(xb, (c0, 0), (c_block, d))
            dist = pairwise_tile(xqc, xc, metric, metric_arg, precision)
            rowid = row_offset + c0 + lax.broadcasted_iota(
                jnp.int32, (1, c_block), 1)
            valid = rowid < nvalid
            if mask is not None:
                mc = lax.dynamic_slice(mask, (c0,), (c_block,))
                valid = jnp.logical_and(valid, mc[None, :])
            score = dist if sim else -dist
            score = jnp.where(valid, score, _NEG_INF)
            # Local exact top-k over the block, then a tiny 2k-wide merge
            # with the carry.  Carry slots first: earlier blocks win ties
            # (top_k prefers the lower index) → deterministic order.
            local_s, local_i = exact_topk(score, k)
            local_p = row_offset + c0 + local_i.astype(jnp.int32)
            cat_s = jnp.concatenate([best_s, local_s], axis=1)
            cat_p = jnp.concatenate([best_p, local_p], axis=1)
            new_s, sel = lax.top_k(cat_s, k)
            return new_s, jnp.take_along_axis(cat_p, sel, axis=1)

        init = (jnp.full((q_block, k), _NEG_INF, jnp.float32),
                jnp.full((q_block, k), -1, jnp.int32))
        bs, bp = lax.fori_loop(0, n_cb, corpus_block, init)
        out_s = lax.dynamic_update_slice(out_s, bs, (q0, 0))
        out_p = lax.dynamic_update_slice(out_p, bp, (q0, 0))
        return out_s, out_p

    init_out = (jnp.full((nq, k), _NEG_INF, jnp.float32),
                jnp.full((nq, k), -1, jnp.int32))
    return lax.fori_loop(0, n_qb, query_block, init_out)


def finalize_scores(scores, positions, metric):
    """Convert max-oriented scores to the output distance convention with
    FAISS sentinels for missing slots."""
    sim = metric in SIMILARITY_METRICS
    missing = jnp.isneginf(scores)
    dist = scores if sim else -scores
    sentinel = _NEG_INF if sim else float("inf")
    dist = jnp.where(missing, sentinel, dist)
    positions = jnp.where(missing, -1, positions)
    return dist, positions


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "q_block", "c_block", "precision"),
)
def _flat_search(xb, nvalid, xq, mask, metric_arg, *, k, metric, q_block,
                 c_block, precision):
    scores, pos = search_scan(
        xb, nvalid, xq, mask, metric_arg, jnp.int32(0),
        k=k, metric=metric, q_block=q_block, c_block=c_block,
        precision=precision)
    return finalize_scores(scores, pos, metric)


def flat_search(
    xb_pad: jax.Array,      # (cap, d) fp32, cap a power of two
    nvalid,                 # scalar int32: valid rows in xb_pad
    xq_pad: jax.Array,      # (nq_pad, d) fp32, nq_pad a power of two
    k: int,
    metric: str,
    metric_arg: float = 0.0,
    mask: jax.Array | None = None,  # (cap,) bool or None
    precision=lax.Precision.HIGHEST,
):
    """Fused search over a padded corpus.  Returns (distances (nq_pad, k) fp32,
    positions (nq_pad, k) int32; -1 where fewer than k candidates)."""
    cap, d = xb_pad.shape
    if k > cap:
        raise ValueError(f"k={k} exceeds padded capacity {cap}; caller must clamp")
    qb, cb = choose_blocks(cap, xq_pad.shape[0], d, metric, k)
    # Sharded placements can round cap to a non-power-of-two multiple of the
    # device count; the block loop must still cover every row, so c_block is
    # clamped to the largest power-of-two divisor of cap.
    cb = min(cb, cap & -cap) if cap & -cap >= k else cap
    if cap % cb:
        cb = cap
    return _flat_search(
        xb_pad,
        jnp.asarray(nvalid, jnp.int32),
        xq_pad,
        mask,
        jnp.asarray(metric_arg, jnp.float32),
        k=k,
        metric=metric,
        q_block=qb,
        c_block=cb,
        precision=precision,
    )


# Backwards-compatible alias used by the sharded path and IVF chunk sizing.
def choose_chunk(cap: int, nq: int, d: int, metric: str) -> int:
    return choose_blocks(cap, nq, d, metric)[1]
