"""IVF search: coarse-quantizer assignment + gathered inverted-list scan.

Device replacement for faiss::IndexIVF::search as the reference drives it
(nprobe + nested quantizer params, src/faiss_extension.cpp:675-689).  FAISS
walks per-list arrays with scalar loops; here:

* coarse assignment is one (Q × nlist) distance tile + top-nprobe;
* the inverted lists live as one row-sorted corpus buffer plus (offsets,
  counts) int32 list metadata, so "scan the probed lists" is nprobe
  contiguous (Lmax, w) dynamic slices per query (slice_probed_lists)
  followed by batched distances and one top-k — no data-dependent shapes
  anywhere, which is what XLA needs.

Exactness: candidates are exactly the members of the probed lists, so
results match FAISS given identical centroids/assignments (the seeded
k-means of ops/kmeans.py).

The scan is chunked over queries to bound the gathered (q, nprobe·Lmax, d)
tile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .distance import pairwise_tile
from .flat_search import SIMILARITY_METRICS, _NEG_INF, exact_topk

#: spill-scan membership: up to this many probes, per-probe equality
#: compares (nprobe fused (nq, sc) elementwise passes) replace the
#: one-hot row-gather + transpose (see ivf_spill_scan).
MEMBERSHIP_CMP_MAX = 32


def inchunk_rerank_kscan(k: int, ncand: int, metric: str, precision) -> int:
    """Widened candidate count for the fast-mode in-chunk exact rerank:
    reduced-precision scans (TF32 on the GPU) lose top-k agreement with
    fp32, so take a wider top-k and re-score those rows at HIGHEST
    (< k_scan/ncand extra work).  Returns k when no rerank applies (exact
    precisions, elementwise metrics — already fp32)."""
    if metric not in ("INNER_PRODUCT", "L2") or \
            precision == lax.Precision.HIGHEST:
        return k
    return min(ncand, max(2 * k, k + 16))


def slice_probed_lists(sorted_buf, offsets, counts, probes_c, *, lmax):
    """Fetch probed lists as CONTIGUOUS block slices from the row-sorted
    buffer: one (lmax, w) dynamic slice per (query, probe) instead of one
    row gather per candidate — XLA lowers the double-vmap to a gather
    whose slice size is (lmax, w), i.e. ~lmax× fewer index entries than a
    per-row gather.

    Returns (xc (qc, nprobe, lmax, w), pos (qc, nprobe, lmax) int32 sorted
    positions, valid (qc, nprobe, lmax) bool).  Lists shorter than lmax
    read into the next list's rows; those rows are masked invalid (they
    are valid candidates only in their OWN probed window)."""
    cap, w = sorted_buf.shape
    L = min(lmax, cap)
    starts_true = offsets[probes_c]                       # (qc, nprobe)
    starts = jnp.minimum(starts_true, cap - L)
    lane = lax.broadcasted_iota(jnp.int32, (1, 1, L), 2)
    pos = starts[:, :, None] + lane                       # sorted positions
    list_end = starts_true + counts[probes_c]
    valid = jnp.logical_and(pos >= starts_true[:, :, None],
                            pos < list_end[:, :, None])

    def get(s):
        return lax.dynamic_slice(sorted_buf, (s, 0), (L, w))

    xc = jax.vmap(jax.vmap(get))(starts)                  # (qc, np, L, w)
    return xc, pos, valid


def inchunk_exact_rerank(xq_c, xc, score, *, k, k_scan, metric):
    """Top-k_scan over reduced-precision ``score`` (qc, ncand), then
    HIGHEST re-score of the selected rows from the in-scope candidate
    tile ``xc`` (qc, ncand, d).  Returns (s (qc, k) max-oriented, sel
    (qc, k) candidate indices).  -inf (missing/masked) slots stay
    missing."""
    s, sel = exact_topk(score, k_scan)
    if k_scan == k:
        return s, sel
    xs = jnp.take_along_axis(xc, sel[:, :, None], axis=1)  # (qc, k_scan, d)
    xy2 = jnp.einsum("qd,qcd->qc", xq_c, xs,
                     precision=lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)
    if metric == "INNER_PRODUCT":
        s2 = xy2
    else:  # L2 (max-oriented: negated)
        qn2 = jnp.sum(xq_c * xq_c, axis=1, keepdims=True)
        bn2 = jnp.sum(xs * xs, axis=2)
        s2 = -jnp.maximum(qn2 - 2.0 * xy2 + bn2, 0.0)
    s2 = jnp.where(jnp.isneginf(s), _NEG_INF, s2)
    s, sel2 = lax.top_k(s2, k)
    return s, jnp.take_along_axis(sel, sel2, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "metric", "q_chunk", "precision",
                     "lmax"),
)
def ivf_search(
    xb_sorted,     # (cap, d) fp32, rows grouped by list
    offsets,       # (nlist,) int32 start of each list in the sorted buffer
    counts,        # (nlist,) int32 list sizes
    centroids,     # (nlist, d) fp32
    xq,            # (nq_pad, d) fp32
    mask,          # (cap,) bool or None — selector semi-join over sorted rows
    metric_arg,
    *,
    k: int,
    nprobe: int,
    metric: str,
    q_chunk: int,
    precision,
    lmax: int,
):
    """Returns (scores (nq, k) max-oriented with -inf missing, sorted-row
    positions (nq, k) int32 with -1 missing).  Probed lists are fetched as
    contiguous block slices (see slice_probed_lists)."""
    nq, d = xq.shape
    nlist = centroids.shape[0]
    sim = metric in SIMILARITY_METRICS
    nprobe = min(nprobe, nlist)

    # --- coarse assignment: top-nprobe lists per query (one matmul) ----
    cdist = pairwise_tile(xq, centroids, metric, metric_arg, precision)
    cscore = cdist if sim else -cdist
    _, probe_ids = lax.top_k(cscore, nprobe)              # (nq, nprobe)

    L = min(lmax, xb_sorted.shape[0])
    ncand = nprobe * L
    k_scan = inchunk_rerank_kscan(k, ncand, metric, precision)
    maskbuf = mask[:, None] if mask is not None else None

    def scan_chunk(i, carry):
        best_s, best_p = carry
        q0 = i * q_chunk
        xq_c = lax.dynamic_slice(xq, (q0, 0), (q_chunk, d))
        probes_c = lax.dynamic_slice(probe_ids, (q0, 0), (q_chunk, nprobe))
        xc, pos, valid = slice_probed_lists(xb_sorted, offsets, counts,
                                            probes_c, lmax=L)
        xc = xc.reshape(q_chunk, ncand, d)
        pos = pos.reshape(q_chunk, ncand)
        valid = valid.reshape(q_chunk, ncand)
        if metric == "INNER_PRODUCT":
            dist = jnp.einsum("qd,qcd->qc", xq_c, xc,
                              precision=precision,
                              preferred_element_type=jnp.float32)
        elif metric == "L2":
            qn = jnp.sum(xq_c * xq_c, axis=1, keepdims=True)
            bn = jnp.sum(xc * xc, axis=2)
            xy = jnp.einsum("qd,qcd->qc", xq_c, xc,
                            precision=precision,
                            preferred_element_type=jnp.float32)
            dist = jnp.maximum(qn - 2.0 * xy + bn, 0.0)
        else:
            # Batched elementwise metrics: (qc, 1, d) vs (qc, ncand, d).
            from .distance import elementwise_scores

            dist = elementwise_scores(xq_c[:, None, :], xc, metric,
                                      metric_arg)
        if mask is not None:
            mc, _, _ = slice_probed_lists(maskbuf, offsets, counts,
                                          probes_c, lmax=L)
            valid = jnp.logical_and(valid,
                                    mc.reshape(q_chunk, ncand))
        score = dist if sim else -dist
        score = jnp.where(valid, score, _NEG_INF)
        s, sel = inchunk_exact_rerank(xq_c, xc, score, k=k, k_scan=k_scan,
                                      metric=metric)
        p = jnp.take_along_axis(pos, sel, axis=1)
        p = jnp.where(jnp.isneginf(s), -1, p)
        best_s = lax.dynamic_update_slice(best_s, s, (q0, 0))
        best_p = lax.dynamic_update_slice(best_p, p, (q0, 0))
        return best_s, best_p

    init = (
        jnp.full((nq, k), _NEG_INF, jnp.float32),
        jnp.full((nq, k), -1, jnp.int32),
    )
    best_s, best_p = lax.fori_loop(0, nq // q_chunk, scan_chunk, init)
    return best_s, best_p




@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "metric", "q_chunk", "precision",
                     "codec", "lmax"),
)
def ivf_pq_search(
    codes_sorted,   # (cap, m) uint8, rows grouped by list
    codebooks,      # (m, ksub, dsub) fp32 residual codebooks
    offsets,        # (nlist,) int32 list starts in the sorted buffer
    counts,         # (nlist,) int32 list sizes
    centroids,      # (nlist, d) fp32
    xq,             # (nq_pad, d) fp32
    mask,
    metric_arg,
    *,
    k: int,
    nprobe: int,
    metric: str,
    q_chunk: int,
    precision,
    codec: str = "pq",
    lmax: int = 128,
):
    """IVF with PQ- or RQ-encoded residuals (faiss IndexIVFPQ /
    IndexIVFResidualQuantizer analogue, by_residual): candidate
    reconstruction = centroid[list] + decode(code), then the same matmul
    distance tile as the Flat scan — identical results to residual
    LUT-ADC for L2/IP with only byte codes read from HBM."""
    from .pq import codec_decode

    nq, d = xq.shape
    nlist = centroids.shape[0]
    sim = metric in SIMILARITY_METRICS
    nprobe = min(nprobe, nlist)

    cdist = pairwise_tile(xq, centroids, metric, metric_arg, precision)
    cscore = cdist if sim else -cdist
    _, probe_ids = lax.top_k(cscore, nprobe)

    L = min(lmax, codes_sorted.shape[0])
    ncand = nprobe * L
    m = codes_sorted.shape[1]
    # Fast-mode in-chunk rerank vs the DECODED rows: removes the TF32
    # matmul noise on top of the codec error (parity with the fp32 ADC
    # scan FAISS computes); the codec error itself is the storage choice.
    k_scan = inchunk_rerank_kscan(k, ncand, metric, precision)
    maskbuf = mask[:, None] if mask is not None else None

    def scan_chunk(i, carry):
        best_s, best_p = carry
        q0 = i * q_chunk
        xq_c = lax.dynamic_slice(xq, (q0, 0), (q_chunk, d))
        probes_c = lax.dynamic_slice(probe_ids, (q0, 0), (q_chunk, nprobe))
        codes_c, pos, valid = slice_probed_lists(
            codes_sorted, offsets, counts, probes_c, lmax=L)
        pos = pos.reshape(q_chunk, ncand)
        valid = valid.reshape(q_chunk, ncand)
        resid = codec_decode(codes_c.reshape(-1, m), codebooks, codec)
        # Every row in a probed window belongs to that window's list (other
        # lists' rows are masked), so the residual base is the PROBED
        # centroid broadcast over the window.
        cent_c = centroids[probes_c][:, :, None, :]        # (qc, np, 1, d)
        xc = (resid.reshape(q_chunk, nprobe, L, d)
              + cent_c).reshape(q_chunk, ncand, d)
        if metric == "INNER_PRODUCT":
            dist = jnp.einsum("qd,qcd->qc", xq_c, xc, precision=precision,
                              preferred_element_type=jnp.float32)
        else:  # L2
            qn = jnp.sum(xq_c * xq_c, axis=1, keepdims=True)
            bn = jnp.sum(xc * xc, axis=2)
            xy = jnp.einsum("qd,qcd->qc", xq_c, xc, precision=precision,
                            preferred_element_type=jnp.float32)
            dist = jnp.maximum(qn - 2.0 * xy + bn, 0.0)
        if mask is not None:
            mc, _, _ = slice_probed_lists(maskbuf, offsets, counts,
                                          probes_c, lmax=L)
            valid = jnp.logical_and(valid, mc.reshape(q_chunk, ncand))
        score = dist if sim else -dist
        score = jnp.where(valid, score, _NEG_INF)
        s, sel = inchunk_exact_rerank(xq_c, xc, score, k=k, k_scan=k_scan,
                                      metric=metric)
        p = jnp.take_along_axis(pos, sel, axis=1)
        p = jnp.where(jnp.isneginf(s), -1, p)
        best_s = lax.dynamic_update_slice(best_s, s, (q0, 0))
        best_p = lax.dynamic_update_slice(best_p, p, (q0, 0))
        return best_s, best_p

    init = (
        jnp.full((nq, k), _NEG_INF, jnp.float32),
        jnp.full((nq, k), -1, jnp.int32),
    )
    return lax.fori_loop(0, nq // q_chunk, scan_chunk, init)


def choose_q_chunk(nq: int, ncand: int, d: int) -> int:
    """Queries per scan step: bound the gathered (q, ncand, d) fp32 tile."""
    budget = max(1, (1 << 24) // max(ncand * d, 1))
    q = 1
    while q * 2 <= min(budget, nq):
        q *= 2
    return q


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "precision", "pq", "codec", "sq",
                     "n_used", "int8_dot", "rerank_qb",
                     "membership"))
def ivf_spill_scan(spill_payload, spill_assign, spill_pos, centroids,
                   codebooks, probe_ids, xq, mask, metric_arg, *,
                   k, metric, precision, pq=False, codec="pq",
                   sq=None, sq_vmin=None, sq_scale=None,
                   n_used: int | None = None,
                   spill_rn=None, spill_rs=None, int8_dot: bool = False,
                   rerank_qb: int | None = None,
                   membership: str = "auto"):
    """Scan the IVF overflow-spill region: rows whose list exceeded the
    fixed lmax of the device-resident padded layout (models/ivf_device.py).

    Every spill row is scored against every query, then masked to rows
    whose list is in that query's probe set — exact IVF semantics (a
    candidate is returned iff its list was probed), with the tail of the
    skew distribution riding one dense matmul tile instead of exploding the
    padded (nlist, lmax, ·) layout.

    spill_payload: (s_pad, d) fp32 rows, or (s_pad, m) uint8 codes when
    ``pq`` (decoded + centroid[assign] like the main PQ path);
    spill_pos: (s_pad,) int32 original-row position, -1 padding.
    Returns (scores (nq, k) max-oriented, positions (nq, k)).
    """
    nq = xq.shape[0]
    nlist = centroids.shape[0]
    s_pad, w = spill_payload.shape
    sim = metric in SIMILARITY_METRICS

    # Probed-list membership.  For small nprobe, an unrolled loop of
    # equality compares: probed[q, r] = OR_j (probe_ids[q, j] == asg[r])
    # — nprobe fused (nq, sc) elementwise passes with no gather and no
    # transpose.  Past MEMBERSHIP_CMP_MAX probes the compare loop costs
    # more than a one-hot row-gather; keep that path there.
    nprobe = probe_ids.shape[1]
    cmp_membership = (nprobe <= MEMBERSHIP_CMP_MAX
                      if membership == "auto" else membership == "cmp")
    if not cmp_membership:
        qidx = lax.broadcasted_iota(jnp.int32, probe_ids.shape, 0)
        onehot_t = (jnp.zeros((nlist, nq), jnp.bool_)
                    .at[probe_ids, qidx].set(True))

    if pq:
        d = codebooks.shape[0] * codebooks.shape[2]
    elif sq is not None:
        d = sq_vmin.shape[0]
    else:
        d = w

    def decode(chunk_payload, chunk_assign):
        if pq:
            from .pq import codec_decode

            return codec_decode(chunk_payload, codebooks, codec) \
                + centroids[chunk_assign]
        if sq is not None:
            from .sq import sq_decode

            return sq_decode(chunk_payload, sq_vmin, sq_scale, sq)
        return chunk_payload

    # Chunk the scan so the decoded fp32 tile stays bounded — a 5M-row SQ
    # spill of 1536-dim rows decoded in one piece is a 30 GB allocation;
    # a large spill region is otherwise valid.
    mxu = metric in ("INNER_PRODUCT", "L2")
    # Decode-free int8 scoring (same recentred two-digit scheme as the
    # padded kernels) when the caller provides per-row Σ(scale·c)²/Σc:
    # the rerank below restores exact distances either way.
    use_int8 = (int8_dot and mxu and spill_rn is not None
                and sq in ("sq8", "sq4", "sq6"))
    rerank = ((not pq) and mxu and precision != lax.Precision.HIGHEST
              or use_int8)
    if use_int8:
        # int-score ranking: same codec-aware widening as the padded
        # path (_sq_kscan) — int4 misses beyond a narrow pool are
        # unrecoverable by the exact rerank.
        f, add = (8, 96) if sq == "sq4" else (4, 32)
        k_scan = min(s_pad, max(f * k, k + add))
    elif rerank:
        k_scan = min(s_pad, max(2 * k, k + 16))
    else:
        k_scan = min(k, s_pad)
    sc = 1 << max(12, min(25 - max(d, 1).bit_length(), 20))
    while s_pad % sc and sc > 1:
        sc //= 2
    # The spill buffer is a growth/pre-allocation CAPACITY — often ~2x
    # the rows actually appended, and the cost is proportional to rows
    # scanned.  Scan only whole chunks covering n_used; the tail chunks beyond
    # hold pos=-1 padding only.  n_used is a static arg: round it up to
    # pow2/16 granularity so spill growth recompiles O(log) times, not
    # per ingest chunk.
    n_chunks = s_pad // sc
    if n_used is not None:
        n_used = int(n_used)
        gran = max(16384, (1 << max(n_used.bit_length(), 1)) // 16)
        n_used = -(-n_used // gran) * gran
        n_chunks = min(n_chunks, -(-max(n_used, 1) // sc))

    if use_int8:
        from .sq import SQ_INT8_SHIFT, sq_query_digits

        if sim:
            u8q = xq * sq_scale[None, :]
            base8 = xq @ sq_vmin
        else:
            t8 = xq - sq_vmin[None, :]
            u8q = t8 * sq_scale[None, :]
            base8 = jnp.sum(t8 * t8, axis=1)
        hi8, lo8, su28, mu8, sumut8 = sq_query_digits(u8q)
        c08 = (float(SQ_INT8_SHIFT[sq]) * sumut8 if sq == "sq8"
               else jnp.zeros_like(su28))

    def body(i, carry):
        best_s, best_i = carry
        start = i * sc
        pl = lax.dynamic_slice(spill_payload, (start, 0), (sc, w))
        asg = lax.dynamic_slice(spill_assign, (start,), (sc,))
        pos_c = lax.dynamic_slice(spill_pos, (start,), (sc,))
        if use_int8:
            from .sq import sq_unpack_i8

            xc8 = sq_unpack_i8(pl, d, sq)                  # (sc, d) int8
            dh = jnp.einsum("qd,cd->qc", hi8, xc8,
                            preferred_element_type=jnp.int32) \
                .astype(jnp.float32)
            dl = jnp.einsum("qd,cd->qc", lo8, xc8,
                            preferred_element_type=jnp.int32) \
                .astype(jnp.float32)
            rs_c = lax.dynamic_slice(spill_rs, (start,), (sc,))
            uc = (su28[:, None] * (128.0 * dh + dl)
                  + c08[:, None] + mu8[:, None] * rs_c[None, :])
            if sim:
                dist = base8[:, None] + uc
            else:
                rn_c = lax.dynamic_slice(spill_rn, (start,), (sc,))
                dist = jnp.maximum(base8[:, None] - 2.0 * uc
                                   + rn_c[None, :], 0.0)
        else:
            xc = decode(pl, asg)
            dist = pairwise_tile(xq, xc, metric, metric_arg, precision)
        if cmp_membership:
            probed = (probe_ids[:, 0:1] == asg[None, :])   # (nq, sc)
            for j in range(1, nprobe):
                probed = jnp.logical_or(
                    probed, probe_ids[:, j:j + 1] == asg[None, :])
        else:
            probed = jnp.take(onehot_t, asg, axis=0).T     # (nq, sc)
        valid = jnp.logical_and(probed, (pos_c >= 0)[None, :])
        if mask is not None:
            mc = lax.dynamic_slice(mask, (start,), (sc,))
            valid = jnp.logical_and(valid, mc[None, :])
        score = dist if sim else -dist
        score = jnp.where(valid, score, _NEG_INF)
        # Per-chunk selection via the window-max prefilter (exact):
        # exact_topk replaces a top-k over (nq, k_scan + sc) with a
        # 128-wide window max + two small top-ks, then the running merge
        # is (nq, 2*k_scan) — tiny.
        ch_s, ch_i = exact_topk(score, min(k_scan, sc))
        cat_s = jnp.concatenate([best_s, ch_s], axis=1)
        cat_i = jnp.concatenate([best_i, start + ch_i], axis=1)
        new_s, sel = lax.top_k(cat_s, k_scan)
        return new_s, jnp.take_along_axis(cat_i, sel, axis=1)

    init = (jnp.full((nq, k_scan), _NEG_INF, jnp.float32),
            jnp.full((nq, k_scan), -1, jnp.int32))
    best, sel = lax.fori_loop(0, n_chunks, body, init)

    if rerank:
        # Fast-mode exact rerank (Flat/decoded rows, L2/IP): the spill
        # top-k merges against the padded scan, whose results are fp32
        # exact — a reduced-precision spill side would mix score
        # precisions.  Re-decode only the selected rows and re-score at
        # HIGHEST.  Blocked over queries: the decoded (qb, k_scan, d)
        # tile is bounded to ~128 MB — the filtered bench's binomial k'
        # (go/main_test.go:104-128) reaches k in the thousands.
        qb = rerank_qb or max(1, min(nq, (1 << 25) // max(k_scan * d, 1)))
        while nq % qb:
            qb -= 1

        def rerank_block(i, carry):
            bests, sels = carry
            q0 = i * qb
            xq_b = lax.dynamic_slice(xq, (q0, 0), (qb, xq.shape[1]))
            sel_b = lax.dynamic_slice(sels, (q0, 0), (qb, k_scan))
            best_b = lax.dynamic_slice(bests, (q0, 0), (qb, k_scan))
            safe = jnp.maximum(sel_b, 0)
            xs = decode(spill_payload[safe.reshape(-1)],
                        spill_assign[safe.reshape(-1)]) \
                .reshape(qb, k_scan, d)
            xy2 = jnp.einsum("qd,qcd->qc", xq_b, xs,
                             precision=lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
            if metric == "INNER_PRODUCT":
                s2 = xy2
            else:
                qn2 = jnp.sum(xq_b * xq_b, axis=1, keepdims=True)
                bn2 = jnp.sum(xs * xs, axis=2)
                s2 = -jnp.maximum(qn2 - 2.0 * xy2 + bn2, 0.0)
            s2 = jnp.where(jnp.isneginf(best_b), _NEG_INF, s2)
            b2, o2 = lax.top_k(s2, k)
            i2 = jnp.take_along_axis(sel_b, o2, axis=1)
            # re-ranked (k) results live in the first k columns; the
            # remaining k_scan-k columns are dead weight the final slice
            # below drops.
            pad = ((0, 0), (0, k_scan - k))
            bests = lax.dynamic_update_slice(
                bests, jnp.pad(b2, pad, constant_values=_NEG_INF), (q0, 0))
            sels = lax.dynamic_update_slice(
                sels, jnp.pad(i2, pad, constant_values=-1), (q0, 0))
            return bests, sels

        best, sel = lax.fori_loop(0, nq // qb, rerank_block, (best, sel))
        best = lax.slice(best, (0, 0), (nq, k))
        sel = lax.slice(sel, (0, 0), (nq, k))
    elif k_scan > k:
        best, sel2 = lax.top_k(best, k)
        sel = jnp.take_along_axis(sel, sel2, axis=1)
    pos = jnp.take(spill_pos, jnp.maximum(sel, 0))
    pos = jnp.where(jnp.isneginf(best), -1, pos)
    return best, pos


def merge_topk(scores_a, pos_a, scores_b, pos_b, k: int):
    """Merge two max-oriented candidate sets into the best k."""
    cat_s = jnp.concatenate([scores_a, scores_b], axis=1)
    cat_p = jnp.concatenate([pos_a, pos_b], axis=1)
    best, sel = lax.top_k(cat_s, k)
    return best, jnp.take_along_axis(cat_p, sel, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "nprobe", "metric", "q_chunk", "precision",
                     "codec", "lmax"),
)
def ivf_sq_search(
    codes_sorted,   # (cap, w) packed uint8 / (cap, d) fp16, grouped by list
    vmin,           # (d,) fp32 (zeros for fp16)
    scale,          # (d,) fp32
    offsets,        # (nlist,) int32 list starts in the sorted buffer
    counts,         # (nlist,) int32 list sizes
    centroids,      # (nlist, d) fp32
    xq,             # (nq_pad, d) fp32
    mask,
    metric_arg,
    *,
    k: int,
    nprobe: int,
    metric: str,
    q_chunk: int,
    precision,
    codec: str,
    lmax: int,
):
    """IVF with scalar-quantized storage (faiss IndexIVFScalarQuantizer,
    by_residual=false as index_factory builds it): probed lists fetched as
    contiguous code-block slices (slice_probed_lists), decoded through the
    SQ codec (ops/sq.py) into the same matmul distance tile as the Flat
    scan."""
    from .sq import sq_decode

    nq, d = xq.shape
    nlist = centroids.shape[0]
    sim = metric in SIMILARITY_METRICS
    nprobe = min(nprobe, nlist)

    cdist = pairwise_tile(xq, centroids, metric, metric_arg, precision)
    cscore = cdist if sim else -cdist
    _, probe_ids = lax.top_k(cscore, nprobe)

    L = min(lmax, codes_sorted.shape[0])
    ncand = nprobe * L
    w = codes_sorted.shape[1]
    # Rerank vs the decoded rows (see ivf_pq_search).
    k_scan = inchunk_rerank_kscan(k, ncand, metric, precision)
    maskbuf = mask[:, None] if mask is not None else None

    def scan_chunk(i, carry):
        best_s, best_p = carry
        q0 = i * q_chunk
        xq_c = lax.dynamic_slice(xq, (q0, 0), (q_chunk, d))
        probes_c = lax.dynamic_slice(probe_ids, (q0, 0), (q_chunk, nprobe))
        codes_c, pos, valid = slice_probed_lists(
            codes_sorted, offsets, counts, probes_c, lmax=L)
        pos = pos.reshape(q_chunk, ncand)
        valid = valid.reshape(q_chunk, ncand)
        xc = sq_decode(codes_c.reshape(-1, w), vmin, scale, codec) \
            .reshape(q_chunk, ncand, d)
        if metric == "INNER_PRODUCT":
            dist = jnp.einsum("qd,qcd->qc", xq_c, xc, precision=precision,
                              preferred_element_type=jnp.float32)
        else:  # L2
            qn = jnp.sum(xq_c * xq_c, axis=1, keepdims=True)
            bn = jnp.sum(xc * xc, axis=2)
            xy = jnp.einsum("qd,qcd->qc", xq_c, xc, precision=precision,
                            preferred_element_type=jnp.float32)
            dist = jnp.maximum(qn - 2.0 * xy + bn, 0.0)
        if mask is not None:
            mc, _, _ = slice_probed_lists(maskbuf, offsets, counts,
                                          probes_c, lmax=L)
            valid = jnp.logical_and(valid, mc.reshape(q_chunk, ncand))
        score = dist if sim else -dist
        score = jnp.where(valid, score, _NEG_INF)
        s, sel = inchunk_exact_rerank(xq_c, xc, score, k=k, k_scan=k_scan,
                                      metric=metric)
        p = jnp.take_along_axis(pos, sel, axis=1)
        p = jnp.where(jnp.isneginf(s), -1, p)
        best_s = lax.dynamic_update_slice(best_s, s, (q0, 0))
        best_p = lax.dynamic_update_slice(best_p, p, (q0, 0))
        return best_s, best_p

    init = (
        jnp.full((nq, k), _NEG_INF, jnp.float32),
        jnp.full((nq, k), -1, jnp.int32),
    )
    return lax.fori_loop(0, nq // q_chunk, scan_chunk, init)


@functools.partial(
    jax.jit,
    static_argnames=("k", "k_scan", "nprobe", "metric", "q_chunk",
                     "precision", "codec", "lmax"),
)
def ivf_sq_int8_search(
    codes,         # (cap, w) packed uint8 sorted SQ codes (shared buffer)
    row_norm,      # (cap,) fp32: Σ_d (scale_d c_d)² per sorted row
    row_sum,       # (cap,) fp32: Σ_d c_d (raw code sum) per sorted row
    offsets,       # (nlist,) int32 list starts in the sorted buffer
    counts,        # (nlist,) int32 list sizes
    centroids,     # (nlist, d) fp32 (coarse assignment only)
    vmin,          # (d,) fp32 SQ ranges
    scale,
    xq,            # (nq_pad, d) fp32
    mask,          # (cap,) bool over sorted rows, or None
    metric_arg,
    *,
    k: int,
    k_scan: int,
    nprobe: int,
    metric: str,
    q_chunk: int,
    precision,
    codec: str,
    lmax: int,
):
    """Int8 IVF scan over SQ8/SQ4/SQ6 storage (L2 / INNER_PRODUCT):
    the gathered candidate tile stays packed uint8 (1 B or less per dim vs
    the decode path's fp32), unpacks to shifted int8 in-register, and the
    batched dots run in int8; the query side is the recentred
    two-digit quantization of sq_query_digits (15-bit effective — a
    single digit's noise swamps clustered corpora's distance gaps) and
    the final decode+fp32 rerank of the widened top-k restores exact
    distances (see ops/sq.py::sq_int8_search for the algebra — IVF,SQ*
    stores codes non-residual, so scoring is identical)."""
    from .sq import SQ_INT8_SHIFT, sq_decode, sq_query_digits, sq_unpack_i8

    nq, d = xq.shape
    nlist = centroids.shape[0]
    w = codes.shape[1]
    shift = float(SQ_INT8_SHIFT[codec])
    sim = metric == "INNER_PRODUCT"
    nprobe = min(nprobe, nlist)

    cdist = pairwise_tile(xq, centroids, metric, metric_arg, precision)
    cscore = cdist if sim else -cdist
    _, probe_ids = lax.top_k(cscore, nprobe)

    L = min(lmax, codes.shape[0])
    ncand = nprobe * L
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
        hi_c = lax.dynamic_slice(hi, (q0, 0), (q_chunk, d))
        lo_c = lax.dynamic_slice(lo, (q0, 0), (q_chunk, d))
        su2_c = lax.dynamic_slice(su2, (q0,), (q_chunk,))
        mu_c = lax.dynamic_slice(mu, (q0,), (q_chunk,))
        sumut_c = lax.dynamic_slice(sum_ut, (q0,), (q_chunk,))
        base_c = lax.dynamic_slice(base, (q0,), (q_chunk,))
        probes_c = lax.dynamic_slice(probe_ids, (q0, 0), (q_chunk, nprobe))
        packed, pos, valid = slice_probed_lists(codes, offsets, counts,
                                                probes_c, lmax=L)
        pos = pos.reshape(q_chunk, ncand)
        valid = valid.reshape(q_chunk, ncand)
        xc8 = sq_unpack_i8(packed.reshape(-1, w), d,
                           codec).reshape(q_chunk, ncand, d)
        dot_hi = jnp.einsum("qd,qcd->qc", hi_c, xc8,
                            preferred_element_type=jnp.int32)
        dot_lo = jnp.einsum("qd,qcd->qc", lo_c, xc8,
                            preferred_element_type=jnp.int32)
        # Per-row scalars (row_sum / row_norm / mask) ride the pos map the
        # codes gather already produced — a flat 4-byte-per-row gather,
        # not a second set of probed-window dynamic slices.
        safe_pos = jnp.maximum(pos, 0)
        rs = row_sum[safe_pos]
        uc = (su2_c[:, None] * (128.0 * dot_hi.astype(jnp.float32)
                                + dot_lo.astype(jnp.float32))
              + shift * sumut_c[:, None]
              + mu_c[:, None] * rs)
        if sim:
            score = base_c[:, None] + uc
        else:
            score = -jnp.maximum(
                base_c[:, None] - 2.0 * uc + row_norm[safe_pos], 0.0)
        if mask is not None:
            valid = jnp.logical_and(valid, mask[safe_pos])
        score = jnp.where(valid, score, _NEG_INF)
        s, sel = exact_topk(score, k_scan)
        # Exact rerank: decode only the selected rows, score fp32.
        csel = jnp.take_along_axis(pos, sel, axis=1)
        xs = sq_decode(codes[jnp.maximum(csel, 0)].reshape(-1, w), vmin,
                       scale, codec).reshape(q_chunk, k_scan, d)
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

    init = (
        jnp.full((nq, k), _NEG_INF, jnp.float32),
        jnp.full((nq, k), -1, jnp.int32),
    )
    return lax.fori_loop(0, nq // q_chunk, scan_chunk, init)
