"""IVF search dispatch and range search (split from models/ivf.py).

The serving tier: parameter resolution (nprobe + quantiser.-scoped
recursion, src/faiss_extension.cpp:675-689), path selection by layout
(device-sharded / device-resident padded / sorted+gather), the SOAR
2k-dedup wrapper, and range search.  Methods attach to IVFIndex; layouts
live in models/ivf_layout.py and models/ivf_device.py.
"""

from __future__ import annotations

import functools as _functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.flat_search import SIMILARITY_METRICS, finalize_scores
from ..ops.ivf_padded import (choose_padded_q_chunk, ivf_padded_search,
                              padded_lmax)
from ..ops.ivf_scan import choose_q_chunk, ivf_pq_search, ivf_search
from ..params import EMPTY
from ..utils.config import config, next_pow2, pad_rows, sq_int8_active
from ..utils.transfer import upload_queries
from .base import SearchResult, as_matrix
from .base import dedup_by_key as _dedup_by_key
from .ivf import IVFIndex

_jax = jax


def _sq_kscan(self, k: int, cap: int) -> int:
    """Rerank-pool width for int8-scored SQ scans.  The digit dots rank
    by QUANTIZED distance; true neighbours missed there are
    unrecoverable by the exact rerank, so the coarser the codec the wider
    the pool: sq4 (16 levels) widens 2x more than sq8/sq6."""
    f, add = (8, 96) if self.sq_type == "sq4" else (4, 32)
    return min(cap, max(f * k, k + add))


# --- search ----------------------------------------------------------
def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
    return self._finish_dispatch(
        self.search_dispatch(xq, k, params, selector), xq, k)

def search_dispatch(self, xq, k, params=EMPTY, selector=None):
    """Raw device dispatch for the single-fetch serving tier
    (api.faiss_search_batched): (dist_dev, pos_dev, nq, k_eff,
    positions→labels fn[, host postprocess]) or None when no device
    work applies.

    With SOAR enabled every datapoint is stored twice (two lists), so
    the kernel fetches 2k candidates and a host postprocess drops the
    same-SOURCE-row duplicates (labels_fn.src_of maps kernel positions
    to logical datapoints — genuinely duplicated user labels are NOT
    collapsed) before padding back to k."""
    if getattr(self, "soar_lambda", 0.0) > 0.0 and int(k) > 0:
        disp = self._dispatch_inner(xq, 2 * int(k), params, selector)
        if disp is None:
            return None
        dist, pos, nq, _, labels_fn = disp
        sim = self.metric.name in SIMILARITY_METRICS
        sentinel = float("-inf") if sim else float("inf")
        src_of = getattr(labels_fn, "src_of", None)

        def post(d, lab, pos_host, k=int(k), sentinel=sentinel,
                 src_of=src_of):
            keys = src_of(pos_host) if src_of is not None else lab
            return _dedup_by_key(d, lab, keys, k, sentinel)

        return dist, pos, nq, int(k), labels_fn, post
    return self._dispatch_inner(xq, k, params, selector)

def _dispatch_inner(self, xq, k, params=EMPTY, selector=None):
    self._require_trained()
    xq = as_matrix(xq, self.d)
    nq = xq.shape[0]
    k = int(k)
    if nq == 0 or k <= 0 or self.ntotal == 0:
        return None

    # SearchParametersIVF: nprobe plus quantiser.-scoped recursion
    # (src/faiss_extension.cpp:675-689).  Our coarse assignment is an
    # exact fused tile, so quantiser.* params parse but cannot change
    # results; they are accepted for surface parity.
    nprobe = params.get_int("nprobe", self.nprobe_default)
    _ = params.scoped("quantiser.")

    nprobe_eff = max(1, min(int(nprobe), self.nlist))
    nq_pad = max(config.min_query_bucket, next_pow2(nq))
    xq_pad = upload_queries(
        pad_rows(xq, nq_pad),
        lossy_ok=(self.sq_type in ("sq8", "sq4", "sq6")
                  or self.pq_m is not None))

    def ids_labels(pos, ids=self._ids):
        return np.where(pos >= 0, ids[np.clip(pos, 0, None)]
                        if ids.size else pos, -1)

    if self._srcrow is not None:
        # Storage-row positions → logical datapoint (SOAR dedup key).
        ids_labels.src_of = (
            lambda pos, src=self._srcrow:
            np.where(pos >= 0, src[np.clip(pos, 0, None)], -1))

    if getattr(self, "_shard_mesh", None) is not None:
        # Device-sharded placement (faiss_to_device): lists partitioned
        # over the mesh, all-gather top-k merge.
        lmax_s = self._ivf_sharded_lmax()
        k_eff = min(k, nprobe_eff * lmax_s)
        self._last_scan_path = "sharded"
        dist, pos = self._search_sharded(xq_pad, k_eff, nprobe_eff,
                                         selector)
        return dist, pos, nq, k_eff, ids_labels

    if self._dr is not None:
        # Device-resident layout (models/ivf_device.py): padded lists
        # already on the device, plus the spill region.
        dist, pos, k_eff = self._serve_padded(xq_pad, k, nprobe_eff,
                                              selector)
        return dist, pos, nq, k_eff, ids_labels

    storage, lmax, centroids, order = self._build_device()
    k_eff = min(k, nprobe_eff * lmax)
    offs, cnts = self._sorted_list_meta()
    self._last_scan_path = "sorted-" + (
        "pq" if self.pq_m is not None else self.sq_type or "flat")
    mask = (self._selector_mask(selector, order)
            if selector is not None else None)
    q_chunk = choose_q_chunk(nq_pad, nprobe_eff * lmax, self.d)

    if self.pq_m is not None:
        codes_sorted, assign_sorted, codebooks = storage
        scores, pos = ivf_pq_search(
            codes_sorted, codebooks,
            offs, cnts, centroids,
            xq_pad, mask, jnp.asarray(self.metric_arg, jnp.float32),
            k=k_eff, nprobe=nprobe_eff, metric=self.metric.name,
            q_chunk=q_chunk, precision=config.precision,
            codec=self.pq_codec, lmax=lmax)
    elif self.sq_type is not None:

        _, vmin, scale = storage
        if (self.sq_type in ("sq8", "sq4", "sq6")
                and self.metric.name in ("L2", "INNER_PRODUCT")
                and self.d >= 16     # tiny-d margins sit at the int8 noise floor
                and sq_int8_active()):
            from ..ops.ivf_scan import ivf_sq_int8_search

            rn, rs = self._ivf_sq_row_extras()
            k_scan = _sq_kscan(self, k_eff, nprobe_eff * lmax)
            scores, pos = ivf_sq_int8_search(
                self._sq_codes_dev(), rn, rs, offs, cnts,
                centroids, vmin, scale, xq_pad, mask,
                jnp.asarray(self.metric_arg, jnp.float32),
                k=k_eff, k_scan=k_scan, nprobe=nprobe_eff,
                metric=self.metric.name, q_chunk=q_chunk,
                precision=config.precision, codec=self.sq_type,
                lmax=lmax)
        else:
            from ..ops.ivf_scan import ivf_sq_search

            scores, pos = ivf_sq_search(
                self._sq_codes_dev(), vmin, scale,
                offs, cnts, centroids,
                xq_pad, mask,
                jnp.asarray(self.metric_arg, jnp.float32),
                k=k_eff, nprobe=nprobe_eff, metric=self.metric.name,
                q_chunk=q_chunk, precision=config.precision,
                codec=self.sq_type, lmax=lmax)
    else:
        scores, pos = ivf_search(
            storage, offs, cnts, centroids,
            xq_pad, mask, jnp.asarray(self.metric_arg, jnp.float32),
            k=k_eff, nprobe=nprobe_eff, metric=self.metric.name,
            q_chunk=q_chunk, precision=config.precision, lmax=lmax)
    dist, pos = finalize_scores(scores, pos, self.metric.name)

    def sorted_labels(pos_host, ids_sorted=self._sorted_ids(order)):
        return np.where(pos_host >= 0,
                        ids_sorted[np.clip(pos_host, 0, None)]
                        if ids_sorted.size else pos_host, -1)

    if self._srcrow is not None:
        sorted_labels.src_of = (
            lambda pos, src=self._sorted_srcrow(order):
            np.where(pos >= 0, src[np.clip(pos, 0, None)], -1))

    return dist, pos, nq, k_eff, sorted_labels


def _serve_padded(self, xq_pad, k, nprobe, selector):
    """Device-resident serve: coarse top-nprobe, the padded-layout scan
    (ops/ivf_padded.py), the spill scan and the merge — one jitted
    program.  Returns (dist, pos, k_eff)."""
    dev = self._dr_device_layout()
    payload, counts, row_pos, cents = dev[:4]
    codec = self.sq_type
    rn = rs = vmin = scale = None
    if codec is not None:
        rn, rs, vmin, scale = dev[4:8]
    lmax = padded_lmax(payload, codec)
    ncand = nprobe * lmax
    spill = self._device_spill
    # Spill rows are candidates beyond the padded slots: k_eff counts them
    # or k > nprobe·lmax would truncate valid neighbours.
    n_spill = spill[2].shape[0] if spill is not None else 0
    k_lists = min(k, ncand)
    k_eff = min(k, ncand + n_spill)
    k_scan = _sq_kscan(self, k_lists, ncand) if codec else k_lists
    if codec is None:
        row_bytes = 8 * self.d                # fp32 rows + their product
    else:
        row_bytes = (payload.shape[2] * (3 if codec == "sq6" else 1)
                     + self.d)                # packed codes + int8 unpack
    q_chunk = choose_padded_q_chunk(xq_pad.shape[0], ncand, row_bytes)
    mask = self._padded_mask(selector) if selector is not None else None
    sp = (None,) * 6
    n_used = None
    int8_dot = False
    if spill is not None:
        sp_mask = (self._spill_mask(selector)
                   if selector is not None else None)
        sp = spill[:3] + (spill[4], spill[5], sp_mask)
        n_used = int(spill[3])
        int8_dot = (spill[4] is not None and self.d >= 16
                    and sq_int8_active())
    self._last_scan_path = "padded-" + (codec or "flat")
    dist, pos = _padded_serve(
        payload, counts, row_pos, rn, rs, vmin, scale, cents, xq_pad, mask,
        jnp.asarray(self.metric_arg, jnp.float32), *sp,
        k_lists=k_lists, k_eff=k_eff, k_scan=k_scan, nprobe=nprobe,
        metric=self.metric.name, codec=codec, q_chunk=q_chunk,
        precision=config.precision, n_used=n_used, int8_dot=int8_dot)
    return dist, pos, k_eff


IVFIndex._serve_padded = _serve_padded


@_functools.partial(_jax.jit, static_argnames=(
    "k_lists", "k_eff", "k_scan", "nprobe", "metric", "codec", "q_chunk",
    "precision", "n_used", "int8_dot"))
def _padded_serve(payload, counts, row_pos, rn, rs, vmin, scale, cents,
                  xq_pad, mask, marg, sp_payload, sp_assign, sp_pos, sp_rn,
                  sp_rs, sp_mask, *, k_lists, k_eff, k_scan, nprobe, metric,
                  codec, q_chunk, precision, n_used, int8_dot):
    from ..ops.ivf_scan import ivf_spill_scan, merge_topk

    probe_ids = _coarse_topk(xq_pad, cents, marg, nprobe=nprobe,
                             metric=metric, precision=precision)
    scores, pos = ivf_padded_search(
        payload, counts, row_pos, rn, rs, vmin, scale, probe_ids, xq_pad,
        mask, k=k_lists, k_scan=k_scan, metric=metric, codec=codec,
        q_chunk=q_chunk, precision=precision)
    if sp_pos is not None:
        sp_s, sp_p = ivf_spill_scan(
            sp_payload, sp_assign, sp_pos, cents, None, probe_ids, xq_pad,
            sp_mask, marg, k=min(k_eff, sp_pos.shape[0]), metric=metric,
            precision=precision, sq=codec, sq_vmin=vmin, sq_scale=scale,
            n_used=n_used, spill_rn=sp_rn, spill_rs=sp_rs,
            int8_dot=int8_dot)
        scores, pos = merge_topk(scores, pos, sp_s, sp_p, k_eff)
    return finalize_scores(scores, pos, metric)


@_functools.partial(_jax.jit,
                    static_argnames=("nprobe", "metric", "precision"))
def _coarse_topk(xq, centroids, metric_arg, *, nprobe, metric, precision):
    """Coarse-quantizer assignment: top-nprobe list ids per query (one
    distance tile + one small top_k) — feeds the padded list scan."""
    from ..ops.distance import pairwise_tile
    from ..ops.flat_search import SIMILARITY_METRICS as _SIM

    cdist = pairwise_tile(xq, centroids, metric, metric_arg, precision)
    cscore = cdist if metric in _SIM else -cdist
    _, ids = _jax.lax.top_k(cscore, nprobe)
    return ids.astype(_jax.numpy.int32)


def _ivf_range_search(self, xq, radius, params=EMPTY, selector=None):
    """Range search over the probed lists (faiss::IndexIVF::range_search
    contract: exact within the nprobe-selected lists)."""
    from ..ops.range import _ivf_range_chunk, empty_range_result
    from ..ops.range import RangeSearchResult

    self._require_trained()
    xq = as_matrix(xq, self.d)
    nq = xq.shape[0]
    if nq == 0 or self.ntotal == 0:
        return empty_range_result(nq)
    nprobe = params.get_int("nprobe", self.nprobe_default)
    nprobe_eff = max(1, min(int(nprobe), self.nlist))

    storage, lmax, centroids, order = self._build_device()
    offs, cnts = self._sorted_list_meta()
    xb_sorted = storage[0] if isinstance(storage, tuple) else storage
    if self.pq_m is not None:
        # Decode-on-the-fly for PQ storage: reconstruct candidates from
        # codes inside the chunk fn is not wired here; decode the probed
        # candidates via the dense sorted codes path instead.
        codes_sorted, assign_sorted, codebooks = storage
        from ..ops.pq import codec_decode

        # Materialize decoded rows chunk-wise would defeat compression;
        # for range search (non-hot path) decode the full sorted corpus
        # once on device.
        resid = codec_decode(codes_sorted, codebooks, self.pq_codec)
        xb_sorted = resid + centroids[assign_sorted]
    elif self.sq_type is not None:
        from ..ops.sq import sq_decode

        _, vmin, scale = storage
        xb_sorted = sq_decode(self._sq_codes_dev(), vmin, scale,
                              self.sq_type)
    nq_pad = max(config.min_query_bucket, next_pow2(nq))
    xq_pad = jnp.asarray(pad_rows(xq, nq_pad))
    probe_ids = _coarse_topk(xq_pad, centroids,
                             jnp.asarray(self.metric_arg, jnp.float32),
                             nprobe=nprobe_eff, metric=self.metric.name,
                             precision=config.precision)
    sim = self.metric.name in SIMILARITY_METRICS
    labels_sorted = self._sorted_ids(order)
    passing = (selector.contains(labels_sorted)
               if selector is not None else None)
    # Power-of-two chunk so it divides nq_pad (slices never shift).
    budget = max(1, (1 << 22) // max(nprobe_eff * lmax, 1))
    qc = 1
    while qc * 2 <= min(budget, int(nq_pad)):
        qc *= 2
    marg = jnp.asarray(self.metric_arg, jnp.float32)
    per_q_rows = [[] for _ in range(nq)]
    per_q_dist = [[] for _ in range(nq)]
    for q0 in range(0, nq, qc):
        xq_c = jax.lax.dynamic_slice(
            xq_pad, (min(q0, nq_pad - qc), 0), (qc, self.d))
        pr_c = jax.lax.dynamic_slice(
            probe_ids, (min(q0, nq_pad - qc), 0), (qc, nprobe_eff))
        dist, cand = _ivf_range_chunk(
            xb_sorted, offs, cnts, pr_c, xq_c,
            marg, metric=self.metric.name, precision=config.precision,
            lmax=lmax)
        dist = np.asarray(dist)
        cand = np.asarray(cand)
        hit = (dist > radius) if sim else (dist < radius)
        if passing is not None:
            hit &= passing[np.clip(cand, 0, len(passing) - 1)] & \
                (cand < len(passing))
        for qi in range(min(qc, nq - q0)):
            sel_idx = np.nonzero(hit[qi])[0]
            if sel_idx.size:
                rows = cand[qi, sel_idx]
                per_q_rows[q0 + qi].append(labels_sorted[rows])
                per_q_dist[q0 + qi].append(dist[qi, sel_idx])
    lims = np.zeros((nq + 1,), np.int64)
    lparts, dparts = [], []
    for q in range(nq):
        rows = (np.concatenate(per_q_rows[q]) if per_q_rows[q]
                else np.empty((0,), np.int64))
        ds = (np.concatenate(per_q_dist[q]) if per_q_dist[q]
              else np.empty((0,), np.float32))
        lims[q + 1] = lims[q] + rows.size
        lparts.append(rows.astype(np.int64))
        dparts.append(ds.astype(np.float32))
    return RangeSearchResult(
        lims,
        np.concatenate(lparts) if lparts else np.empty((0,), np.int64),
        np.concatenate(dparts) if dparts else np.empty((0,), np.float32))


import jax  # noqa: E402

def _ivf_range_search_outer(self, xq, radius, params=EMPTY, selector=None):
    res = _ivf_range_search(self, xq, radius, params, selector)
    if getattr(self, "soar_lambda", 0.0) <= 0.0:
        return res
    # SOAR duplicates rows across two lists: a label can appear twice in a
    # query's CSR segment when both its lists were probed.  Keep the BEST
    # duplicate (codec storages encode the two copies against different
    # centroids, so their decoded distances differ).  One vectorized
    # lexsort over the whole CSR; result order within a segment is
    # unspecified, matching faiss::RangeSearchResult.
    from ..ops.range import RangeSearchResult

    nq = res.lims.shape[0] - 1
    nres = res.labels.shape[0]
    if nres == 0:
        return res
    qid = np.repeat(np.arange(nq, dtype=np.int64), np.diff(res.lims))
    sim = self.metric.name in SIMILARITY_METRICS
    dkey = -res.distances if sim else res.distances
    order = np.lexsort((dkey, res.labels, qid))
    q_s, l_s = qid[order], res.labels[order]
    first = np.ones((nres,), bool)
    first[1:] = (q_s[1:] != q_s[:-1]) | (l_s[1:] != l_s[:-1])
    keep = order[first]
    keep.sort()  # restore per-query grouping
    counts = np.bincount(qid[keep], minlength=nq)
    lims = np.zeros((nq + 1,), np.int64)
    np.cumsum(counts, out=lims[1:])
    return RangeSearchResult(lims, res.labels[keep], res.distances[keep])


IVFIndex.range_search = _ivf_range_search_outer


IVFIndex.search = search
IVFIndex.search_dispatch = search_dispatch
IVFIndex._dispatch_inner = _dispatch_inner
# `search` is declared abstract on the Index base; attaching it after class
# creation satisfies the contract but abc caches abstractness at creation —
# clear it now that every abstract method is implemented.
IVFIndex.__abstractmethods__ = frozenset()
