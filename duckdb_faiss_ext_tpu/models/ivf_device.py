"""Device-resident IVF ingest: build the padded list layout in device memory.

A capability beyond the reference: the reference's ingest always streams
vectors through host memory (the faiss_add table function,
src/faiss_extension.cpp:475-547).  The interesting producers of vectors —
embedding models — run on the same accelerator, so this path lets an IVF
index ingest vectors that already live in device memory (or are generated
there) without a host round-trip of the corpus: coarse assignment, SQ
encoding, and the scatter into the padded ``(nlist, lmax, w)`` list
layout all run on the device.  Only O(n) int32/int64 bookkeeping
(assignments, ids, slots) ever touches the host.

This is also what makes the reference's own benchmark corpus servable
from one device: MS MARCO ada2 (8,841,823 × 1536,
go/benches_c.go:31 in the reference) is 54 GB fp32 — the host path would
move it to the device twice (assign + encode); here the fp32 rows never
leave the device and only the compressed payload (6.8 GB SQ4 / 13.6 GB
SQ8) is ever materialized.

Search runs the padded-layout scan of ops/ivf_padded.py, then the spill
scan of ops/ivf_scan.py for rows that overflowed their list.  Because
lmax is fixed up front (the payload is pre-allocated), rows of an
overfull list overflow into the spill buffer instead of forcing a
re-layout; callers size lmax from expected_total (or an exact count
pre-pass).

Unsupported in device-resident mode (clear errors, host path covers them):
PQ/RQ storage, float SQ codecs, SOAR, device sharding (faiss_to_device),
range search, metrics beyond L2/INNER_PRODUCT, and mixing with host adds.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .. import errors
from ..ops.kmeans import kmeans_fit, subsample_for_training
from ..ops.ivf_padded import choose_lmax
from ..ops.sq import SQ_LEVELS, sq_train, sq_unpack_host
from .ivf import IVFIndex


class DeviceResidentState:
    """Device arrays + host bookkeeping for a device-resident IVF layout."""

    __slots__ = ("lmax", "payload", "rn_layout", "rs_layout", "row_pos",
                 "counts", "slot", "spill_payload", "spill_assign",
                 "spill_pos", "spill_rn", "spill_rs", "spill_n",
                 "version")

    def __init__(self, nlist: int, lmax: int, width: int, dtype,
                 with_rn: bool, planes: int = 0):
        self.lmax = int(lmax)
        if planes:
            # Plane-major payload (SQ6): byte b of every 3-byte group in
            # rows [b*lmax, (b+1)*lmax) — (nlist, 3*lmax, d4), read back
            # into packed rows by ops/ivf_padded.py::gather_lists.
            self.payload = jnp.zeros((nlist, planes * lmax,
                                      width // planes), dtype)
        else:
            self.payload = jnp.zeros((nlist, lmax, width), dtype)
        self.rn_layout = (jnp.zeros((nlist, lmax), jnp.float32)
                          if with_rn else None)
        self.rs_layout = (jnp.zeros((nlist, lmax), jnp.float32)
                          if with_rn else None)
        self.row_pos = np.full((nlist, lmax), -1, np.int32)  # host
        self.counts = np.zeros((nlist,), np.int64)           # host, FULL
        self.slot = np.empty((0,), np.int64)  # per-row: slot or -(spill+1)
        self.spill_payload = None             # (scap, width) device
        self.spill_assign = np.empty((0,), np.int32)         # host
        self.spill_pos = np.empty((0,), np.int32)            # host
        self.spill_rn = np.empty((0,), np.float32)           # host (SQ)
        self.spill_rs = np.empty((0,), np.float32)           # host (SQ)
        self.spill_n = 0
        self.version = 0


# --------------------------------------------------------------------------
# jitted device stages
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("codec", "levels"))
def _encode_chunk(x, vmin, scale, *, codec: str, levels: int):
    """fp32 rows → (packed codes uint8, per-row Σ(scale·c)² fp32[, SQ6
    planes]), on device (same quantization/packing as ops/sq.py).

    SQ6 additionally returns the (m, 3, d4) plane-major view for the
    padded-layout scatter (built from the byte planes directly, with no
    minor-dim-3 intermediate)."""
    q = jnp.clip(jnp.round((x - vmin[None, :]) / scale[None, :]),
                 0, levels).astype(jnp.uint8)
    qf = q.astype(jnp.float32)
    rn = jnp.sum(jnp.square(qf * scale[None, :]), axis=1)
    rs = jnp.sum(qf, axis=1)        # raw code sum (recentred int8 scans)
    if codec == "sq4":
        if x.shape[1] % 2:
            q = jnp.pad(q, ((0, 0), (0, 1)))
        packed = q[:, 0::2] | (q[:, 1::2] << 4)
    elif codec == "sq6":
        m, d = q.shape
        if d % 4:
            q = jnp.pad(q, ((0, 0), (0, (-d) % 4)))
        g = q.reshape(m, -1, 4).astype(jnp.uint16)
        b0 = ((g[..., 0] << 2) | (g[..., 1] >> 4)).astype(jnp.uint8)
        b1 = (((g[..., 1] & 15) << 4) | (g[..., 2] >> 2)).astype(jnp.uint8)
        b2 = (((g[..., 2] & 3) << 6) | g[..., 3]).astype(jnp.uint8)
        d4 = b0.shape[1]
        # Row-major packed bytes (spill buffer / host materialize):
        # w-index = group*3 + byte, written as three strided updates so
        # no minor-dim-3 intermediate ever materializes.
        packed = (jnp.zeros((m, 3 * d4), jnp.uint8)
                  .at[:, 0::3].set(b0).at[:, 1::3].set(b1)
                  .at[:, 2::3].set(b2))
        planes = jnp.stack([b0, b1, b2], axis=1)          # (m, 3, d4)
        return packed, rn, rs, planes
    else:                                    # sq8
        packed = q
    return packed, rn, rs


@functools.partial(jax.jit, static_argnames=("metric", "sim"))
def _assign_chunk(x, cents, metric_arg, *, metric: str, sim: bool):
    """Exact coarse assignment on device (HIGHEST precision, matching
    models/ivf.py::_assign_lists)."""
    from ..ops.distance import pairwise_tile

    tile = pairwise_tile(x, cents, metric, metric_arg,
                         jax.lax.Precision.HIGHEST)
    best = jnp.argmax(tile, 1) if sim else jnp.argmin(tile, 1)
    return best.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("metric", "sim", "t"))
def _assign_topk_chunk(x, cents, metric_arg, *, metric: str, sim: bool,
                       t: int):
    """Top-``t`` candidate lists per row (capped-assignment mode)."""
    from ..ops.distance import pairwise_tile

    tile = pairwise_tile(x, cents, metric, metric_arg,
                         jax.lax.Precision.HIGHEST)
    score = tile if sim else -tile
    return jax.lax.top_k(score, t)[1].astype(jnp.int32)


def capped_assign(cand: np.ndarray, counts: np.ndarray,
                  cap: int) -> np.ndarray:
    """Greedy capacity-capped assignment (ScaNN-style balanced
    partitioning): each row goes to its nearest candidate list with free
    capacity; a row whose every candidate is full keeps its TRUE nearest
    list (column 0) — the caller's slot logic then routes it to the spill
    region, where IVF semantics stay exact.

    cand: (m, T) int32 candidate lists, nearest first; counts: (nlist,)
    running list sizes; cap: per-list capacity (the padded lmax).
    Returns (assign (m,) int32, displaced count).  Pure numpy — one
    sort per displacement level, vectorised within each level."""
    m, T = cand.shape
    counts = counts.astype(np.int64).copy()
    assign = np.full((m,), -1, np.int32)
    pending = np.arange(m)
    for t in range(T):
        c = cand[pending, t]
        order = np.argsort(c, kind="stable")
        cs = c[order]
        # rank of each pending row among those wanting the same list
        grp = np.searchsorted(cs, np.arange(counts.shape[0]))
        rank = np.arange(cs.shape[0]) - grp[cs]
        fits = counts[cs] + rank < cap
        taken = pending[order[fits]]
        assign[taken] = cs[fits]
        counts += np.bincount(cs[fits], minlength=counts.shape[0])
        pending = pending[order[~fits]]
        if pending.size == 0:
            break
    displaced = m - pending.size - int((assign[assign >= 0]
                                        == cand[assign >= 0, 0]).sum())
    if pending.size:
        assign[pending] = cand[pending, 0]        # exact → spill
    return assign, displaced


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _scatter_sq(payload, rn_layout, rs_layout, lists_idx, slots_idx, rows,
                rn, rs):
    payload = payload.at[lists_idx, slots_idx].set(rows)
    rn_layout = rn_layout.at[lists_idx, slots_idx].set(rn)
    rs_layout = rs_layout.at[lists_idx, slots_idx].set(rs)
    return payload, rn_layout, rs_layout


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _scatter_sq6(payload, rn_layout, rs_layout, lists_idx, slots_idx,
                 planes, rn, rs):
    """Plane-major scatter: payload is (nlist, 3*lmax, d4) — plane b of
    slot s lives at row b*lmax + s; planes is (m, 3, d4).

    Written as ONE flat-row scatter on the (nlist*3*lmax, d4) reshape
    (a bitcast): the mixed advanced/basic form
    ``payload.at[li, :, si, :]`` can make XLA materialise a transposed
    copy of the whole payload around the scatter despite donation."""
    nlist, l3, d4 = payload.shape
    lmax = l3 // 3
    flat = payload.reshape(nlist * l3, d4)
    base = lists_idx * l3 + slots_idx
    idx3 = jnp.concatenate([base, base + lmax, base + 2 * lmax])
    rows3 = jnp.concatenate([planes[:, 0], planes[:, 1], planes[:, 2]],
                            axis=0)
    flat = flat.at[idx3].set(rows3)
    payload = flat.reshape(nlist, l3, d4)
    rn_layout = rn_layout.at[lists_idx, slots_idx].set(rn)
    rs_layout = rs_layout.at[lists_idx, slots_idx].set(rs)
    return payload, rn_layout, rs_layout


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_flat(payload, lists_idx, slots_idx, rows):
    return payload.at[lists_idx, slots_idx].set(rows)


@functools.partial(jax.jit, donate_argnums=(0,))
def _append_spill(buf, start, rows):
    return jax.lax.dynamic_update_slice(buf, rows, (start, 0))


@functools.partial(jax.jit, static_argnames=("rows",), donate_argnums=(0,))
def _shrink_rows(buf, rows: int):
    return jax.lax.slice(buf, (0, 0), (rows, buf.shape[1]))


def _pad_idx(idx: np.ndarray) -> np.ndarray:
    """Pad an index vector to the next pow2 bucket by repeating its first
    entry (bounds jit shapes; duplicate scatter writes are idempotent)."""
    from ..utils.config import next_pow2

    target = max(128, next_pow2(idx.shape[0]))
    if target == idx.shape[0]:
        return idx
    return np.concatenate([idx, np.full((target - idx.shape[0],),
                                        idx[0], idx.dtype)])


# --------------------------------------------------------------------------
# IVFIndex methods
# --------------------------------------------------------------------------

def _dr_codec(self) -> str | None:
    """Storage codec for device-resident mode, validating support."""
    if self.pq_m is not None:
        raise errors.InvalidInputError(
            "device-resident ingest supports Flat, SQ8, SQ6 and SQ4 "
            "storage (PQ/RQ encoding needs the host path)")
    if self.sq_type is not None and self.sq_type not in ("sq8", "sq4",
                                                         "sq6"):
        raise errors.InvalidInputError(
            f"device-resident ingest supports Flat, SQ8, SQ6 and SQ4 "
            f"storage, not SQ codec {self.sq_type}")
    if self.metric.name not in ("L2", "INNER_PRODUCT"):
        raise errors.InvalidInputError(
            "device-resident ingest supports only L2 and INNER_PRODUCT")
    if getattr(self, "soar_lambda", 0.0) > 0.0:
        raise errors.InvalidInputError(
            "device-resident ingest is incompatible with SOAR "
            "(duplicated storage rows)")
    if getattr(self, "_shard_mesh", None) is not None:
        raise errors.InvalidInputError(
            "device-resident ingest is incompatible with faiss_to_device "
            "sharding")
    if not getattr(self, "_supports_device_ingest", False):
        raise errors.InvalidInputError(
            f"{type(self).__name__} does not support device-resident ingest")
    return self.sq_type


def ivf_train_device(self, x) -> None:
    """train() for data already in HBM: k-means + SQ range fit run on the
    device input; only the (nlist, d) centroid table is fetched."""
    if self.is_trained:
        return
    _dr_codec(self)
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2 or x.shape[1] != self.d:
        raise errors.InvalidInputError(
            f"training data must be (n, {self.d}), got {tuple(x.shape)}")
    n = int(x.shape[0])
    if n < self.nlist:
        raise errors.TrainingTooSmallError(n, self.nlist)
    nsub = subsample_for_training(n, self.nlist)
    if nsub < n:
        rng = np.random.default_rng(self.train_seed)
        sel = np.sort(rng.choice(n, size=nsub, replace=False))
        x = x[jnp.asarray(sel)]
    cents, _ = kmeans_fit(x, self.nlist, niter=self.train_niter,
                          seed=self.train_seed,
                          precision=jax.lax.Precision.HIGHEST,
                          balance=getattr(self, "train_balance", 0.0),
                          spherical=self.metric.name == "INNER_PRODUCT")
    self._centroids = np.asarray(cents, dtype=np.float32)
    self._populate_quantizer()
    if self.sq_type is not None:
        vmin, scale = sq_train(x, SQ_LEVELS[self.sq_type])
        self._sq_vmin = np.asarray(vmin)
        self._sq_scale = np.asarray(scale)
    self._invalidate()


def ivf_add_device(self, x, ids=None, *, expected_total: int | None = None,
                   lmax: int | None = None,
                   spill_capacity: int | None = None) -> None:
    """add()/add_with_ids() for vectors already in HBM.

    The first call fixes the padded list length: ``lmax`` explicitly, or
    ``choose_lmax`` of 2× the balanced list size for ``expected_total``
    rows (rows overflowing a list land in the spill region either way).
    ``spill_capacity`` pre-sizes the spill buffer (callers who know the
    exact overflow — e.g. from a counting pre-pass — avoid the 2×
    headroom of its grow-by-doubling schedule).
    """
    self._require_trained()
    codec = _dr_codec(self)
    x = jnp.asarray(x, jnp.float32)
    if x.ndim != 2 or x.shape[1] != self.d:
        raise errors.InvalidInputError(
            f"vectors must be (n, {self.d}), got {tuple(x.shape)}")
    m = int(x.shape[0])
    if ids is None:
        ids = np.arange(self.ntotal, self.ntotal + m, dtype=np.int64)
    else:
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.shape[0] != m:
            raise errors.add_error(
                f"number of ids ({ids.shape[0]}) does not match number of "
                f"vectors ({m})")
    if m == 0:
        return

    if self._dr is None:
        if self._nstored:
            raise errors.InvalidInputError(
                "device-resident ingest cannot be mixed with host-path "
                "adds on the same index")
        if lmax is None:
            if expected_total is None:
                raise errors.InvalidInputError(
                    "the first add_device call must size the padded device "
                    "layout: pass expected_total= (total rows you will "
                    "add) or an explicit lmax=")
            lmax = choose_lmax(
                max(128, int(2 * expected_total / max(self.nlist, 1))))
        else:
            # Keep the pow2/512-multiple list lengths choose_lmax gives
            # (few distinct scan shapes); round an explicit lmax up.
            lmax = choose_lmax(int(lmax))
        width = (self._codes.shape[1] if codec is not None else self.d)
        dtype = jnp.uint8 if codec is not None else jnp.float32
        self._dr = DeviceResidentState(self.nlist, lmax, width, dtype,
                                       with_rn=codec is not None,
                                       planes=3 if codec == "sq6" else 0)
        if spill_capacity:
            # 2048-granular, like the serve-time trim below
            self._dr.spill_payload = jnp.zeros(
                (max(4096, -(-int(spill_capacity) // 2048) * 2048),
                 width), dtype)
    dr = self._dr
    # Drop cached device tuples BEFORE the donating scatter below: a live
    # reference to the payload (e.g. from a search between adds) would
    # force XLA to copy the multi-GB buffer instead of donating it.
    self._device_padded = None
    self._device_spill = None

    # 1. coarse assignment on device; only the int32 vector(s) are fetched.
    cents = jnp.asarray(self._centroids)
    sim = self.metric.name == "INNER_PRODUCT"
    marg = jnp.asarray(self.metric_arg, jnp.float32)
    achunk = max(1024, min(65536, (1 << 27) // max(self.nlist, 1)))
    topk_t = int(getattr(self, "assign_topk", 0) or 0)
    if topk_t > 1:
        # Capped assignment: fetch top-T candidates, pick the nearest list
        # with free capacity (cap = the padded lmax) on host.  Rows whose
        # every candidate is full keep their true nearest list and land in
        # the spill via the ordinary slot overflow below.
        t = min(topk_t, self.nlist)
        cand = np.concatenate([
            np.asarray(_assign_topk_chunk(x[i:i + achunk], cents, marg,
                                          metric=self.metric.name, sim=sim,
                                          t=t))
            for i in range(0, m, achunk)])
        assign, _ = capped_assign(cand, dr.counts, dr.lmax)
    elif m <= achunk:
        assign = np.asarray(_assign_chunk(x, cents, marg,
                                          metric=self.metric.name, sim=sim))
    else:
        assign = np.concatenate([
            np.asarray(_assign_chunk(x[i:i + achunk], cents, marg,
                                     metric=self.metric.name, sim=sim))
            for i in range(0, m, achunk)])

    # 2. encode on device.
    planes = None
    if codec is not None:
        vmin, scale = self._sq_ranges()
        enc = _encode_chunk(x, vmin, scale, codec=codec,
                            levels=SQ_LEVELS[codec])
        rows, rn, rs = enc[:3]
        if codec == "sq6":
            planes = enc[3]
    else:
        rows, rn, rs = x, None, None

    # 3. slot planning on host (pure int bookkeeping, same rank logic as
    #    _build_list_layout): slot = running count + rank within chunk.
    order = np.argsort(assign, kind="stable")
    ch_counts = np.bincount(assign, minlength=self.nlist).astype(np.int64)
    ch_off = np.concatenate([[0], np.cumsum(ch_counts)])
    ranks = np.empty((m,), np.int64)
    ranks[order] = np.arange(m, dtype=np.int64) - ch_off[assign[order]]
    slot = dr.counts[assign] + ranks
    keep = slot < dr.lmax
    row_base = self._nstored
    slot_rec = np.empty((m,), np.int64)

    # 4. scatter kept rows into the padded layout (donated, in-place).
    #    Index vectors are padded to pow2 buckets so the jitted scatter
    #    compiles O(log) shapes, not one per chunk; padding entries repeat
    #    the first row's (list, slot, data) — a benign duplicate write.
    if keep.any():
        kidx = np.nonzero(keep)[0]
        kpad = _pad_idx(kidx)
        li = jnp.asarray(assign[kpad])
        si = jnp.asarray(slot[kpad].astype(np.int32))
        kdev = jnp.asarray(kpad)
        if codec == "sq6":
            dr.payload, dr.rn_layout, dr.rs_layout = _scatter_sq6(
                dr.payload, dr.rn_layout, dr.rs_layout, li, si,
                planes[kdev], rn[kdev], rs[kdev])
        elif codec is not None:
            dr.payload, dr.rn_layout, dr.rs_layout = _scatter_sq(
                dr.payload, dr.rn_layout, dr.rs_layout, li, si,
                rows[kdev], rn[kdev], rs[kdev])
        else:
            dr.payload = _scatter_flat(dr.payload, li, si, rows[kdev])
        dr.row_pos[assign[kidx], slot[kidx]] = (row_base
                                                + kidx).astype(np.int32)
        slot_rec[kidx] = slot[kidx]

    # 5. overflow rows → spill buffer (device append, grows by doubling).
    #    Appends are pow2-bucketed like the scatter; rows written past
    #    ``spill_n`` are garbage that the next append overwrites and that
    #    search never sees (spill_pos padding is -1 → invalid).
    if not keep.all():
        sidx = np.nonzero(~keep)[0]
        s = sidx.shape[0]
        spad = _pad_idx(sidx)
        need = dr.spill_n + s
        scap = (dr.spill_payload.shape[0]
                if dr.spill_payload is not None else 0)
        if dr.spill_n + spad.shape[0] > scap:
            new_cap = max(4096, scap)
            while new_cap < dr.spill_n + spad.shape[0]:
                new_cap *= 2
            grown = jnp.zeros((new_cap,) + rows.shape[1:], rows.dtype)
            if dr.spill_payload is not None:
                grown = jax.lax.dynamic_update_slice(
                    grown, dr.spill_payload, (0, 0))
            dr.spill_payload = grown
        dr.spill_payload = _append_spill(dr.spill_payload,
                                         jnp.int32(dr.spill_n),
                                         rows[jnp.asarray(spad)])
        dr.spill_assign = np.concatenate(
            [dr.spill_assign, assign[sidx]])
        dr.spill_pos = np.concatenate(
            [dr.spill_pos, (row_base + sidx).astype(np.int32)])
        if rn is not None:
            # per-row Σ(scale·c)² / Σc for the decode-free int8 spill scan
            dr.spill_rn = np.concatenate(
                [dr.spill_rn, np.asarray(rn)[sidx]])
            dr.spill_rs = np.concatenate(
                [dr.spill_rs, np.asarray(rs)[sidx]])
        slot_rec[sidx] = -(np.arange(dr.spill_n, need, dtype=np.int64) + 1)
        dr.spill_n = need

    # 6. host bookkeeping.
    dr.counts += ch_counts
    dr.slot = np.concatenate([dr.slot, slot_rec])
    self._ids = np.concatenate([self._ids, ids])
    self._assign = np.concatenate([self._assign, assign])
    dr.version += 1
    self._invalidate()


def dr_device_layout(self):
    """Serving tuple of the device-resident layout: (payload, counts,
    row_pos, centroids[, row_norm, row_sum, vmin, scale]).  The big arrays
    already live on the device; only counts (KBs) and row_pos (MBs)
    upload.  Also refreshes ``_device_spill``."""
    if self._device_padded is not None:
        return self._device_padded
    dr = self._dr
    kept = np.minimum(dr.counts, dr.lmax).astype(np.int32)
    dev = (dr.payload, jnp.asarray(kept), jnp.asarray(dr.row_pos),
           jnp.asarray(self._centroids))
    if self.sq_type is not None:
        vmin, scale = self._sq_ranges()
        dev += (dr.rn_layout, dr.rs_layout, vmin, scale)
    self._device_padded = dev
    if dr.spill_n:
        scap = dr.spill_payload.shape[0]
        # Trim over-planned capacity at serve time: the layout plans the
        # spill from expected list overflow, but capped assignment
        # (assign_topk) redirects part of it into free slots, leaving
        # dead capacity next to the payload.  Keep 12.5% slack for
        # future appends (growth re-doubles if it runs out); 2048-row
        # granularity keeps the spill scan's chunks large.
        need_cap = max(4096, -(-int(dr.spill_n * 9 // 8) // 2048) * 2048)
        row_b = dr.spill_payload.dtype.itemsize * dr.spill_payload.shape[1]
        if need_cap < scap and (scap - need_cap) * row_b > (256 << 20):
            # XLA cannot alias a shrinking slice, so old (scap rows) and
            # new (need_cap rows) buffers coexist during the copy.  Free
            # the old buffer as soon as the copy lands so the overlap is
            # bounded by the slice itself, not by GC.
            old = dr.spill_payload
            dr.spill_payload = _shrink_rows(old, need_cap)
            jax.block_until_ready(dr.spill_payload)
            if hasattr(old, "delete"):
                old.delete()
            scap = need_cap
        from ..utils.config import pad_rows

        self._device_spill = (
            dr.spill_payload,
            jnp.asarray(pad_rows(dr.spill_assign, scap).astype(np.int32)),
            jnp.asarray(pad_rows(dr.spill_pos, scap,
                                 fill=-1).astype(np.int32)),
            int(dr.spill_n),    # scan bound: capacity is ~2x the rows
            (jnp.asarray(pad_rows(dr.spill_rn, scap))
             if dr.spill_rn.size else None),
            (jnp.asarray(pad_rows(dr.spill_rs, scap))
             if dr.spill_rs.size else None),
        )
    else:
        self._device_spill = None
    return self._device_padded


def dr_reconstruct(self, key: int) -> np.ndarray:
    """Stored vector by position in device-resident mode (one-row device
    gather + host decode)."""
    dr = self._dr
    rec = int(dr.slot[key])
    if rec >= 0:
        if self.sq_type == "sq6":
            # plane-major (3, d4) → row-major bytes (w-index = g*3 + b)
            lm = dr.payload.shape[1] // 3
            pm = np.asarray(dr.payload[
                int(self._assign[key]),
                jnp.asarray([rec, lm + rec, 2 * lm + rec]), :])
            row = pm.transpose(1, 0).reshape(-1)
        else:
            row = np.asarray(dr.payload[int(self._assign[key]), rec])
    else:
        row = np.asarray(dr.spill_payload[-rec - 1])
    if self.sq_type is None:
        return row.astype(np.float32)
    q = sq_unpack_host(row[None, :], self.d, self.sq_type)[0]
    return (q.astype(np.float32) * self._sq_scale + self._sq_vmin)


def dr_materialize_codes(self) -> np.ndarray:
    """Fetch the device layout back into the host insertion-order code /
    row matrix (used by state_dict so save/load round-trips into a normal
    host-path index).  One bulk payload fetch — O(corpus bytes)."""
    dr = self._dr
    n = self._nstored
    payload_h = np.asarray(dr.payload)
    if self.sq_type == "sq6":
        # plane-major SQ6 (nlist, 3*lmax, d4) → row-major (nlist, lmax,
        # 3*d4) with w-index = group*3 + byte.
        nlist_, l3, d4 = payload_h.shape
        payload_h = np.ascontiguousarray(
            payload_h.reshape(nlist_, 3, l3 // 3, d4)
            .transpose(0, 2, 3, 1)).reshape(nlist_, l3 // 3, -1)
    width = payload_h.shape[2]
    out = np.empty((n, width), payload_h.dtype)
    kept = dr.slot >= 0
    if kept.any():
        out[kept] = payload_h[self._assign[kept], dr.slot[kept]]
    if dr.spill_n:
        spill_h = np.asarray(dr.spill_payload)[:dr.spill_n]
        out[~kept] = spill_h[(-dr.slot[~kept] - 1)]
    return out


IVFIndex._supports_device_ingest = True
IVFIndex.train_device = ivf_train_device
IVFIndex.add_device = ivf_add_device
IVFIndex._dr_device_layout = dr_device_layout
IVFIndex._dr_reconstruct = dr_reconstruct
IVFIndex._dr_materialize_codes = dr_materialize_codes
