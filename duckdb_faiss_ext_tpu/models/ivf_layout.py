"""IVF storage layouts and device builds (split from models/ivf.py).

Everything that turns the host-side (codes/xb, ids, assign) state into the
device layouts the scans consume: the padded (nlist, lmax, w) list layout
(device sharding), the sorted+gather layout, selector masks aligned with
each layout, and the per-version device caches.  Methods attach to IVFIndex;
models/ivf.py holds the index lifecycle, models/ivf_serve.py the dispatch.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import errors
from ..ops.ivf_padded import choose_lmax
from ..utils.config import config, next_capacity, next_pow2, pad_rows
from .ivf import IVFIndex

def _sq_codes_dev(self):
    """Device upload of the sorted uint8 SQ codes for the decode path,
    cached per version (the int8 path never touches it)."""
    cached = getattr(self, "_sq_dev_cache", None)
    if cached is not None and cached[0] == self._version:
        return cached[1]
    storage, _, _, _ = self._build_device()
    dev = jnp.asarray(storage[0])
    self._sq_dev_cache = (self._version, dev)
    return dev

def _ivf_sq_row_extras(self):
    """Per-sorted-row (Σ(scale·c)², Σc) fp32 (cap,) pair for the int8 IVF
    scan (ops/ivf_scan.py::ivf_sq_int8_search), which reads the SAME
    packed device code buffer as the decode path — this is its only extra
    state.  Cached per version, aligned with _build_device's order."""
    cached = getattr(self, "_int8_cache", None)
    if cached is not None and cached[0] == self._version:
        return cached[1]
    from ..ops.sq import sq_row_norms, sq_row_sums

    storage, _, _, order = self._build_device()
    cap = storage[0].shape[0]
    n = self._nstored
    codes = self._codes[order] if n else self._codes   # (n, w) packed
    rn = sq_row_norms(codes, self._sq_scale, self.d, self.sq_type)
    rs = sq_row_sums(codes, self.d, self.sq_type)
    state = (jnp.asarray(pad_rows(rn, cap)), jnp.asarray(pad_rows(rs, cap)))
    self._int8_cache = (self._version, state)
    return state


def _counts(self) -> np.ndarray:
    cache = getattr(self, "_counts_cache", None)
    if cache is not None and cache[0] == self._version:
        return cache[1]
    c = (np.bincount(self._assign, minlength=self.nlist)
         if self.ntotal else np.zeros((self.nlist,), np.int64))
    self._counts_cache = (self._version, c)
    return c

def _build_list_layout(self):
    """Host-side padded list layout for device sharding: (payload (nlist,
    lmax, w), counts (nlist,), row_pos (nlist, lmax)) — payload is byte
    codes for PQ/SQ storage, raw fp32 rows otherwise."""
    n = self._nstored
    counts = self._counts()
    if n and counts.max() > max(32 * n / self.nlist, 4096):
        import sys

        print(f"duckdb_faiss_ext_tpu: IVF list skew is extreme "
              f"(max {counts.max()} vs avg {n / self.nlist:.0f}); the "
              f"padded layout will be memory-heavy — consider retraining "
              f"(kmeans_balance) or fewer lists", file=sys.stderr)
    lmax = choose_lmax(max(1, int(counts.max()) if n else 1))
    row_pos = np.full((self.nlist, lmax), -1, np.int32)
    order = np.argsort(self._assign, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    raw = self._codes if self._codes is not None else self._xb
    w = raw.shape[1] if self._codes is not None else self.d
    payload = np.zeros((self.nlist, lmax, w), raw.dtype)
    if n:
        # Vectorized scatter (a Python loop over nlist was the build
        # bottleneck at 16k lists): rank of each sorted row within its
        # list is its padded slot.
        sorted_assign = self._assign[order]
        ranks = np.arange(n, dtype=np.int64) - offsets[sorted_assign]
        flat = sorted_assign.astype(np.int64) * lmax + ranks
        payload.reshape(-1, w)[flat] = raw[order]
        row_pos.reshape(-1)[flat] = order
    return payload, counts.astype(np.int32), row_pos

def _mask_labels_dev(self):
    """Per-version cached labels_for_device_mask resolution (uploading
    the 8.8M-row int64 label table per filtered call would cost more
    than the host path it replaces)."""
    from ..ops.selectors import labels_for_device_mask

    hit = getattr(self, "_mask_ids_dev", None)
    if hit is not None and hit[0] == self._version:
        return hit[1]
    val = labels_for_device_mask(self._ids)
    self._mask_ids_dev = (self._version, val)
    return val

def _spill_mask(self, selector):
    key = ("spill", selector.cache_key(), self._version)
    hit = self._mask_cache.get(key)
    if hit is not None:
        return hit
    from ..ops.selectors import device_row_mask

    dev = device_row_mask(selector, self._device_spill[2],
                          _mask_labels_dev(self))
    if dev is None:                     # host fallback (odd selectors)
        sp_pos = np.asarray(self._device_spill[2])
        passing = selector.contains(self._ids)
        mask = np.zeros(sp_pos.shape, bool)
        valid = sp_pos >= 0
        mask[valid] = passing[sp_pos[valid]]
        dev = jnp.asarray(mask)
    self._mask_cache[key] = dev
    return dev

def _padded_mask(self, selector):
    """Selector mask over the device-resident (nlist, lmax) slots."""
    key = ("padded", selector.cache_key(), self._version)
    hit = self._mask_cache.get(key)
    if hit is not None:
        return hit
    # Device-side build: gather+bit-test over the device-resident
    # row_pos from the ~n/8-byte packed bitmap (or sorted id set) —
    # replaces an O(n) host unpack + O(nlist*lmax) scatter + mask
    # upload per call.
    from ..ops.selectors import device_row_mask

    dev = device_row_mask(selector, self._dr_device_layout()[2],
                          _mask_labels_dev(self))
    if dev is None:                     # host fallback (odd selectors)
        rp = self._dr.row_pos          # host copy, no device fetch
        passing = selector.contains(self._ids)
        mask = np.zeros(rp.shape, np.int8)
        valid = rp >= 0
        mask[valid] = passing[rp[valid]]
        dev = jnp.asarray(mask)
    self._mask_cache = {key: dev}
    return dev

# --- device build ----------------------------------------------------
def _build_device(self):
    if self._dr is not None:
        raise errors.InvalidInputError(
            "this device-resident index serves only through its padded "
            "list scan (range search needs a host-path index)")
    if self._device is not None:
        return self._device
    n = self._nstored
    order = np.argsort(self._assign, kind="stable")
    sorted_assign = self._assign[order]
    counts = np.bincount(sorted_assign, minlength=self.nlist)
    # Scan window length: the longest list, pow2-bucketed so adds don't
    # re-jit every time the max grows.  Lists are CONTIGUOUS blocks of
    # the sorted buffer — the scans slice (lmax, w) windows per probe
    # (ops/ivf_scan.slice_probed_lists); no (nlist, lmax) index table.
    lmax = max(1, int(counts.max()) if n else 1)
    lmax = max(128, next_pow2(lmax))

    # capacity bucketing: padding rows past n are never inside a probed
    # window (offsets/counts bound every list's rows).
    cap = max(config.min_capacity, next_capacity(n + 1))

    if self.pq_m is not None:
        codes_sorted = pad_rows(self._codes[order] if n else self._codes,
                                cap)
        assign_sorted = pad_rows(sorted_assign, cap).astype(np.int32)
        self._device = (
            (jnp.asarray(codes_sorted), jnp.asarray(assign_sorted),
             jnp.asarray(self._pq_codebooks)),
            lmax,
            jnp.asarray(self._centroids),
            order.astype(np.int64),
        )
    elif self.sq_type is not None:
        # Codes stay HOST-side here: the int8 fast path and the uint8
        # decode path each upload their own representation lazily
        # (_ivf_int8_state / _sq_codes_dev) — uploading both would
        # double corpus HBM (13.6 GB × 2 at the MARCO scale).
        codes_sorted = pad_rows(self._codes[order] if n else self._codes,
                                cap)
        vmin, scale = self._sq_ranges()
        self._device = (
            (codes_sorted, vmin, scale),
            lmax,
            jnp.asarray(self._centroids),
            order.astype(np.int64),
        )
    else:
        xb_sorted = pad_rows(self._xb[order] if n else self._xb, cap)
        self._device = (
            jnp.asarray(xb_sorted),
            lmax,
            jnp.asarray(self._centroids),
            order.astype(np.int64),
        )
    return self._device

# --- selector --------------------------------------------------------
def row_labels(self) -> np.ndarray:
    return self._ids

def _selector_mask(self, selector, order):
    key = (selector.cache_key(), self._version)
    hit = self._mask_cache.get(key)
    if hit is not None:
        return hit
    rows = selector.contains(self._ids[order])  # sorted order
    storage = self._device[0]
    cap = (storage[0] if isinstance(storage, tuple) else storage).shape[0]
    mask = jnp.asarray(pad_rows(rows, cap, fill=False))
    self._mask_cache = {key: mask}
    return mask


def _sorted_list_meta(self):
    """(offsets, counts) int32 device arrays describing the sorted
    layout's contiguous list blocks (for slice_probed_lists); cached
    per version."""
    cached = getattr(self, "_list_meta_cache", None)
    if cached is not None and cached[0] == self._version:
        return cached[1]
    c = self._counts().astype(np.int64)
    off = np.concatenate([[0], np.cumsum(c[:-1])]) if c.size else c
    meta = (jnp.asarray(off.astype(np.int32)),
            jnp.asarray(c.astype(np.int32)))
    self._list_meta_cache = (self._version, meta)
    return meta

def _sorted_srcrow(self, order) -> np.ndarray:
    """_srcrow permuted into sorted layout, cached per build like
    _sorted_ids (same O(_nstored)-per-dispatch concern)."""
    cached = getattr(self, "_srcrow_sorted", None)
    if cached is None or cached[0] is not order:
        cached = (order, self._srcrow[order])
        self._srcrow_sorted = cached
    return cached[1]

def _sorted_ids(self, order) -> np.ndarray:
    """ids permuted into the sorted storage layout, cached per layout
    build — the batched serving tier holds one dispatch tuple per batch,
    so materializing an O(ntotal) copy per dispatch (80 MB at the 10M
    scale) is both a host hot-path gather and a memory multiplier.
    Keyed on the identity of the layout's ``order`` array: a rebuild
    (any add) produces a fresh order object, invalidating the cache."""
    cached = self._ids_sorted
    if cached is None or cached[0] is not order:
        cached = (order, self._ids[order] if self.ntotal else self._ids)
        self._ids_sorted = cached
    return cached[1]



IVFIndex._sq_codes_dev = _sq_codes_dev
IVFIndex._ivf_sq_row_extras = _ivf_sq_row_extras
IVFIndex._counts = _counts
IVFIndex._build_list_layout = _build_list_layout
IVFIndex._spill_mask = _spill_mask
IVFIndex._padded_mask = _padded_mask
IVFIndex._build_device = _build_device
IVFIndex.row_labels = row_labels
IVFIndex._selector_mask = _selector_mask
IVFIndex._sorted_list_meta = _sorted_list_meta
IVFIndex._sorted_srcrow = _sorted_srcrow
IVFIndex._sorted_ids = _sorted_ids
