"""Flat (exact brute-force) index over a padded device buffer.

The device IndexFlat: vectors live in a host mirror (numpy, the source of
truth for add/save/rebuild) and a device buffer padded to a power-of-two
capacity so jit caches stay warm across adds.  Search is the fused
distance + top-k kernel on a single GPU where it applies
(ops/flat_topk.py), the XLA distance scan + top-k otherwise
(ops/flat_search.py).

"Mutable add against immutable XLA buffers" (SURVEY.md §7 hard part 3) is
solved by capacity bucketing: the device buffer is re-materialised only when
the capacity bucket grows (amortised O(n) like std::vector), not per add.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ..metrics import Metric
from ..ops.flat_search import flat_search
from ..ops.flat_topk import fused_flat_search, use_fused_kernel
from ..ops.selectors import Selector
from ..utils.config import config, next_capacity, next_pow2, pad_rows
from ..utils.transfer import upload_queries
from .base import Index, SearchResult, as_matrix


class FlatIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 storage: str = "f32"):
        super().__init__(d, metric, metric_arg)
        #: "f32" (default) or "pm1_i8": ±1 sign codes stored int8 — the
        #: int8 dot is EXACT for them (int32 accumulation) at 4× less
        #: HBM than fp32.  Used by LSHIndex for its code corpus; only
        #: INNER_PRODUCT ordering is meaningful for sign codes.
        self.storage = storage
        self._xb = np.empty(
            (0, d), dtype=np.int8 if storage == "pm1_i8" else np.float32)
        self._version = 0
        self._device_xb: jax.Array | None = None  # (cap, d), cap = pow2
        #: sticky placement (a NamedSharding) set by faiss_to_device; adds
        #: invalidate the buffer but re-materialisation keeps the sharding.
        self._placement = None
        self._mask_cache: dict = {}

    # --- storage ---------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self._xb.shape[0]

    @property
    def version(self) -> int:
        return self._version

    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        if self.storage == "pm1_i8":
            x = np.where(x > 0, 1, -1).astype(np.int8)
        start = self.ntotal
        self._xb = np.concatenate([self._xb, x], axis=0) if start else x
        self._version += 1
        # Streaming ingest stays O(batch), not O(corpus): while the new
        # rows fit the current capacity bucket, write only the delta into
        # the live device buffer; otherwise invalidate for a re-upload at
        # the grown capacity.
        if (self._device_xb is not None
                and self.ntotal <= self._device_xb.shape[0]):
            self._device_xb = jax.lax.dynamic_update_slice(
                self._device_xb, jnp.asarray(x), (start, 0))
        else:
            self._device_xb = None
        self._mask_cache.clear()

    def vectors(self) -> np.ndarray:
        """Host view of stored vectors (n, d)."""
        return self._xb

    def reconstruct(self, key: int) -> np.ndarray:
        return self._xb[key]

    def _capacity(self) -> int:
        from .base import placement_capacity

        return placement_capacity(
            max(config.min_capacity, next_capacity(max(self.ntotal, 1))),
            self._placement)

    def device_vectors(self) -> jax.Array:
        """Padded (cap, d) device buffer; re-uploaded only when the capacity
        bucket changed or data was invalidated.  A placement set by
        faiss_to_device is sticky across adds."""
        cap = self._capacity()
        if self._device_xb is None or self._device_xb.shape[0] < cap:
            host = pad_rows(self._xb, cap)
            if self._placement is not None:
                self._device_xb = jax.device_put(host, self._placement)
            else:
                self._device_xb = jnp.asarray(host)
        return self._device_xb

    def set_placement(self, sharding) -> None:
        """Pin the corpus buffer to a device sharding (faiss_to_gpu
        analogue); None restores single-device placement."""
        self._placement = sharding
        self._device_xb = None
        self._mask_cache.clear()

    # --- selector masks ---------------------------------------------------
    def _selector_mask(self, selector: Selector) -> jax.Array:
        key = (selector.cache_key(), self._version)
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit
        rows = selector.contains(self.row_labels())
        # Pad to the live buffer's capacity (it may exceed _capacity() after
        # delta updates into a previously grown/sharded buffer).
        cap = self.device_vectors().shape[0]
        mask = jnp.asarray(pad_rows(rows, cap, fill=False))
        self._mask_cache = {key: mask}  # keep only the latest
        return mask

    # --- search ----------------------------------------------------------
    def search(self, xq, k, params=None, selector=None) -> SearchResult:
        return self.search_async(xq, k, params, selector)()

    def search_dispatch(self, xq, k, params=None, selector=None):
        """Raw device dispatch: (dist_dev (nq_pad, k_eff), pos_dev, nq,
        k_eff), or None when no device work applies (empty queries, k≤0).
        The serving tier concatenates many dispatches and fetches ONCE
        (api.faiss_search_batched) — each fetch is a host sync, so one
        packed fetch per batch group is the lever."""
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        if nq == 0 or k <= 0:
            return None
        cap = self._capacity()
        k_eff = min(k, cap)
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_pad = upload_queries(pad_rows(xq, nq_pad))
        if self.storage == "pm1_i8":
            # Queries are ±1 sign codes too (LSH encodes before dispatch);
            # the int8×int8 dot is exact, so no rerank ever applies.
            xq_pad = jnp.where(xq_pad > 0, 1, -1).astype(jnp.int8)
        mask = self._selector_mask(selector) if selector is not None else None
        # Fast mode ranks in reduced precision (TF32 on the GPU), which
        # alone drops recall@10 below 0.99 on clustered 1M×128 data: scan
        # a wider top-k and re-score those rows at HIGHEST, like the IVF
        # scans do in-chunk — fp32-exact ordering and distances at
        # ~k_scan row-gathers per query.
        rerank = (self.metric.name in ("L2", "INNER_PRODUCT")
                  and config.precision != lax.Precision.HIGHEST
                  and self.storage == "f32")
        k_scan = min(cap, max(2 * k_eff, k_eff + 16)) if rerank else k_eff
        dist_dev, pos_dev = self._dispatch_search(xq_pad, k_scan, mask)
        if rerank and k_scan > k_eff:
            from .refine import _rerank

            dist_dev, pos_dev = _rerank(
                self.device_vectors(), pos_dev.astype(jnp.int32), xq_pad,
                jnp.asarray(self.metric_arg, jnp.float32),
                k=k_eff, metric=self.metric.name,
                precision=lax.Precision.HIGHEST)
        return dist_dev, pos_dev, nq, k_eff

    def search_async(self, xq, k, params=None, selector=None):
        """Dispatch the search without waiting for the device; returns a
        zero-arg callable that fetches and formats the results.  Callers can
        submit many batches back-to-back and gather later — the dispatches
        pipeline on device, hiding per-call host latency (the serving-path
        pattern; see api.faiss_search_batched)."""
        disp = self.search_dispatch(xq, k, params, selector)
        return lambda: self._finish_dispatch(disp, xq, k)

    def _dispatch_search(self, xq_pad, k_eff, mask):
        """The fused kernel where it applies (use_fused_kernel: platform,
        precision, metric, k, storage, device count), the XLA scan
        otherwise."""
        xb = self.device_vectors()
        devices = xb.devices()
        if use_fused_kernel(next(iter(devices)).platform, self.metric.name,
                            k_eff, self.d, self.storage, len(devices),
                            config.precision):
            self._last_scan_path = "fused-topk"
            return fused_flat_search(xb, self.ntotal, xq_pad, mask,
                                     k=k_eff, metric=self.metric.name,
                                     precision=config.precision)
        self._last_scan_path = "xla-scan"
        return flat_search(xb, self.ntotal, xq_pad, k_eff, self.metric.name,
                           self.metric_arg, mask=mask,
                           precision=config.precision)

    # --- range search -----------------------------------------------------
    def range_search(self, xq, radius, params=None, selector=None):
        from ..ops.range import (empty_range_result, choose_range_chunk,
                             range_num_chunks,
                                 _range_tile, range_scan_dense)

        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        if nq == 0 or self.ntotal == 0:
            return empty_range_result(nq)
        xb = self.device_vectors()
        cap = xb.shape[0]
        chunk = choose_range_chunk(cap)
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_dev = jnp.asarray(pad_rows(xq, nq_pad))
        marg = jnp.asarray(self.metric_arg, jnp.float32)
        passing = (selector.contains(self.row_labels())
                   if selector is not None else None)

        def get_tile(i):
            tile = xb[i * chunk:(i + 1) * chunk]
            if tile.dtype == jnp.int8:
                tile = tile.astype(jnp.float32)
            return _range_tile(tile, xq_dev, marg,
                               metric=self.metric.name,
                               precision=config.precision)

        return range_scan_dense(get_tile, range_num_chunks(cap, chunk), chunk, self.ntotal,
                                nq, float(radius), self.metric.name, passing)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"xb": self._xb}

    def load_state(self, state: dict) -> None:
        dt = np.int8 if self.storage == "pm1_i8" else np.float32
        self._xb = np.asarray(state["xb"], dtype=dt).reshape(-1, self.d)
        self._version += 1
        self._device_xb = None
        self._mask_cache.clear()
