"""Device-sharded IVF placement (split from models/ivf.py).

faiss_to_gpu analogue: the padded list layout partitioned over a mesh's
'shard' axis, searched through parallel.sharded.sharded_ivf_search_fn with
the all-gather top-k merge.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import errors
from ..utils.config import config
from .ivf import IVFIndex

def _ivf_shard_over(self, mesh) -> None:
    """faiss_to_gpu analogue for IVF: partition the padded list layout over
    the mesh's 'shard' axis (each device owns a contiguous block of lists);
    searches then run through parallel.sharded.sharded_ivf_search_fn with
    the all-gather top-k merge.  The placement is sticky across adds (the
    sharded layout rebuilds on the same mesh after mutations)."""
    if self.metric.name not in ("L2", "INNER_PRODUCT"):
        raise errors.InvalidInputError(
            f"IVF indexes with metric {self.metric.name} cannot be sharded "
            f"over devices (only L2 and INNER_PRODUCT)")
    if self._dr is not None:
        raise errors.InvalidInputError(
            "a device-resident index cannot be re-sharded with "
            "faiss_to_device (its layout lives on one device)")
    if "batch" not in mesh.shape or "shard" not in mesh.shape:
        raise errors.InvalidInputError(
            "IVF sharding needs a mesh with 'shard' and 'batch' axes "
            "(parallel.placement.default_mesh builds one)")
    nshards = int(mesh.shape["shard"])
    if self.nlist % nshards:
        # Auto-shrink to the largest list-count divisor that fits the
        # devices (the default mesh uses every local device; small indexes
        # can't use them all).
        usable = next(g for g in range(min(nshards, self.nlist), 0, -1)
                      if self.nlist % g == 0)
        import numpy as _np
        from jax.sharding import Mesh as _Mesh

        devs = mesh.devices.reshape(-1)[: usable]
        mesh = _Mesh(_np.array(devs).reshape(usable, 1),
                     ("shard", "batch"))
    self._shard_mesh = mesh
    # Re-sharding onto a different mesh must drop the old placement: the
    # array cache is keyed only on _version and the shard_map fn cache
    # doesn't include the mesh, so stale entries would silently keep the
    # index on the previous device set.
    self._device_sharded = None
    self._sharded_fn_cache = None


def _ivf_build_sharded(self):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    if getattr(self, "_device_sharded", None) is not None \
            and self._device_sharded[0] == self._version:
        return self._device_sharded[1]
    mesh = self._shard_mesh
    payload, counts, row_pos = self._build_list_layout()
    # Skew-aware placement: permute lists so each shard's contiguous
    # block carries a balanced Σcounts (hot lists are probed most — a
    # raw contiguous block parks them all on one device).  The centroids
    # are permuted identically, so probe ids computed inside the sharded
    # search already live in permuted space and the search kernel,
    # masks, and returned row positions need no translation
    # (parallel.sharded.balanced_list_partition).
    from ..parallel.sharded import balanced_list_partition

    nshards = int(mesh.shape["shard"])
    perm = balanced_list_partition(counts, nshards)
    self._shard_perm = perm
    arrays = (
        jax.device_put(payload[perm],
                       NamedSharding(mesh, P("shard", None, None))),
        jax.device_put(counts[perm], NamedSharding(mesh, P("shard"))),
        jax.device_put(row_pos[perm], NamedSharding(mesh, P("shard", None))),
        jnp.asarray(self._centroids[perm]),
    )
    if self.pq_m is not None:
        arrays += (jnp.asarray(self._pq_codebooks),)
    elif self.sq_type is not None:
        arrays += self._sq_ranges()   # (vmin, scale), replicated
    self._device_sharded = (self._version, arrays)
    return arrays


def _ivf_sharded_mask(self, selector):
    """Selector mask aligned with the sharded (nlist, lmax) layout, placed
    with the same 'shard' partitioning as the lists."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    key = ("sharded", selector.cache_key(), self._version)
    hit = self._mask_cache.get(key)
    if hit is not None:
        return hit
    row_pos = np.asarray(self._build_sharded()[2])
    passing = selector.contains(self._ids)
    mask = np.zeros(row_pos.shape, np.int8)
    valid = row_pos >= 0
    mask[valid] = passing[row_pos[valid]]
    dev = jax.device_put(mask,
                         NamedSharding(self._shard_mesh, P("shard", None)))
    self._mask_cache = {key: dev}
    return dev


def _ivf_search_sharded(self, xq_pad, k_eff, nprobe_eff, selector):
    from ..parallel.sharded import sharded_ivf_search_fn

    arrays = self._build_sharded()
    payload, counts, row_pos, centroids = arrays[:4]
    pq = self.pq_m is not None
    sq = self.sq_type
    has_mask = selector is not None
    key = (k_eff, nprobe_eff, self.metric.name, xq_pad.shape[0], pq,
           self.pq_codec, sq, has_mask, config.precision)
    cache = getattr(self, "_sharded_fn_cache", None)
    if cache is None:
        cache = self._sharded_fn_cache = {}
    fn = cache.get(key)
    if fn is None:
        fn = cache[key] = sharded_ivf_search_fn(
            self._shard_mesh, k=k_eff, nprobe=nprobe_eff,
            metric=self.metric.name,
            q_chunk=min(8, xq_pad.shape[0]),
            precision=config.precision, pq=pq, pq_codec=self.pq_codec,
            sq=sq, has_mask=has_mask)
    extras = arrays[4:]  # codebooks (PQ) or vmin/scale (SQ)
    if has_mask:
        extras += (self._ivf_sharded_mask(selector),)
    return fn(payload, counts, row_pos, centroids, xq_pad,
              jnp.asarray(self.metric_arg, jnp.float32), *extras)


IVFIndex.shard_over = _ivf_shard_over
IVFIndex._build_sharded = _ivf_build_sharded
IVFIndex._search_sharded = _ivf_search_sharded
IVFIndex._ivf_sharded_mask = _ivf_sharded_mask


def _ivf_sharded_lmax(self) -> int:
    return self._build_sharded()[0].shape[1]


IVFIndex._ivf_sharded_lmax = _ivf_sharded_lmax
