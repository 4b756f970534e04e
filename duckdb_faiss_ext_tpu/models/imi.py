"""IMI: IVF over a product (multi-index) coarse quantizer (split
from models/ivf.py)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import SIMILARITY_METRICS
from ..ops.kmeans import kmeans_fit
from ..utils.config import memory_budget
from .base import Index
from .ivf import IVFIndex

class IMIIndex(IVFIndex):
    """IVF over a product (multi-index) coarse quantizer — the factory's
    ``IMI2x{nbits}[,encoding]`` heads (faiss::MultiIndexQuantizer feeding
    IndexIVF*, reachable through the reference's pass-through factory call,
    src/faiss_extension.cpp:154-155).

    The coarse space is the cross product of two codebooks of K = 2^nbits
    centroids fitted independently on the two halves of the vector, giving
    nlist = K^2 cells while training only needs n >= K points (the IMI
    advantage: 65536 cells from 256-way k-means).  Device design: the (K^2, d)
    cell-center table is materialized once at train time so every shared
    scan/layout/sharding path works unchanged (a 64-query probe against
    65536 cells is one small matmul tile); assignment stays factored per half
    — exact for L2/INNER_PRODUCT because both metrics decompose over
    disjoint coordinate blocks."""

    #: share of device memory the materialized cell-center table
    #: (4^nbits * d * 4 bytes) may take.
    TABLE_MEMORY_FRACTION = 1 / 16

    @property
    def max_table_bytes(self) -> int:
        return memory_budget(self.TABLE_MEMORY_FRACTION)
    #: the mirror quantizer is never consulted for IMI (assignment is
    #: factored, probing uses the cell table directly); copying the table
    #: into it would double host memory.
    _mirror_quantizer = False

    def __init__(self, d: int, metric: Metric, metric_arg: float,
                 nbits: int, quantizer: Index, encoding: str = "Flat"):
        nbits = int(nbits)
        if nbits < 1:
            raise errors.InvalidInputError(
                f"IMI needs at least 1 bit per sub-quantizer, got {nbits}")
        if d % 2:
            raise errors.InvalidInputError(
                f"The dimension of the vector ({d}) must be even for an "
                f"IMI2x coarse quantizer")
        table_bytes = (1 << (2 * nbits)) * d * 4
        if table_bytes > self.max_table_bytes:
            raise errors.InvalidInputError(
                f"IMI2x{nbits} at dimension {d} needs a "
                f"{table_bytes >> 20} MiB cell table (cap "
                f"{self.max_table_bytes >> 20} MiB); use fewer bits")
        super().__init__(d, metric, metric_arg, nlist=1 << (2 * nbits),
                         quantizer=quantizer, encoding=encoding)
        if metric.name not in ("L2", "INNER_PRODUCT"):
            raise errors.InvalidInputError(
                f"IMI indexes support only L2 and INNER_PRODUCT metrics, "
                f"got {metric.name}")
        self.imi_nbits = nbits

    def _train_coarse(self, x):
        K = 1 << self.imi_nbits
        x = self._subsample_train(x, K)
        h = self.d // 2
        hp = jax.lax.Precision.HIGHEST
        bal = getattr(self, "train_balance", 0.0)
        cb1, _ = kmeans_fit(x[:, :h], K, niter=self.train_niter,
                            seed=self.train_seed, precision=hp, balance=bal)
        cb2, _ = kmeans_fit(x[:, h:], K, niter=self.train_niter,
                            seed=self.train_seed + 1, precision=hp,
                            balance=bal)
        cb1 = np.asarray(cb1, np.float32)
        cb2 = np.asarray(cb2, np.float32)
        # Cell (i, j) → list i*K + j, center = concat(cb1[i], cb2[j]).
        table = np.concatenate([np.repeat(cb1, K, axis=0),
                                np.tile(cb2, (K, 1))], axis=1)
        return np.ascontiguousarray(table), x

    def _imi_codebooks(self):
        """Factored sub-codebooks recovered from the materialized table
        (no separate serialized state needed)."""
        K = 1 << self.imi_nbits
        h = self.d // 2
        return self._centroids[::K, :h], self._centroids[:K, h:]

    def _assign_lists(self, x: np.ndarray) -> np.ndarray:
        """Exact factored assignment: per-half nearest sub-centroid.  For
        L2/IP the cell score is the sum of the two half scores over disjoint
        coordinates, so the per-half argbest minimizes over all K^2 cells
        without forming them."""
        from ..ops.distance import pairwise_tile

        if x.shape[0] == 0:
            return np.empty((0,), dtype=np.int32)
        K = 1 << self.imi_nbits
        h = self.d // 2
        cb1, cb2 = self._imi_codebooks()
        sim = self.metric.name in SIMILARITY_METRICS
        hp = jax.lax.Precision.HIGHEST
        chunk = max(1024, min(65536, (1 << 27) // K))
        parts = []
        for i in range(0, x.shape[0], chunk):
            xc = jnp.asarray(x[i:i + chunk])
            t1 = pairwise_tile(xc[:, :h], jnp.asarray(cb1),
                               self.metric.name, self.metric_arg, hp)
            t2 = pairwise_tile(xc[:, h:], jnp.asarray(cb2),
                               self.metric.name, self.metric_arg, hp)
            a1 = (jnp.argmax(t1, 1) if sim else jnp.argmin(t1, 1))
            a2 = (jnp.argmax(t2, 1) if sim else jnp.argmin(t2, 1))
            parts.append((a1 * K + a2).astype(jnp.int32))
        return np.asarray(jnp.concatenate(parts), dtype=np.int32)


# Device-resident ingest lives in models/ivf_device and is wired up by
# models/ivf.py (which also sets IMIIndex._supports_device_ingest =
# False: the IMI coarse assignment is factored, not a single top-k).
