"""Multi-host runtime: jax.distributed bootstrap, hash partitioning, and the
cross-host search driver.

The reference is strictly single-process (SURVEY.md §2.3: no distributed
backend).  This module is the scale-out tier the rebuild adds:

* ``init_multihost`` — thin wrapper over ``jax.distributed.initialize``;
* ``hash_partition`` — deterministic row→host assignment so every host
  ingests only its slice of a shared corpus stream (the analogue of the
  hash-partitioned vector table in BASELINE.json's north star);
* ``MultiHostSearcher`` — drives a global-mesh sharded search: within a
  slice the merge rides ICI via ``parallel.sharded``; across process
  boundaries the final k-lists (tiny: k entries per shard) are merged on
  host by the native C++ S-way merger (``native.merge_topk``) so DCN only
  ever carries k·S candidates per query.

Everything here also runs single-process against a local mesh, which is how
the test-suite exercises it (no multi-host hardware in this environment —
the ``jax.distributed`` path is exercised by the driver's dry run instead).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..native import load_native
from ..ops.flat_search import SIMILARITY_METRICS


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (no-op when already initialised or
    when running single-process with no coordinator configured)."""
    if coordinator_address is None:
        return  # single-process run
    # NOTE: must not touch jax.devices()/process_count() before initialize —
    # that would initialise the XLA backend and make initialize() raise.
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialised
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def hash_partition(ids: np.ndarray, num_partitions: int) -> np.ndarray:
    """Deterministic partition assignment for int64 ids (splitmix64 finalizer
    — uniform even for sequential ids, unlike modulo)."""
    z = ids.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(num_partitions)).astype(np.int64)


def local_rows(ids: np.ndarray, num_partitions: int | None = None,
               partition: int | None = None) -> np.ndarray:
    """Boolean mask of the rows this process owns under hash partitioning."""
    nparts = num_partitions if num_partitions is not None \
        else jax.process_count()
    part = partition if partition is not None else jax.process_index()
    return hash_partition(ids, nparts) == part


def merge_host_topk(dists: np.ndarray, labels: np.ndarray,
                    metric: str, k: int | None = None):
    """Merge per-shard sorted top-k lists (S, nq, k) into (nq, k) on host —
    the DCN-side merge.  Uses the native C++ S-way merger when built."""
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    s, nq, kk = dists.shape
    k = k if k is not None else kk
    descending = metric in SIMILARITY_METRICS

    native = load_native()
    if native is not None and s <= 4096 and k == kk:
        return native.merge_topk(dists, labels, descending)

    # numpy fallback: flatten shard lists per query and partial-sort.
    flat_d = dists.transpose(1, 0, 2).reshape(nq, s * kk)
    flat_l = labels.transpose(1, 0, 2).reshape(nq, s * kk)
    key = np.where(flat_l < 0,
                   -np.inf if descending else np.inf,
                   flat_d)
    order = np.argsort(-key if descending else key, axis=1,
                       kind="stable")[:, :k]
    return (np.take_along_axis(flat_d, order, axis=1),
            np.take_along_axis(flat_l, order, axis=1))


class PartitionedIndex:
    """Hash-partitioned corpus over S member indexes — the multi-host
    search driver.

    Each member owns the rows whose label hashes to its partition
    (one member per host in a real deployment; in-process members work the
    same way and are how this is tested).  Searches fan out to every
    member, each returns its local top-k, and the k·S candidates are merged
    host-side (native C++ S-way merge) — the DCN leg of BASELINE.json's
    north star.  Exact: every corpus row is owned by exactly one member.
    """

    def __init__(self, members):
        if not members:
            raise ValueError("need at least one member index")
        self.members = list(members)
        d = {m.d for m in self.members}
        if len(d) != 1:
            raise ValueError(f"member dimensions differ: {d}")
        self.d = d.pop()
        self.metric = self.members[0].metric

    @property
    def ntotal(self) -> int:
        return sum(m.ntotal for m in self.members)

    def add_with_ids(self, x, ids) -> None:
        x = np.asarray(x, np.float32)
        ids = np.asarray(ids, np.int64).reshape(-1)
        parts = hash_partition(ids, len(self.members))
        for p, member in enumerate(self.members):
            sel = parts == p
            if sel.any():
                member.add_with_ids(x[sel], ids[sel])

    def add(self, x) -> None:
        start = self.ntotal
        x = np.asarray(x, np.float32)
        self.add_with_ids(x, np.arange(start, start + x.shape[0],
                                       dtype=np.int64))

    def train(self, x) -> None:
        for member in self.members:
            member.train(x)

    def search(self, xq, k, params=None, selector=None):
        from ..models.base import SearchResult
        from ..params import EMPTY

        params = params if params is not None else EMPTY
        results = [m.search(xq, k, params, selector) for m in self.members]
        dists = np.stack([r.distances for r in results])   # (S, nq, k)
        labels = np.stack([r.labels for r in results])
        d, l = merge_host_topk(dists, labels, self.metric.name, k)
        return SearchResult(d, l)
