"""HNSW-compatible index surface.

The reference builds faiss::IndexHNSW via factory strings (``HNSW16``,
``IDMap,HNSW32``, ``IDMap,HNSW128,Flat``) and tunes it through
``efConstruction`` at create time and ``efSearch`` at search time
(src/faiss_extension.cpp:133-141, 691-702).

Sequential graph-walking ANN is accelerator-hostile (pointer chasing,
data-dependent control flow — SURVEY.md §2.2), so this index accepts the
full HNSW surface but executes batch-shaped searches — the "lower to
accelerator-friendly" decision of SURVEY.md §7 step 8.  Three regimes:

* small corpora (< ``ann_threshold`` rows): the fused exact matmul scan
  (FlatIndex) — recall 1.0, still faster than any ANN at these sizes;
* at scale (default): a *batched graph walk* over a CAGRA-style
  fixed-degree neighbour graph (ops/graph.py) — true graph-algorithm
  parity with HNSW, reshaped into matmuls: static-shape frontier expansion,
  wide top-k merges, no pointer chasing.  efSearch maps to the candidate
  pool (CAGRA itopk) exactly like HNSW's candidate heap; the graph degree
  comes from M (HNSW's layer-0 degree 2M, capped at 64).  Graph build is
  an exact kNN scan (one jitted device program) + reverse-edge
  augmentation; rows added after the build are exact-scanned ("tail") and
  merged until the tail outgrows 20% of the corpus, which triggers a
  rebuild.
* ``accel=ivf`` create param, SOAR (``soar_lambda``), corpora past
  ``graph_max`` (where the O(n²) graph build stops paying), or legacy
  saves: an internal IVF partition (nlist ≈ √n) searched with nprobe
  mapped from efSearch (nprobe = max(1, efSearch/4)), same tail-merge
  policy.

``{"exact": "true"}`` always forces the exact path.
"""

from __future__ import annotations

import numpy as np

from .. import errors
from ..metrics import Metric
from ..params import EMPTY
from ..utils.config import memory_budget
from .base import SearchResult
from .flat import FlatIndex


class HNSWIndex(FlatIndex):
    #: corpus size where the internal IVF partition takes over from the
    #: exact scan (graph ANN only pays at scale; below this the matmul scan is
    #: already faster than a graph walk).
    ann_threshold = 200_000
    #: rebuild the partition when rows added since the build exceed this
    #: fraction of the corpus (until then they are scanned exactly).
    tail_rebuild_fraction = 0.2

    #: corpus size up to which the graph BUILD uses the exact O(n²) kNN
    #: scan (~seconds at 1M); beyond it the clustered top-2-list build
    #: (ops/graph.build_knn_graph_clustered, cost n²·4/nlist) takes over,
    #: so the graph regime itself has no size ceiling.
    graph_max = 2_000_000

    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 M: int = 32, storage: str = "Flat"):
        super().__init__(d, metric, metric_arg)
        self.M = int(M)
        self.storage = storage
        self.ef_construction = 40  # faiss::HNSW default
        self.ef_search = 16        # faiss::HNSW default
        self._accel = None         # (IVFIndex, rows_indexed)
        self.accel_mode = "graph"  # "graph" (default) | "ivf"
        self._graph = None         # (adjacency np (indexed, deg) int32, indexed)
        self._graph_dev = None     # ((indexed, cap) key, padded device adj)
        self._pack_dev = None      # ((indexed, cap) key, packed neighbourhoods)
        self._graph_sharded = None  # (cap, graph_dev, nvalid_dev, indexed,
                                    #  pack_kind, packops)
        import threading

        #: serialises the lazy ANN builds (graph / partition); searches
        #: themselves stay lock-free on the immutable built state.  Without
        #: it two concurrent first searches each pay the O(n²) build.
        self._build_lock = threading.Lock()

    def apply_create_params(self, params) -> None:
        # The only create-time knob the reference implements
        # (src/faiss_extension.cpp:133-141).
        ef = params.get_int("efConstruction")
        if ef is not None:
            self.ef_construction = ef
        at = params.get_int("ann_threshold")
        if at is not None:
            self.ann_threshold = at
        mode = params.get_str("accel")
        if mode is not None:
            if mode not in ("graph", "ivf"):
                raise errors.InvalidInputError(
                    f"accel must be 'graph' or 'ivf', got {mode!r}")
            self.accel_mode = mode
        lam = params.get_float("soar_lambda")
        if lam is not None:
            # SOAR in the internal IVF partition: ~2x effective candidate
            # pool per efSearch at 2x partition storage (models/ivf.py).
            if lam < 0.0:
                raise errors.InvalidInputError(
                    f"soar_lambda must be >= 0, got {lam}")
            self.soar_lambda = lam

    # --- regime selection ---------------------------------------------------
    def _ann_supported(self) -> bool:
        return (self.ntotal >= self.ann_threshold
                and self.metric.name in ("L2", "INNER_PRODUCT"))

    def _effective_mode(self) -> str:
        """'graph' | 'graph_sharded' | 'ivf' | 'exact' for the current
        corpus/knobs.  SOAR is an IVF-partition concept; legacy saves
        carrying an IVF partition (and no graph) keep using it rather than
        paying a surprise rebuild.  Under a placement (faiss_to_device) the
        graph regime runs per-shard subgraph walks; the IVF partition is
        single-device-only there, so non-graph cases use the sharded exact
        scan."""
        wants_ivf = (self.accel_mode == "ivf"
                     or getattr(self, "soar_lambda", 0.0) > 0.0
                     or (self._graph is None and self._graph_sharded is None
                         and self._accel is not None))
        if not self._ann_supported():
            return "exact"
        if self._placement is not None:
            return "exact" if wants_ivf else "graph_sharded"
        return "ivf" if wants_ivf else "graph"

    # --- graph (CAGRA-style) acceleration ------------------------------------
    #: share of device memory one packed neighbourhood tensor (bf16) may
    #: take.  Packing makes frontier expansion one contiguous block per
    #: node instead of one scattered row gather per neighbour.
    PACK_MEMORY_FRACTION = 3 / 8

    @property
    def pack_budget_bytes(self) -> int:
        return memory_budget(self.PACK_MEMORY_FRACTION)

    #: a row-split pack can use this many parts (the walk gathers from
    #: each part and lane-selects, so gathers scale with parts — 2 keeps
    #: that overhead at one extra gather while doubling the degree the
    #: budget affords).
    pack_max_parts = 2

    def _graph_degree(self) -> int:
        # HNSW's layer-0 degree is 2M, capped at 128 (uniform-corpus
        # recall@10 keeps climbing through deg 64 — 0.725/0.848 at deg
        # 32/64, pool 64 — so the cap sits above the reference's M=128
        # benchmark config rather than at the old 64).  Halve until the
        # packed neighbourhood fits the HBM budget at its smallest form
        # (int4 nibbles split over pack_max_parts tensors) — a
        # lower-degree packed walk beats a higher-degree scattered one.
        #
        # Scaling rule (measured, uniform corpora — clustered data
        # saturates ≥0.99 from deg 64): recall@10 at pool 128 rises with
        # degree roughly +0.12 per doubling (0.725/0.848 at deg 32/64,
        # 100k×96; 0.852 at deg 128, 400k×96) and falls with n at fixed
        # degree (~−0.1 per 2.5×n).  The budget-driven degree backoff is
        # therefore the recall cliff at large n·d; raising
        # pack_budget_bytes×parts is the knob that moves it.
        from ..utils.config import next_pow2

        deg = min(128, max(16, 2 * self.M))
        cap = max(128, next_pow2(max(1, self.ntotal)))
        budget = self.pack_budget_bytes * self.pack_max_parts
        while deg > 16 and cap * deg * self.d // 2 > budget:
            deg //= 2
        return deg

    def _graph_fresh(self):
        n = self.ntotal
        if self._graph is not None:
            _, indexed = self._graph
            if n - indexed <= self.tail_rebuild_fraction * n:
                return self._graph
        return None

    def _graph_ready(self):
        """(adjacency, indexed) covering a prefix of the corpus, rebuilt when
        the exact-scanned tail outgrows the rebuild fraction."""
        fresh = self._graph_fresh()
        if fresh is not None:
            return fresh
        with self._build_lock:
            fresh = self._graph_fresh()   # another thread may have built
            if fresh is not None:
                return fresh
            from ..ops.graph import build_graph
            from ..utils.config import config
            from ..utils.profiling import timed

            n = self.ntotal
            deg = self._graph_degree()
            # efConstruction scales build effort, like HNSW: a wider
            # intermediate kNN graph before the prune step, and (past the
            # exact-build limit) more NN-descent refinement rounds over the
            # clustered approximate build — 2 at the HNSW default ef=40,
            # +1 per extra 64 (the reference benchmark's efConstruct=128
            # gets 3).
            inter = min(max(2 * deg, self.ef_construction),
                        max(1, n - 1), 192)
            rounds = 2 + max(0, (self.ef_construction - 64) // 64)
            with timed("hnsw_graph_build"):
                adj = build_graph(self._xb, deg, self.metric.name,
                                  self.metric_arg, intermediate=inter,
                                  precision=config.precision,
                                  exact_max=self.graph_max,
                                  refine_rounds=rounds)
            self._graph_dev = None
            self._pack_dev = None
            self._graph = (adj, n)
            return self._graph

    def _graph_device(self, cap: int, gstate):
        """Adjacency padded to the corpus capacity bucket (rows of -1 past
        the indexed prefix), cached like the corpus buffer.  ``gstate`` is
        the (adjacency, indexed) snapshot the caller searched with — reading
        self._graph here could pair a newer graph with an older walk.  The
        fill runs under the build lock (a stampede would allocate the
        multi-GB buffers once per thread)."""
        import jax.numpy as jnp

        adj, indexed = gstate
        key = (indexed, cap)
        hit = self._graph_dev
        if hit is not None and hit[0] == key:
            return hit[1]
        with self._build_lock:
            hit = self._graph_dev
            if hit is not None and hit[0] == key:
                return hit[1]
            host = np.full((cap, adj.shape[1]), -1, np.int32)
            host[:indexed] = adj
            dev = jnp.asarray(host)
            self._graph_dev = (key, dev)
            return dev

    def _graph_pack(self, xb_dev, gdev, gstate):
        """Packed neighbourhood tensor at the widest dtype fitting the HBM
        budget (bf16, else int8 — memory-only tradeoff since the gather is
        descriptor-bound); None falls back to the scattered-gather walk.
        Fill runs under the build lock: a concurrent stampede would
        materialise several near-budget (multi-GB) tensors at once."""
        import jax.numpy as jnp

        _, indexed = gstate
        cap, deg = gdev.shape
        nelem = cap * deg * self.d
        parts = 1
        if nelem * 2 <= self.pack_budget_bytes:
            dtype = jnp.bfloat16
        elif nelem <= self.pack_budget_bytes:
            dtype = jnp.int8
        elif nelem <= 2 * self.pack_budget_bytes:
            dtype = "int4"           # nibble-packed: doubles the degree a
        elif nelem <= 2 * self.pack_max_parts * self.pack_budget_bytes:
            # Row-split int4 pack: past the single-tensor HBM cap, up to
            # pack_max_parts tensors carry the nibbles (one extra gather
            # per extra part — still ~32x ahead of the scattered walk).
            dtype = "int4"
            parts = self.pack_max_parts
        else:                        # fixed budget affords (ops/graph.py)
            return None
        key = (indexed, cap, str(dtype), parts)
        hit = self._pack_dev
        if hit is not None and hit[0] == key:
            return hit[1]
        with self._build_lock:
            hit = self._pack_dev
            if hit is not None and hit[0] == key:
                return hit[1]
            from ..ops.graph import pack_neighbors

            pack = pack_neighbors(xb_dev, gdev, dtype=dtype, parts=parts)
            self._pack_dev = (key, pack)
            return pack

    def _graph_dispatch(self, xq, k, params, selector, gstate):
        """Device dispatch for the graph walk (the search_dispatch tuple
        contract): the walk is one jitted program, so batched serving can
        concatenate many walks and fetch ONCE (api.faiss_search_batched).
        ``gstate`` is the (adjacency, indexed) snapshot from _graph_ready —
        everything below derives from it so a concurrent rebuild cannot
        pair this walk with a different graph's metadata."""
        import jax.numpy as jnp

        from ..ops.flat_search import finalize_scores
        from ..ops.graph import graph_search
        from ..utils.config import config, next_pow2, pad_rows

        adj, indexed = gstate
        xq = np.asarray(xq, np.float32)
        nq = xq.shape[0]
        if nq == 0 or k <= 0 or indexed == 0:
            return None
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_pad = upload_queries(pad_rows(xq, nq_pad))
        xb_dev = self.device_vectors()
        gdev = self._graph_device(xb_dev.shape[0], gstate)
        pack = self._graph_pack(xb_dev, gdev, gstate)
        pool, width, iters = self._walk_knobs(k, params, selector)
        mask = (self._selector_mask(selector)
                if selector is not None else None)
        k_eff = min(k, indexed)
        scores, pos = graph_search(
            xb_dev, gdev, xq_pad, indexed, k_eff,
            self.metric.name, self.metric_arg,
            pool=pool, width=width, iters=iters, mask=mask, pack=pack,
            precision=config.precision)
        dist_dev, pos_dev = finalize_scores(scores, pos, self.metric.name)
        return dist_dev, pos_dev, nq, k_eff

    def _graph_search(self, xq, k, params, selector, gstate) -> SearchResult:
        return self._finish_dispatch(
            self._graph_dispatch(xq, k, params, selector, gstate), xq, k)

    def _walk_knobs(self, k: int, params, selector):
        """(pool, width, iters) shared by the single-device and sharded
        graph searches.  efSearch maps to the pool (CAGRA itopk); a selector
        inflates it (traversal is unfiltered, collection filtered).

        Default width: at one-pool-turnover iterations, wider frontiers
        measure equal-or-better recall with proportionally fewer sequential
        rounds (each round costs a fixed gather latency) — but the
        per-iteration dedup mask is O((width·deg)²), so width scales down
        with the graph degree."""
        from ..utils.config import next_pow2

        pool = next_pow2(max(k, self.ef_search))
        if selector is not None:
            pool = next_pow2(max(4 * k, pool))
        pool = min(max(pool, 16), 1024)
        deg = self._graph_degree()
        width = params.get_int("graph_width", max(4, 512 // max(deg, 1)))
        iters = params.get_int("graph_iters")
        return pool, width, iters

    # --- sharded graph regime ------------------------------------------------
    def _graph_ready_sharded(self):
        """Per-shard subgraphs over the placement mesh: local adjacency per
        contiguous row block of the sharded corpus buffer, stacked row-
        sharded alongside it.  Cache-only (placements are not persisted)."""
        fresh = self._graph_sharded_fresh()
        if fresh is not None:
            return fresh
        with self._build_lock:
            fresh = self._graph_sharded_fresh()
            if fresh is not None:
                return fresh
            return self._build_graph_sharded()

    def _graph_sharded_fresh(self):
        n = self.ntotal
        if self._graph_sharded is not None:
            cap_key, indexed = (self._graph_sharded[0],
                                self._graph_sharded[3])
            cap_now = self.device_vectors().shape[0]
            # Valid while the tail is small and the capacity bucket (and
            # hence the shard row blocks) hasn't moved.
            if (n - indexed <= self.tail_rebuild_fraction * n
                    and cap_key == cap_now):
                return self._graph_sharded
        return None

    def _build_graph_sharded(self):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..ops.graph import build_graph
        from ..utils.config import config

        n = self.ntotal
        sharding = self._placement
        mesh = sharding.mesh
        n_shard = mesh.shape["shard"]
        xb_dev = self.device_vectors()
        cap = xb_dev.shape[0]
        rows = cap // n_shard
        deg = self._graph_degree()
        inter = min(max(2 * deg, self.ef_construction), max(1, n - 1), 192)
        blocks, nvalid = [], []
        for s in range(n_shard):
            lo = min(n, s * rows)
            hi = min(n, lo + rows)
            blk = np.ascontiguousarray(self._xb[lo:hi])
            adj = (build_graph(blk, deg, self.metric.name, self.metric_arg,
                               intermediate=min(inter, max(1, len(blk) - 1)),
                               precision=config.precision,
                               exact_max=self.graph_max)
                   if hi > lo else np.empty((0, deg), np.int32))
            pad = np.full((rows - adj.shape[0], deg), -1, np.int32)
            blocks.append(np.concatenate([adj, pad]) if pad.shape[0]
                          else adj)
            nvalid.append(hi - lo)
        host = np.concatenate(blocks, axis=0)
        gdev = jax.device_put(host, NamedSharding(mesh, P("shard", None)))
        nvdev = jax.device_put(np.asarray(nvalid, np.int32),
                               NamedSharding(mesh, P("shard")))
        # Per-shard packed neighbourhoods (each device packs only its own
        # rows; the HBM budget applies per device).
        from ..parallel.sharded import sharded_pack_fn

        import jax.numpy as jnp

        per_dev = rows * deg * self.d

        def amax():
            # O(n·d) host reduction — only the int8/int4 branches need it.
            return float(np.max(np.abs(self._xb))) if n else 1.0

        if per_dev * 2 <= self.pack_budget_bytes:
            kind = "bf16"
            packops = (sharded_pack_fn(mesh, kind)(xb_dev, gdev),)
        elif per_dev <= self.pack_budget_bytes:
            kind = "int8"
            scale = 127.0 / max(amax(), 1e-30)
            packops = (sharded_pack_fn(mesh, kind)(
                xb_dev, gdev, jnp.float32(scale)),
                jnp.float32(1.0 / scale))
        elif per_dev <= 2 * self.pack_budget_bytes:
            kind = "int4"
            scale = 7.0 / max(amax(), 1e-30)
            packops = (sharded_pack_fn(mesh, kind)(
                xb_dev, gdev, jnp.float32(scale)),
                jnp.float32(1.0 / scale))
        else:
            kind, packops = "none", ()
        self._graph_sharded = (cap, gdev, nvdev, n, kind, packops)
        return self._graph_sharded

    def _sharded_graph_search(self, xq, k, params, gstate) -> SearchResult:
        import jax
        import jax.numpy as jnp

        from ..ops.graph import default_iters
        from ..parallel.sharded import sharded_graph_search_fn
        from ..utils.config import config, next_pow2, pad_rows

        cap_key, gdev, nvdev, indexed, kind, packops = gstate
        xb_dev = self.device_vectors()
        pool, width, iters = self._walk_knobs(k, params, None)
        if iters is None:
            iters = default_iters(max(pool, k), width, gdev.shape[1])
        xq = np.asarray(xq, np.float32)
        nq = xq.shape[0]
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        mesh = self._placement.mesh
        batch = mesh.shape["batch"]
        if nq_pad % batch:
            nq_pad = ((nq_pad + batch - 1) // batch) * batch
        fn = sharded_graph_search_fn(
            mesh, k=min(k, max(1, indexed)), pool=max(pool, k), width=width,
            iters=iters, metric=self.metric.name, pack_kind=kind,
            precision=config.precision)
        from jax.sharding import NamedSharding, PartitionSpec as P

        xq_dev = jax.device_put(pad_rows(xq, nq_pad),
                                NamedSharding(mesh, P("batch", None)))
        dist, pos = fn(xb_dev, gdev, nvdev, xq_dev,
                       jnp.float32(self.metric_arg), *packops)
        dist = np.asarray(dist)[:nq]
        pos = np.asarray(pos)[:nq]
        k_eff = dist.shape[1]
        if k > k_eff:
            dist = np.concatenate(
                [dist, np.full((nq, k - k_eff),
                               _sentinel(self.metric.name), np.float32)],
                axis=1)
            pos = np.concatenate(
                [pos, np.full((nq, k - k_eff), -1, pos.dtype)], axis=1)
        return SearchResult(dist, pos.astype(np.int64))

    # --- IVF acceleration --------------------------------------------------
    def _accel_ready(self):
        """Internal IVF partition covering a prefix of the corpus, or None
        when the exact scan should run (small corpus / unsupported metric)."""
        n = self.ntotal
        if n < self.ann_threshold or \
                self.metric.name not in ("L2", "INNER_PRODUCT") or \
                self._placement is not None:
            # Sharded placement (faiss_to_device) keeps the sharded exact
            # scan — the partition would run single-device.
            return None
        fresh = self._accel_fresh()
        if fresh is not None:
            return fresh
        with self._build_lock:
            fresh = self._accel_fresh()    # built while we waited
            if fresh is not None:
                return fresh
            return self._build_accel()

    def _accel_fresh(self):
        n = self.ntotal
        if self._accel is not None:
            _, indexed = self._accel
            if n - indexed <= self.tail_rebuild_fraction * n:
                return self._accel
        return None

    def _build_accel(self):
        n = self.ntotal
        from .ivf import IVFIndex

        nlist = 1
        while nlist * nlist < n:
            nlist *= 2
        nlist = min(nlist, 65_536)
        quant = FlatIndex(self.d, self.metric, self.metric_arg)
        accel = IVFIndex(self.d, self.metric, self.metric_arg,
                         nlist=nlist, quantizer=quant)
        # efConstruction scales build effort in HNSW; here it maps to
        # k-means iterations (more effort → better partition).
        accel.train_niter = max(4, min(25, self.ef_construction // 8))
        lam = getattr(self, "soar_lambda", 0.0)
        if lam > 0.0:
            accel.soar_lambda = lam
        accel.train(self._xb)
        accel.add(self._xb)   # ids = positions 0..n-1
        self._accel = (accel, n)
        return self._accel

    def add(self, x) -> None:
        super().add(x)
        # The partition/graph goes stale but stays valid for its prefix; new
        # rows are tail-scanned exactly until the rebuild threshold.

    def set_placement(self, sharding) -> None:
        super().set_placement(sharding)
        # Re-placement changes the shard row blocks: the per-shard
        # subgraphs (local indices) no longer align.  The single-device
        # walk caches (padded adjacency + up to 6 GB of packed blocks) are
        # unreachable in the sharded regime — free them or they pin HBM on
        # the original device for the index's lifetime.  The host adjacency
        # (_graph) stays: it is cheap, persisted, and reused if the
        # placement is ever dropped.
        self._graph_sharded = None
        self._graph_dev = None
        self._pack_dev = None

    def _exact_search(self, xq, k, params, selector) -> SearchResult:
        # Exact fallback that bypasses this class's polymorphic
        # search_async/search_dispatch overrides (FlatIndex.search delegates
        # through them; re-entering would recurse — or return the override's
        # None dispatch — when the fallback fires in a non-exact regime,
        # e.g. selector under graph_sharded).
        disp = FlatIndex.search_dispatch(self, xq, k, params, selector)
        return self._finish_dispatch(disp, xq, k)

    def _latch(self, params) -> None:
        # efSearch accepted per the reference (src/faiss_extension.cpp:
        # 691-702); at scale it maps to the candidate-pool size.
        ef = params.get_int("efSearch")
        if ef is not None:
            self.ef_search = ef

    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        self._latch(params)
        if (params.get_str("exact") or "").lower() in ("true", "1"):
            return self._exact_search(xq, k, params, selector)
        mode = self._effective_mode()
        if mode == "graph_sharded":
            if selector is not None:
                # Filtered sharded search: the exact sharded scan fuses the
                # mask (flat path) — correct and fast, no pool inflation.
                return self._exact_search(xq, k, params, selector)
            gstate = self._graph_ready_sharded()
            res = self._sharded_graph_search(xq, k, params, gstate)
            indexed = gstate[3]
        elif mode == "graph":
            gstate = self._graph_ready()
            res = self._graph_search(xq, k, params, selector, gstate)
            indexed = gstate[1]
        else:
            accel_state = self._accel_ready()
            if accel_state is None:
                return self._exact_search(xq, k, params, selector)
            accel, indexed = accel_state
            nprobe = params.get_int("nprobe",
                                    max(1, round(self.ef_search / 4)))
            res = accel.search(xq, k, _with_nprobe(params, nprobe), selector)
        n = self.ntotal
        if indexed == n:
            return res
        # Tail rows added after the partition build: exact scan + merge.
        tail = self._tail_search(xq, k, indexed, selector)
        return _merge_results(res, tail, k,
                              self.metric.name in _SIMILARITY)

    def _tail_search(self, xq, k, start: int, selector) -> SearchResult:
        # Cache the tail index between adds — rebuilding re-uploads the
        # whole tail every search otherwise (up to 20% of the corpus).
        cache = getattr(self, "_tail_cache", None)
        key = (start, self.ntotal)
        if cache is None or cache[0] != key:
            tail = FlatIndex(self.d, self.metric, self.metric_arg)
            tail.add(self._xb[start:])
            self._tail_cache = cache = (key, tail)
        tail = cache[1]
        sel = (_ShiftedSelector(selector, start)
               if selector is not None else None)
        res = tail.search(np.asarray(xq, np.float32), k, EMPTY, sel)
        labels = np.where(res.labels >= 0, res.labels + start, -1)
        return SearchResult(res.distances, labels)

    # --- serving-tier dispatch --------------------------------------------
    def _exact_requested(self, params) -> bool:
        if params is None:
            return False
        return (params.get_str("exact") or "").lower() in ("true", "1")

    def search_dispatch(self, xq, k, params=None, selector=None):
        """Raw dispatch: exact regime delegates to the flat dispatch; the
        graph regime dispatches the jitted walk (single-fetch batched
        serving) when no exact-scanned tail exists.  Other ANN regimes
        return None — the batched tier would otherwise silently run the
        full exact scan (10-20× slower at scale and ignoring efSearch)."""
        p = params if params is not None else EMPTY
        self._latch(p)
        if self._exact_requested(p) or self._effective_mode() == "exact":
            return super().search_dispatch(xq, k, p, selector)
        if self._effective_mode() == "graph":
            gstate = self._graph_ready()
            if gstate[1] == self.ntotal:  # no tail to host-merge
                return self._graph_dispatch(xq, k, p, selector, gstate)
        return None

    def search_async(self, xq, k, params=None, selector=None):
        p = params if params is not None else EMPTY
        self._latch(p)
        if self._exact_requested(p) or self._effective_mode() == "exact":
            return super().search_async(xq, k, p, selector)
        if self._effective_mode() == "graph":
            gstate = self._graph_ready()
            if gstate[1] == self.ntotal:
                disp = self._graph_dispatch(xq, k, p, selector, gstate)
                return lambda: self._finish_dispatch(disp, xq, k)
        res = self.search(xq, k, p, selector)
        return lambda: res

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["hnsw_meta"] = np.array(
            [self.M, self.ef_construction, self.ef_search,
             self.ann_threshold, 1 if self.accel_mode == "ivf" else 0])
        if self._graph is not None:
            # Persist the neighbour graph — the direct analogue of FAISS
            # serializing the HNSW adjacency: deterministic built state
            # whose rebuild costs an O(n²) scan.
            adj, indexed = self._graph
            state["graph_adj"] = adj
            state["graph_meta"] = np.array([indexed])
        if getattr(self, "soar_lambda", 0.0) > 0.0:
            state["hnsw_soar"] = np.float32(self.soar_lambda)
        if self._accel is not None:
            # Persist the partition (the analogue of FAISS serializing the
            # HNSW graph): k-means + full-corpus assignment cost minutes at
            # scale and are deterministic state, not caches.
            accel, indexed = self._accel
            state["accel_centroids"] = accel._centroids
            state["accel_assign"] = accel._assign
            state["accel_meta"] = np.array([accel.nlist, indexed])
        return state

    def load_state(self, state: dict) -> None:
        meta = state.pop("hnsw_meta", None)
        if meta is not None:
            m = [int(v) for v in meta]
            self.M, self.ef_construction, self.ef_search = m[:3]
            if len(m) > 3:
                # Persisted since SOAR landed; older saves keep the class
                # default (the regime choice would otherwise flip on load).
                self.ann_threshold = m[3]
            if len(m) > 4:
                self.accel_mode = "ivf" if m[4] else "graph"
        gadj = state.pop("graph_adj", None)
        gmeta = state.pop("graph_meta", None)
        self._graph = None
        self._graph_dev = None
        self._pack_dev = None
        self._graph_sharded = None
        if gadj is not None and gmeta is not None:
            self._graph = (np.asarray(gadj, np.int32), int(gmeta[0]))
        lam = state.pop("hnsw_soar", None)
        if lam is not None:
            self.soar_lambda = float(lam)
        cents = state.pop("accel_centroids", None)
        assign = state.pop("accel_assign", None)
        ameta = state.pop("accel_meta", None)
        self._accel = None
        self._tail_cache = None
        super().load_state(state)
        if cents is not None and ameta is not None:
            from .ivf import IVFIndex

            nlist, indexed = int(ameta[0]), int(ameta[1])
            quant = FlatIndex(self.d, self.metric, self.metric_arg)
            accel = IVFIndex(self.d, self.metric, self.metric_arg,
                             nlist=nlist, quantizer=quant)
            accel._centroids = np.asarray(cents, np.float32)
            quant.add(accel._centroids)
            xb_prefix = np.ascontiguousarray(self._xb[:indexed])
            ids_prefix = np.arange(indexed, dtype=np.int64)
            lam = getattr(self, "soar_lambda", 0.0)
            if lam > 0.0:
                # SOAR partition stores every row twice (two lists); the
                # persisted assignment array is 2×indexed long.
                accel.soar_lambda = lam
                accel._xb = np.concatenate([xb_prefix, xb_prefix])
                accel._ids = np.concatenate([ids_prefix, ids_prefix])
            else:
                accel._xb = xb_prefix
                accel._ids = ids_prefix
            accel._assign = np.asarray(assign, np.int32).reshape(-1)
            self._accel = (accel, indexed)
from ..utils.transfer import upload_queries


from ..ops.flat_search import SIMILARITY_METRICS as _SIMILARITY  # noqa: E402


def _sentinel(metric_name: str) -> float:
    return float("-inf") if metric_name in _SIMILARITY else float("inf")


def _with_nprobe(params, nprobe: int):
    from ..params import ParamMap

    merged = dict(params)
    merged["nprobe"] = str(nprobe)
    return ParamMap(merged)


def _merge_results(a: SearchResult, b: SearchResult, k: int,
                   sim: bool) -> SearchResult:
    dist = np.concatenate([a.distances, b.distances], axis=1)
    labels = np.concatenate([a.labels, b.labels], axis=1)
    # Missing slots carry ±inf sentinels that sort last either way.
    order = np.argsort(-dist if sim else dist, axis=1, kind="stable")[:, :k]
    return SearchResult(np.take_along_axis(dist, order, axis=1),
                        np.take_along_axis(labels, order, axis=1))


class _ShiftedSelector:
    """Selector over tail positions: position p in the tail index is
    corpus position p + start."""

    def __init__(self, inner, start: int):
        self._inner = inner
        self._start = int(start)

    def contains(self, labels: np.ndarray) -> np.ndarray:
        return self._inner.contains(np.asarray(labels) + self._start)

    def cache_key(self):
        return ("shift", self._start, self._inner.cache_key())


class NSGIndex(HNSWIndex):
    """faiss::IndexNSG surface (``NSG[R]`` factory strings, e.g. ``NSG32`` /
    ``NSG64,SQ8``).  NSG is a monotonic-graph ANN — pointer-chasing like
    HNSW and equally device-hostile — so it lowers to the same exact-scan /
    internal-IVF-partition execution as HNSWIndex (documented deviation,
    SURVEY.md §7 step 8).  Knob mapping: the graph degree R plays M's role
    at build time; the search pool ``search_L`` (faiss IndexNSG default 16)
    maps to the candidate-pool size exactly like efSearch."""

    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 M: int = 32, storage: str = "Flat"):
        super().__init__(d, metric, metric_arg, M=M, storage=storage)
        self.ef_search = 16  # faiss::IndexNSG::search_L default

    def _latch(self, params) -> None:
        super()._latch(params)
        L = params.get_int("search_L")
        if L is not None:
            self.ef_search = L

    def apply_create_params(self, params) -> None:
        super().apply_create_params(params)
        R = params.get_int("R")
        if R is not None:
            self.M = R
