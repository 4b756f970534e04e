"""Sharded search and training over a device mesh.

The reference's scaling story is OpenMP threads + BLAS on one node
(SURVEY.md §2.3); the rebuild scales by partitioning the corpus across
devices and merging per-shard top-k results with XLA collectives over
ICI/DCN:

* mesh axes: ``shard`` partitions corpus rows; ``batch`` partitions the
  query batch.  Every device scans its corpus shard for its query sub-batch.
* per-shard scan = the same fused distance+top-k kernel as single-chip
  (ops/flat_search.search_scan) with a global row offset;
* merge = all_gather of (k per shard) candidates over ``shard`` + one more
  top-k — k·S values per query cross the interconnect instead of the corpus.

Training (k-means) shards the assignment over data and reduces the centroid
update with psum over both axes — the distributed Lloyd's step of
SURVEY.md §2.2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.flat_search import (SIMILARITY_METRICS, choose_chunk,
                               finalize_scores, search_scan)
from ..ops.kmeans import assign_labels, centroid_update


def _merge_shard_topk(scores, pos, k: int, metric: str):
    """Merge per-shard (nq_local, k) max-oriented candidates into the global
    top-k: all_gather over 'shard' + ONE top-k — k·S scalars per query cross
    the interconnect, never vectors.  Shared by the flat, IVF, and graph
    sharded searches; returns finalize_scores output conventions."""
    all_scores = lax.all_gather(scores, "shard")     # (S, nq_l, k)
    all_pos = lax.all_gather(pos, "shard")
    s, nq_l, kk = all_scores.shape
    cat_s = jnp.transpose(all_scores, (1, 0, 2)).reshape(nq_l, s * kk)
    cat_p = jnp.transpose(all_pos, (1, 0, 2)).reshape(nq_l, s * kk)
    merged_s, sel = lax.top_k(cat_s, k)
    merged_p = jnp.take_along_axis(cat_p, sel, axis=1)
    return finalize_scores(merged_s, merged_p, metric)


def balanced_list_partition(counts, nshards: int):
    """Skew-aware IVF list placement: greedy LPT bin-pack of ``nlist``
    lists into ``nshards`` EQUAL-CARDINALITY groups (nlist/nshards lists
    each — the sharded layout's static shapes require it), balancing
    per-shard Σcounts.

    Hot lists are probed by many queries, so a contiguous block
    partition concentrates scan work on whichever shard owns the hot
    block (SURVEY §2.3 data-partitioning row; marco-skew max list 7488
    vs lmax 2048).  LPT (longest-processing-time first: sort lists by
    count descending, assign each to the least-loaded shard with slot
    capacity left) is the classic 4/3-approximation to makespan and is
    exact enough here — measured spread on the marco-skew distribution
    drops from ~2x (contiguous) to <1.05x.

    Returns ``perm`` int32 (nlist,): OLD list ids in their new order —
    shard s owns old lists ``perm[s*npl:(s+1)*npl]``.  Apply it to
    payload/counts/row_pos/centroid rows, shard contiguously, and the
    existing ``sharded_ivf_search_fn`` needs no change (probe ids come
    from the permuted centroids, so they live in permuted space too)."""
    import numpy as np

    counts = np.asarray(counts, np.int64)
    nlist = counts.shape[0]
    if nlist % nshards:
        raise ValueError(f"nlist {nlist} not divisible by {nshards} shards")
    npl = nlist // nshards
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(nshards, np.int64)
    slots = np.full(nshards, npl, np.int64)
    groups = [[] for _ in range(nshards)]
    for li in order:
        open_shards = np.flatnonzero(slots > 0)
        s = open_shards[np.argmin(load[open_shards])]
        groups[s].append(li)
        load[s] += counts[li]
        slots[s] -= 1
    return np.concatenate([np.asarray(g, np.int32) for g in groups])


def make_mesh(n_devices: int | None = None, batch_axis: int = 1,
              devices=None) -> Mesh:
    """2-D mesh (shard × batch) over the first n_devices local devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % batch_axis != 0:
        raise ValueError(f"{n} devices not divisible by batch_axis={batch_axis}")
    import numpy as np

    dev_array = np.array(devices).reshape(n // batch_axis, batch_axis)
    return Mesh(dev_array, ("shard", "batch"))


def sharded_flat_search_fn(mesh: Mesh, *, k: int, metric: str, chunk: int,
                           precision=lax.Precision.DEFAULT, has_mask=False):
    """Build the jitted sharded search step for a given mesh/config.

    Signature of the returned fn:
        (xb (cap, d) sharded P('shard', None),
         nvalid scalar,
         xq (nq, d) sharded P('batch', None),
         mask (cap,) sharded P('shard') or None,
         metric_arg scalar)
        → (distances (nq, k), positions (nq, k)) sharded P('batch', None)
    """
    mask_spec = (P("shard"),) if has_mask else ()

    def local(xb, nvalid, xq, *rest):
        if has_mask:
            mask, metric_arg = rest
        else:
            (metric_arg,) = rest
            mask = None
        shard_idx = lax.axis_index("shard")
        cap_local = xb.shape[0]
        offset = (shard_idx * cap_local).astype(jnp.int32)
        qb = min(xq.shape[0], 256)
        if xq.shape[0] % qb:
            qb = xq.shape[0]
        scores, pos = search_scan(
            xb, nvalid, xq, mask, metric_arg, offset,
            k=k, metric=metric, q_block=qb, c_block=chunk,
            precision=precision)
        return _merge_shard_topk(scores, pos, k, metric)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("shard", None), P(), P("batch", None)) + mask_spec + (P(),),
        out_specs=(P("batch", None), P("batch", None)),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def sharded_graph_search_fn(mesh: Mesh, *, k: int, pool: int, width: int,
                            iters: int, metric: str, pack_kind: str = "none",
                            precision=lax.Precision.DEFAULT):
    """Sharded CAGRA-style walk: corpus rows P('shard', None), per-shard
    adjacency in LOCAL row indices P('shard', None), per-shard valid-row
    counts P('shard'), queries P('batch', None).  Each device walks its own
    subgraph (ops/graph.walk_scan) and contributes k candidates per query;
    the merge is the same all_gather + one top-k as the sharded flat scan —
    k·S values per query over the interconnect, never vectors.

    Per-shard subgraphs (vs one global graph) keep every expansion gather
    device-local: a global graph's edges cross shards, which under GSPMD
    would all-gather corpus rows.  The union of per-shard walks is at least
    as complete as a single-graph walk of the same pool.

    pack_kind 'bf16'/'int8' appends packed-neighbourhood operand(s)
    (sharded_pack_fn) so expansion gathers stay block-contiguous — the
    scattered gather is descriptor-bound (ops/graph.pack_neighbors)."""
    from ..ops.graph import walk_scan

    def local(xb, graph, nvalid_loc, xq, metric_arg, *packops):
        if pack_kind == "bf16":
            pack = packops[0]
        elif pack_kind in ("int8", "int4"):
            # int4 packs are uint8 nibble arrays; the walk branches on the
            # dtype (ops/graph.walk_scan).
            pack = (packops[0], packops[1])
        else:
            pack = None
        shard_idx = lax.axis_index("shard")
        cap_local = xb.shape[0]
        offset = (shard_idx * cap_local).astype(jnp.int32)
        scores, pos = walk_scan(
            xb, graph, xq, nvalid_loc[0], metric_arg, None, pack,
            k=k, pool=pool, width=width, iters=iters, metric=metric,
            precision=precision)
        pos = jnp.where(pos >= 0, pos + offset, -1)
        return _merge_shard_topk(scores, pos, k, metric)

    pack_specs = {"none": (), "bf16": (P("shard", None),),
                  "int8": (P("shard", None), P()),
                  "int4": (P("shard", None), P())}[pack_kind]
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("shard", None), P("shard", None), P("shard"),
                  P("batch", None), P()) + pack_specs,
        out_specs=(P("batch", None), P("batch", None)),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def sharded_pack_fn(mesh: Mesh, kind: str):
    """Build the per-shard packed neighbourhood tensor (P('shard', None))
    from the sharded corpus + local adjacency — each device packs only
    its own rows.  2-D (rows, deg*w) like ops/graph.pack_neighbors (the
    lane-aligned layout).  'int8'/'int4' also take a replicated
    quantization scale."""

    def fold(codes, g):
        # Chunked like ops/graph._pack_build: an unchunked flat gather
        # materialises a (rows_local*deg, w) intermediate whose minor dim
        # is lane-padded (2x for int4 widths < 128) — multi-GB transient
        # at large per-shard corpora.  lax.map keeps the
        # per-block gather <= ~32M elements.
        n, deg = g.shape
        w = codes.shape[1]
        chunk = min(n, max(256, (1 << 25) // max(deg * w, 1)))
        nb = -(-n // chunk)
        pad = nb * chunk - n
        gp = jnp.pad(g, ((0, pad), (0, 0))) if pad else g

        def one(gb):
            rows = jnp.take(codes, jnp.maximum(gb, 0).reshape(-1), axis=0)
            return rows.reshape(gb.shape[0], deg * w)

        out = lax.map(one, gp.reshape(nb, chunk, deg))
        out = out.reshape(nb * chunk, deg * w)
        return out[:n] if pad else out

    if kind == "bf16":
        def local(xb, g):
            return fold(xb.astype(jnp.bfloat16), g)
        in_specs = (P("shard", None), P("shard", None))
    elif kind == "int4":
        def local(xb, g, scale):
            q = (jnp.clip(jnp.round(xb * scale), -7, 7)
                 .astype(jnp.int32) + 8).astype(jnp.uint8)
            if q.shape[1] % 2:
                # bias-value pad: the nibble decodes to 0 (see ops/graph.py)
                q = jnp.pad(q, ((0, 0), (0, 1)), constant_values=8)
            packed = q[:, 0::2] | (q[:, 1::2] << 4)
            return fold(packed, g)
        in_specs = (P("shard", None), P("shard", None), P())
    else:
        def local(xb, g, scale):
            q = jnp.clip(jnp.round(xb * scale), -127, 127).astype(jnp.int8)
            return fold(q, g)
        in_specs = (P("shard", None), P("shard", None), P())
    fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                   out_specs=P("shard", None), check_vma=False)
    return jax.jit(fn)


def sharded_kmeans_step_fn(mesh: Mesh, *, k: int,
                           precision=lax.Precision.DEFAULT,
                           spherical: bool = False):
    """One distributed Lloyd iteration: data sharded over (shard, batch),
    centroids replicated; updates reduced with psum over both axes.
    ``spherical`` renormalises centroids per step (IP-metric training,
    same rule as ops/kmeans.py)."""

    def local(x, valid, centroids):
        labels = assign_labels(x, centroids, precision)
        w = valid.astype(x.dtype)
        sums, counts = centroid_update(x, labels, k, weights=w)
        sums = lax.psum(sums, ("shard", "batch"))
        counts = lax.psum(counts, ("shard", "batch"))
        new = sums / jnp.maximum(counts, 1.0)[:, None]
        if spherical:
            new = new / jnp.maximum(
                jnp.linalg.norm(new, axis=1, keepdims=True), 1e-20)
        return jnp.where((counts > 0)[:, None], new, centroids)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(("shard", "batch"), None), P(("shard", "batch")),
                  P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    return jax.jit(fn)


def multichip_dryrun(n_devices: int) -> None:
    """Compile + run one sharded search step and one sharded k-means training
    step on tiny shapes over an n_devices mesh (driver validation hook)."""
    import numpy as np

    batch_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, batch_axis=batch_axis)
    n_shard = n_devices // batch_axis

    d, k = 32, 4
    cap = 64 * n_shard
    nq = 8 * batch_axis
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((cap, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)

    xb_s = jax.device_put(xb, NamedSharding(mesh, P("shard", None)))
    xq_s = jax.device_put(xq, NamedSharding(mesh, P("batch", None)))

    search = sharded_flat_search_fn(
        mesh, k=k, metric="L2", chunk=choose_chunk(cap // n_shard, nq, d, "L2"))
    dist, pos = search(xb_s, jnp.int32(cap - 3), xq_s, jnp.float32(0.0))
    jax.block_until_ready((dist, pos))
    assert dist.shape == (nq, k) and pos.shape == (nq, k)
    # Cross-check against a local brute-force oracle.
    ref = np.sum((xq[:, None, :] - xb[None, : cap - 3, :]) ** 2, axis=-1)
    ref_best = np.sort(ref, axis=1)[:, :k]
    np.testing.assert_allclose(np.asarray(dist), ref_best, rtol=1e-3,
                               atol=1e-3)

    nclusters = 8
    cents = jnp.asarray(rng.standard_normal((nclusters, d)).astype(np.float32))
    step = sharded_kmeans_step_fn(mesh, k=nclusters)
    valid = jax.device_put(np.ones((cap,), bool),
                           NamedSharding(mesh, P(("shard", "batch"))))
    x_flat = jax.device_put(xb, NamedSharding(mesh, P(("shard", "batch"),
                                                      None)))
    new_cents = step(x_flat, valid, cents)
    jax.block_until_ready(new_cents)
    assert new_cents.shape == (nclusters, d)

    # Sharded IVF: lists partitioned over the shard axis (one padded list
    # per shard here), queries over batch — the full ep/list-parallel path.
    nlist = 4 * n_shard
    lmax = 128
    counts = np.full((nlist,), 16, np.int32)
    xb_lists = rng.standard_normal((nlist, lmax, d)).astype(np.float32)
    row_pos = np.arange(nlist * lmax, dtype=np.int32).reshape(nlist, lmax)
    cents = jnp.asarray(rng.standard_normal((nlist, d)).astype(np.float32))
    ivf = sharded_ivf_search_fn(mesh, k=k, nprobe=2, metric="L2", q_chunk=4)
    di, pi = ivf(
        jax.device_put(xb_lists, NamedSharding(mesh, P("shard", None, None))),
        jax.device_put(counts, NamedSharding(mesh, P("shard"))),
        jax.device_put(row_pos, NamedSharding(mesh, P("shard", None))),
        cents, xq_s, jnp.float32(0.0))
    jax.block_until_ready((di, pi))
    assert di.shape == (nq, k)

    # Sharded IVFPQ + selector mask: byte-code lists reconstructed
    # on-device, per-(list, slot) mask fused into validity.
    m, ksub, dsub = 4, 16, d // 4
    codes = rng.integers(0, ksub, (nlist, lmax, m)).astype(np.uint8)
    codebooks = rng.standard_normal((m, ksub, dsub)).astype(np.float32)
    sel_mask = (row_pos % 2 == 0).astype(np.int8)
    ivfpq = sharded_ivf_search_fn(mesh, k=k, nprobe=2, metric="L2",
                                  q_chunk=4, pq=True, has_mask=True)
    dq, pq_ = ivfpq(
        jax.device_put(codes, NamedSharding(mesh, P("shard", None, None))),
        jax.device_put(counts, NamedSharding(mesh, P("shard"))),
        jax.device_put(row_pos, NamedSharding(mesh, P("shard", None))),
        cents, xq_s, jnp.float32(0.0), jnp.asarray(codebooks),
        jax.device_put(sel_mask, NamedSharding(mesh, P("shard", None))))
    jax.block_until_ready((dq, pq_))
    assert dq.shape == (nq, k)

    # Sharded graph walk (HNSW/NSG graph regime under a placement):
    # per-shard CAGRA subgraphs in local indices, all_gather top-k merge.
    from ..ops.graph import build_graph

    rows = cap // n_shard
    gdeg = 8
    gblocks = []
    for s in range(n_shard):
        adj = build_graph(xb[s * rows:(s + 1) * rows], gdeg, "L2")
        gblocks.append(adj)
    gdev = jax.device_put(np.concatenate(gblocks, axis=0),
                          NamedSharding(mesh, P("shard", None)))
    nvdev = jax.device_put(np.full((n_shard,), rows, np.int32),
                           NamedSharding(mesh, P("shard")))
    walk = sharded_graph_search_fn(mesh, k=k, pool=16, width=4, iters=6,
                                   metric="L2")
    dg, pg = walk(xb_s, gdev, nvdev, xq_s, jnp.float32(0.0))
    jax.block_until_ready((dg, pg))
    assert dg.shape == (nq, k) and pg.shape == (nq, k)
    assert np.asarray(pg).max() < cap

    # Sharded IVF,SQ8: scalar-quantized byte lists decoded in-shard with
    # the replicated (vmin, scale) ranges (IndexIVFScalarQuantizer under a
    # placement).  Oracle: numpy probe + decode + brute-force over the same
    # probed lists.
    from ..ops.sq import sq8_decode, sq8_encode, sq8_train

    vmin8, scale8 = sq8_train(jnp.asarray(xb_lists.reshape(-1, d)))
    codes8 = np.asarray(
        sq8_encode(jnp.asarray(xb_lists.reshape(-1, d)), vmin8, scale8),
    ).reshape(nlist, lmax, d)
    ivfsq = sharded_ivf_search_fn(mesh, k=k, nprobe=2, metric="L2",
                                  q_chunk=4, sq="sq8")
    dsq, psq = ivfsq(
        jax.device_put(codes8, NamedSharding(mesh, P("shard", None, None))),
        jax.device_put(counts, NamedSharding(mesh, P("shard"))),
        jax.device_put(row_pos, NamedSharding(mesh, P("shard", None))),
        cents, xq_s, jnp.float32(0.0), vmin8, scale8)
    jax.block_until_ready((dsq, psq))
    assert dsq.shape == (nq, k)
    xdec = np.asarray(sq8_decode(jnp.asarray(codes8.reshape(-1, d)),
                                 vmin8, scale8)).reshape(nlist, lmax, d)
    cd = ((xq[:, None, :] - np.asarray(cents)[None]) ** 2).sum(-1)
    probe_o = np.argsort(cd, axis=1, kind="stable")[:, :2]
    for q in range(nq):
        cand = xdec[probe_o[q], :16, :].reshape(-1, d)     # counts are 16
        dd = np.sort(((cand - xq[q]) ** 2).sum(-1))[:k]
        np.testing.assert_allclose(np.asarray(dsq[q]), dd, rtol=1e-3,
                                   atol=1e-3)

    # Row-sharded codec placement (faiss_to_device on standalone PQ):
    # GSPMD partitions the fused decode+scan over the placed byte codes.
    from ..ops.pq import pq_search, pq_train

    pq_codes = rng.integers(0, ksub, (cap, m)).astype(np.uint8)
    cbs = jnp.asarray(rng.standard_normal((m, ksub, dsub)).astype(np.float32))
    codes_s = jax.device_put(pq_codes, NamedSharding(mesh, P("shard", None)))
    ds, ps = pq_search(codes_s, jnp.int32(cap - 3), cbs, xq_s, None,
                       jnp.float32(0.0), k=k, metric="L2",
                       chunk=cap // n_shard,
                       precision=lax.Precision.DEFAULT)
    jax.block_until_ready((ds, ps))
    assert ds.shape == (nq, k)

    # Row-sharded standalone SQ placement (faiss_to_device on a SQ8 index):
    # GSPMD partitions the decode+scan over the placed packed codes.
    from ..ops.sq import sq_search

    flat_codes8 = np.asarray(
        sq8_encode(jnp.asarray(xb), vmin8, scale8))        # (cap, d) uint8
    fc_s = jax.device_put(flat_codes8, NamedSharding(mesh, P("shard", None)))
    dss, pss = sq_search(fc_s, jnp.int32(cap - 3), vmin8, scale8, xq_s,
                         None, jnp.float32(0.0), k=k, metric="L2",
                         chunk=cap // n_shard,
                         precision=lax.Precision.DEFAULT, codec="sq8")
    jax.block_until_ready((dss, pss))
    assert dss.shape == (nq, k)
    xdec_f = np.asarray(sq8_decode(jnp.asarray(flat_codes8), vmin8, scale8))
    ref_sq = np.sort(((xq[:, None, :] - xdec_f[None, : cap - 3, :]) ** 2)
                     .sum(-1), axis=1)[:, :k]
    # sq_search returns max-oriented scores (the model finalizes): -L2.
    np.testing.assert_allclose(-np.asarray(dss), ref_sq, rtol=1e-3, atol=1e-3)

    # Skew-aware IVF list placement: a deliberately marco-skewed layout
    # (all hot lists packed FIRST — a contiguous block partition parks
    # them all on shard 0), permuted by balanced_list_partition at
    # placement time exactly like models/ivf_sharded._ivf_build_sharded
    # (centroids permuted identically), oracle-checked against exact
    # brute force over each query's probed lists.
    if n_shard > 1:
        counts_sk = np.full((nlist,), 4, np.int32)
        counts_sk[: nlist // n_shard] = lmax          # hot block up front
        perm_sk = balanced_list_partition(counts_sk, n_shard)
        npl = nlist // n_shard
        loads = np.asarray([counts_sk[perm_sk[s * npl:(s + 1) * npl]].sum()
                            for s in range(n_shard)], np.float64)
        contig = np.asarray([counts_sk[s * npl:(s + 1) * npl].sum()
                             for s in range(n_shard)], np.float64)
        assert loads.max() / loads.mean() < 1.3, loads
        assert loads.max() < contig.max(), (loads, contig)
        dsk, psk = ivf(
            jax.device_put(xb_lists[perm_sk],
                           NamedSharding(mesh, P("shard", None, None))),
            jax.device_put(counts_sk[perm_sk],
                           NamedSharding(mesh, P("shard"))),
            jax.device_put(row_pos[perm_sk],
                           NamedSharding(mesh, P("shard", None))),
            jnp.asarray(np.asarray(cents)[perm_sk]), xq_s,
            jnp.float32(0.0))
        jax.block_until_ready((dsk, psk))
        cd_sk = ((xq[:, None, :] - np.asarray(cents)[None]) ** 2).sum(-1)
        probe_sk = np.argsort(cd_sk, axis=1, kind="stable")[:, :2]
        for q in range(nq):
            cand_d = []
            for li in probe_sk[q]:
                rows = xb_lists[li, : counts_sk[li]]
                cand_d.append(((rows - xq[q]) ** 2).sum(-1))
            dd = np.sort(np.concatenate(cand_d))[:k]
            np.testing.assert_allclose(np.asarray(dsk[q]), dd,
                                       rtol=1e-3, atol=1e-3)


def sharded_ivf_search_fn(mesh: Mesh, *, k: int, nprobe: int, metric: str,
                          q_chunk: int = 8,
                          precision=lax.Precision.DEFAULT,
                          pq: bool = False, pq_codec: str = "pq",
                          sq: str | None = None,
                          has_mask: bool = False):
    """Sharded IVF search: inverted lists partitioned over ``shard`` (padded
    (nlist, lmax, w) layout, nlist divisible by the shard count), queries
    sharded over ``batch``, centroids replicated.

    Each device computes the coarse top-nprobe (replicated — one small matmul
    tile), scans only the probed lists it owns, and the per-shard top-k
    candidates are merged with an all_gather over ICI exactly like the flat
    path.  Exact: every probed list is scanned by exactly one shard.

    Returned fn signature:
        (payload P('shard',None,None) — fp32 rows (Flat) or uint8 codes (PQ),
         counts P('shard'), row_pos P('shard',None), centroids replicated,
         xq P('batch',None), metric_arg,
         [codebooks replicated if pq], [mask P('shard',None) if has_mask])
        → (distances, positions) P('batch', None)

    ``pq=True``: payload holds residual PQ byte codes; candidates are
    reconstructed as centroid[list] + decode(code) on-device (the IVFPQ
    by_residual path).  ``sq=<codec>``: payload holds scalar-quantized codes
    (sq8/sq4/sq6 packed bytes, or fp16/bf16 rows), decoded in-shard with the
    replicated (vmin, scale) ranges before scoring (IndexIVFScalarQuantizer).
    ``has_mask=True``: a per-(list, slot) selector mask sharded alongside the
    lists is fused into validity (filtered search on a device-sharded index).
    """
    sim = metric in SIMILARITY_METRICS
    nshards = int(mesh.shape["shard"])
    extra_specs = ()
    if pq:
        extra_specs += (P(None, None, None),)
    if sq:
        extra_specs += (P(None), P(None))   # vmin, scale (replicated)
    if has_mask:
        extra_specs += (P("shard", None),)

    def local(payload, counts, row_pos, centroids, xq, metric_arg, *rest):
        import jax.numpy as jnp  # noqa: PLC0415

        from ..ops.distance import pairwise_tile
        from ..ops.flat_search import _NEG_INF, finalize_scores

        rest = list(rest)
        codebooks = rest.pop(0) if pq else None
        sq_vmin, sq_scale = (rest.pop(0), rest.pop(0)) if sq else (None, None)
        sel_mask = rest.pop(0) if has_mask else None
        nlist_l, lmax = payload.shape[:2]
        d = centroids.shape[1]
        nq = xq.shape[0]
        npb = min(nprobe, nlist_l * nshards)

        # Coarse assignment on the replicated centroid table.
        cdist = pairwise_tile(xq, centroids, metric, metric_arg, precision)
        cscore = cdist if sim else -cdist
        _, probe = lax.top_k(cscore, npb)                  # global list ids

        base = lax.axis_index("shard") * nlist_l
        lp = probe - base
        owned = jnp.logical_and(lp >= 0, lp < nlist_l)
        lp = jnp.where(owned, lp, 0)

        qc = min(q_chunk, nq)
        ncand = npb * lmax
        rerank_ip = (metric == "INNER_PRODUCT"
                     and precision != lax.Precision.HIGHEST)
        k_scan = min(ncand, max(2 * k, k + 16)) if rerank_ip else k

        def chunk(i, carry):
            bs, bp = carry
            q0 = i * qc
            xq_c = lax.dynamic_slice(xq, (q0, 0), (qc, d))
            lp_c = lax.dynamic_slice(lp, (q0, 0), (qc, npb))
            own_c = lax.dynamic_slice(owned, (q0, 0), (qc, npb))
            if pq:
                from ..ops.pq import codec_decode

                probe_c = lax.dynamic_slice(probe, (q0, 0), (qc, npb))
                m = payload.shape[2]
                codes_c = payload[lp_c].reshape(-1, m)     # (qc*npb*lmax, m)
                resid = codec_decode(codes_c, codebooks,
                                     pq_codec).reshape(qc, npb, lmax, d)
                xc = resid + centroids[probe_c][:, :, None, :]
            elif sq:
                from ..ops.sq import sq_decode

                w = payload.shape[2]
                codes_c = payload[lp_c].reshape(-1, w)
                xc = sq_decode(codes_c, sq_vmin, sq_scale, sq).reshape(
                    qc, npb, lmax, d)
            else:
                xc = payload[lp_c]                         # (qc,npb,lmax,d)
            if metric == "INNER_PRODUCT":
                s = jnp.einsum("qd,qpld->qpl", xq_c, xc,
                               precision=precision,
                               preferred_element_type=jnp.float32)
            else:
                diff = xc - xq_c[:, None, None, :]
                s = -jnp.sum(diff * diff, axis=-1)
            lane = lax.broadcasted_iota(jnp.int32, (qc, npb, lmax), 2)
            valid = jnp.logical_and(lane < counts[lp_c][:, :, None],
                                    own_c[:, :, None])
            if sel_mask is not None:
                valid = jnp.logical_and(valid, sel_mask[lp_c] != 0)
            s = jnp.where(valid, s, _NEG_INF)
            flat = s.reshape(qc, ncand)
            # In-chunk exact rerank (fast-mode IP only — the L2 branch
            # scores elementwise in fp32 already); shared helper with the
            # single-device gather scans.
            from ..ops.ivf_scan import inchunk_exact_rerank

            best, sel = inchunk_exact_rerank(
                xq_c, xc.reshape(qc, ncand, d), flat, k=k, k_scan=k_scan,
                metric=metric)
            slot, ln = sel // lmax, sel % lmax
            lids = jnp.take_along_axis(lp_c, slot, axis=1)
            pos = row_pos[lids, ln]
            pos = jnp.where(jnp.isneginf(best), -1, pos)
            bs = lax.dynamic_update_slice(bs, best, (q0, 0))
            bp = lax.dynamic_update_slice(bp, pos, (q0, 0))
            return bs, bp

        init = (jnp.full((nq, k), _NEG_INF, jnp.float32),
                jnp.full((nq, k), -1, jnp.int32))
        scores, pos = lax.fori_loop(0, nq // qc, chunk, init)

        return _merge_shard_topk(scores, pos, k, metric)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("shard", None, None), P("shard"), P("shard", None),
                  P(None, None), P("batch", None), P()) + extra_specs,
        out_specs=(P("batch", None), P("batch", None)),
        check_vma=False,
    )
    return jax.jit(fn)
