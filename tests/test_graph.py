"""CAGRA-style graph ANN: build + batched walk (ops/graph.py) and the
default HNSW/NSG graph regime (models/hnsw.py).

The reference's HNSW surface is src/faiss_extension.cpp:133-141 (create,
efConstruction) and :691-702 (efSearch).  These tests cover the device-native
graph-algorithm execution of that surface: exact-kNN build + reverse-edge
augmentation, fixed-shape greedy walk, selector semantics (traverse
unfiltered, collect filtered), tail merge, and persistence of the adjacency.
"""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx


def _clustered(n, d, seed=0, ncenters=32, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncenters, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncenters, n)] +
            rng.standard_normal((n, d)).astype(np.float32) * spread)


# ---------------------------------------------------------------------------
# ops level
# ---------------------------------------------------------------------------

def test_build_graph_properties():
    from duckdb_faiss_ext_tpu.ops.graph import build_graph, build_knn_graph

    xb = _clustered(2000, 16, seed=1)
    knn = build_knn_graph(xb, 8, "L2")
    assert knn.shape == (2000, 8) and knn.dtype == np.int32
    assert not (knn == np.arange(2000)[:, None]).any()       # no self edges
    assert knn.min() >= 0 and knn.max() < 2000
    # kNN rows match a brute-force oracle (set-wise; ties may reorder).
    d2 = ((xb[:5, None, :] - xb[None, :, :]) ** 2).sum(-1)
    d2[np.arange(5), np.arange(5)] = np.inf
    oracle = np.argsort(d2, axis=1)[:, :8]
    for i in range(5):
        assert len(set(knn[i]) & set(oracle[i])) >= 7  # ties allowed

    g = build_graph(xb, 8, "L2")
    assert g.shape == (2000, 8)
    assert not (g == np.arange(2000)[:, None]).any()
    # No duplicate neighbours within a row.
    for row in g[:50]:
        ids = row[row >= 0]
        assert len(set(ids.tolist())) == len(ids)


def test_build_graph_tiny_corpus():
    from duckdb_faiss_ext_tpu.ops.graph import build_graph

    xb = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    g = build_graph(xb, 8, "L2")
    assert g.shape == (5, 8)
    # Only 4 possible neighbours per node: the rest must be -1.
    assert ((g >= 0).sum(axis=1) <= 4).all()


def test_graph_walk_recall_and_determinism():
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu.ops.graph import build_graph, graph_search
    from duckdb_faiss_ext_tpu.utils.config import next_pow2, pad_rows

    n, d, k = 8000, 16, 10
    xb = _clustered(n, d, seed=3)
    xq = _clustered(64, d, seed=4)
    g = build_graph(xb, 16, "L2")
    cap = next_pow2(n)
    xb_dev = jnp.asarray(pad_rows(xb, cap))
    g_dev = jnp.asarray(np.concatenate(
        [g, np.full((cap - n, 16), -1, np.int32)]))

    s, p = graph_search(xb_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                        pool=64, width=8)
    dist, pos = finalize_scores(s, p, "L2")
    dist, pos = np.asarray(dist), np.asarray(pos)

    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1)[:, :k]
    recall = np.mean([len(set(pos[i]) & set(oracle[i])) / k
                      for i in range(len(xq))])
    assert recall > 0.95
    # Distances are true squared-L2 values of the returned rows, sorted.
    dd = np.take_along_axis(d2, np.maximum(pos, 0), axis=1)
    assert np.allclose(dd, dist, rtol=1e-4, atol=1e-4)
    assert (np.diff(dist, axis=1) >= -1e-6).all()

    s2, p2 = graph_search(xb_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                          pool=64, width=8)
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(p))  # determinism


def test_graph_walk_packed_matches_scattered():
    """The packed-neighbourhood walk (bf16 traversal + fp32 rerank) reaches
    the same recall as the scattered-gather walk, and its returned distances
    are fp32-exact (the rerank epilogue)."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu.ops.graph import (build_graph, graph_search,
                                                pack_neighbors)
    from duckdb_faiss_ext_tpu.utils.config import next_pow2, pad_rows

    n, d, k = 8000, 16, 10
    xb = _clustered(n, d, seed=7)
    xq = _clustered(64, d, seed=8)
    g = build_graph(xb, 16, "L2")
    cap = next_pow2(n)
    xb_dev = jnp.asarray(pad_rows(xb, cap))
    g_dev = jnp.asarray(np.concatenate(
        [g, np.full((cap - n, 16), -1, np.int32)]))
    pack = pack_neighbors(xb_dev, g_dev)
    assert pack.dtype == jnp.bfloat16 and pack.shape == (cap, 16 * 16)
    pack8 = pack_neighbors(xb_dev, g_dev, dtype=jnp.int8)
    assert pack8[0].dtype == jnp.int8
    # Row-split packs (the >6 GB single-tensor workaround): identical
    # semantics, rows just live in two tensors.
    pack4 = pack_neighbors(xb_dev, g_dev, dtype="int4")
    pack4_2 = pack_neighbors(xb_dev, g_dev, dtype="int4", parts=2)
    assert isinstance(pack4_2[0], tuple) and len(pack4_2[0]) == 2
    assert pack4_2[0][0].shape[0] == cap // 2

    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1)[:, :k]

    recalls = {}
    for name, pk in (("scattered", None), ("packed", pack),
                     ("packed8", pack8), ("packed4", pack4),
                     ("packed4x2", pack4_2)):
        s, p = graph_search(xb_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                            pool=64, width=8, pack=pk)
        dist, pos = finalize_scores(s, p, "L2")
        dist, pos = np.asarray(dist), np.asarray(pos)
        recalls[name] = np.mean([len(set(pos[i]) & set(oracle[i])) / k
                                 for i in range(len(xq))])
        # fp32-exact distances either way (rerank runs on the fp32 corpus).
        dd = np.take_along_axis(d2, np.maximum(pos, 0), axis=1)
        assert np.allclose(dd, dist, rtol=1e-4, atol=1e-4), name
    assert recalls["packed"] > 0.9
    assert recalls["packed8"] > 0.9
    assert recalls["packed4x2"] > 0.85     # int4 traversal is coarser
    assert abs(recalls["packed"] - recalls["scattered"]) < 0.05
    # The row split itself must be semantics-free: identical nibbles,
    # rows just live in two tensors.
    assert recalls["packed4x2"] == recalls["packed4"]


def test_clustered_build_quality():
    """The top-2-list clustered build + NN-descent refinement approximates
    the exact kNN graph well enough for high walk recall (the >2M-row build
    path, forced small here)."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu.ops.graph import (augment_graph,
                                                build_knn_graph_clustered,
                                                graph_search,
                                                refine_knn_graph)
    from duckdb_faiss_ext_tpu.utils.config import next_pow2, pad_rows

    n, d, k = 20000, 16, 10
    xb = _clustered(n, d, seed=80, ncenters=128)
    xq = _clustered(100, d, seed=81, ncenters=128)
    knn = build_knn_graph_clustered(xb, 16, "L2")
    assert knn.shape == (n, 16)
    assert not (knn == np.arange(n)[:, None]).any()
    knn = refine_knn_graph(xb, knn, "L2", rounds=1)
    assert not (knn == np.arange(n)[:, None]).any()
    g = augment_graph(knn, 16)
    cap = next_pow2(n)
    xb_dev = jnp.asarray(pad_rows(xb, cap))
    g_dev = jnp.asarray(np.concatenate(
        [g, np.full((cap - n, 16), -1, np.int32)]))
    s, p = graph_search(xb_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                        pool=64, width=8)
    _, pos = finalize_scores(s, p, "L2")
    pos = np.asarray(pos)
    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1)[:, :k]
    recall = np.mean([len(set(pos[i]) & set(oracle[i])) / k
                      for i in range(len(xq))])
    assert recall > 0.85


def test_hnsw_clustered_build_regime(catalog):
    """Past graph_max rows the HNSW graph regime stays graph (no IVF
    fallback) via the clustered build."""
    d, n = 16, 5000
    xb = _clustered(n, d, seed=82)
    dfx.faiss_create("hgc", d, "HNSW32", metric_type="L2", catalog=catalog)
    idx = catalog.get("hgc").index
    idx.ann_threshold = 1000
    idx.graph_max = 2000          # force the clustered build at test scale
    dfx.faiss_add(xb, "hgc", catalog=catalog)
    res = dfx.faiss_search("hgc", 5, xb[:10], {"efSearch": "64"},
                           catalog=catalog)
    assert idx._effective_mode() == "graph"
    assert idx._graph is not None and idx._accel is None
    assert np.all(res["label"][:, 0] == np.arange(10))


# ---------------------------------------------------------------------------
# HNSW surface (graph = default regime at scale)
# ---------------------------------------------------------------------------

def test_hnsw_graph_regime_default(catalog):
    rng = np.random.default_rng(60)
    d, n = 16, 6000
    xb = _clustered(n, d, seed=60)
    xq = xb[:10]
    dfx.faiss_create("hg", d, "HNSW32", metric_type="L2", catalog=catalog)
    idx = catalog.get("hg").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hg", catalog=catalog)

    exact = dfx.faiss_search("hg", 5, xq, {"exact": "true"}, catalog=catalog)
    approx = dfx.faiss_search("hg", 5, xq, {"efSearch": "64"},
                              catalog=catalog)
    assert idx._graph is not None      # graph was built (default mode)
    assert idx._accel is None          # not the IVF partition
    assert np.all(approx["label"][:, 0] == np.arange(10))
    recall = np.mean([len(set(approx["label"][q]) & set(exact["label"][q]))
                      for q in range(10)]) / 5
    assert recall > 0.9

    # Tail rows merge without a rebuild; big tail triggers one.  (The tail
    # points sit far from the corpus so their self-hit is unambiguous —
    # near-duplicates of corpus rows tie at fp32 and either side may win.)
    extra = rng.standard_normal((10, d)).astype(np.float32) * 20
    dfx.faiss_add(extra, "hg", catalog=catalog)
    graph_before = idx._graph
    res = dfx.faiss_search("hg", 3, extra, {"efSearch": "64"},
                           catalog=catalog)
    assert idx._graph is graph_before
    assert np.all(res["label"][:, 0] >= n)
    more = _clustered(3000, d, seed=61)
    dfx.faiss_add(more, "hg", catalog=catalog)
    dfx.faiss_search("hg", 3, xq[:2], catalog=catalog)
    assert idx._graph is not graph_before
    assert idx._graph[1] == idx.ntotal


def test_hnsw_graph_selector(catalog):
    rng = np.random.default_rng(61)
    d, n = 8, 3000
    xb = _clustered(n, d, seed=62)
    dfx.faiss_create("hgsel", d, "HNSW16", metric_type="L2", catalog=catalog)
    idx = catalog.get("hgsel").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hgsel", catalog=catalog)
    sel = dfx.SetSelector(np.arange(0, n, 3, dtype=np.int64))
    res = dfx.faiss_search("hgsel", 5, xb[:6], {"efSearch": "128"},
                           catalog=catalog, selector=sel)
    assert idx._graph is not None
    assert np.all(res["label"] % 3 == 0)
    # Filtered results match the exact filtered scan on clustered data with
    # an inflated pool (recall, not equality: the walk is approximate).
    ex = dfx.faiss_search("hgsel", 5, xb[:6], {"exact": "true"},
                          catalog=catalog, selector=sel)
    hits = np.mean([len(set(res["label"][q]) & set(ex["label"][q]))
                    for q in range(6)]) / 5
    assert hits > 0.8


def test_hnsw_graph_save_load(catalog, tmp_path):
    """The adjacency persists through save/load (no O(n²) rebuild)."""
    d, n = 8, 3000
    xb = _clustered(n, d, seed=63)
    dfx.faiss_create("hgsl", d, "HNSW16", metric_type="L2", catalog=catalog)
    idx = catalog.get("hgsl").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hgsl", catalog=catalog)
    before = dfx.faiss_search("hgsl", 5, xb[:6], {"efSearch": "256"},
                              catalog=catalog)
    assert idx._graph is not None
    path = str(tmp_path / "hnsw_graph.idx")
    dfx.faiss_save("hgsl", path, catalog=catalog)
    dfx.faiss_load("hgsl2", path, catalog=catalog)
    idx2 = catalog.get("hgsl2").index
    assert idx2._graph is not None
    np.testing.assert_array_equal(idx2._graph[0], idx._graph[0])
    assert idx2.accel_mode == "graph"
    idx2.ann_threshold = 1000
    after = dfx.faiss_search("hgsl2", 5, xb[:6], {"efSearch": "256"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=1e-5, atol=1e-5)


def test_hnsw_soar_forces_ivf_partition(catalog):
    """soar_lambda is an IVF-partition feature: it must keep selecting the
    IVF regime even though graph is the default."""
    d, n = 8, 2000
    xb = _clustered(n, d, seed=64)
    dfx.faiss_create_params("hsoar", d, "HNSW16", {"soar_lambda": "1.0"},
                            metric_type="L2", catalog=catalog)
    idx = catalog.get("hsoar").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hsoar", catalog=catalog)
    dfx.faiss_search("hsoar", 3, xb[:4], {"efSearch": "64"}, catalog=catalog)
    assert idx._accel is not None and idx._graph is None


def test_idmap_hnsw_graph_regime_custom_labels(catalog):
    """The reference's benchmark index string (IDMap,HNSW128,Flat,
    go/cmd/create_index/main.go:29) in the graph regime, with custom
    labels: results come back in label space, self-hits first."""
    d, n = 16, 4000
    xb = _clustered(n, d, seed=66)
    labels = np.arange(n, dtype=np.int64) * 7 + 3
    dfx.faiss_create("bidm", d, "IDMap,HNSW128,Flat", metric_type="L2",
                     catalog=catalog)
    inner = catalog.get("bidm").index.inner
    inner.ann_threshold = 1000
    dfx.faiss_add((labels, xb), "bidm", catalog=catalog)
    res = dfx.faiss_search("bidm", 5, xb[:16], {"efSearch": "64"},
                           catalog=catalog)
    assert inner._graph is not None
    np.testing.assert_array_equal(res["label"][:, 0], labels[:16])
    # Batched serving path returns the same results.
    rb = dfx.faiss_search_batched("bidm", 5, xb[:16],
                                  {"efSearch": "64"}, catalog=catalog)
    np.testing.assert_array_equal(rb["label"], res["label"])


def test_hnsw_graph_batched_dispatch(catalog):
    """The graph regime rides the single-fetch batched serving path: a raw
    dispatch tuple exists (no tail), and batched results equal sequential
    ones — including with a selector."""
    d, n = 16, 4000
    xb = _clustered(n, d, seed=69)
    dfx.faiss_create("hgb", d, "HNSW32", metric_type="L2", catalog=catalog)
    idx = catalog.get("hgb").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hgb", catalog=catalog)
    params = {"efSearch": "64"}
    seq = dfx.faiss_search("hgb", 5, xb[:32], params, catalog=catalog)
    from duckdb_faiss_ext_tpu.params import ParamMap

    disp = idx.search_dispatch(xb[:8], 5, ParamMap(params))
    assert disp is not None          # graph dispatch active (no tail)
    bat = dfx.faiss_search_batched("hgb", 5, xb[:32], params, batch_size=8,
                                   catalog=catalog)
    np.testing.assert_array_equal(bat["label"], seq["label"])
    np.testing.assert_allclose(bat["distance"], seq["distance"], rtol=1e-6)
    sel = dfx.SetSelector(np.arange(0, n, 2, dtype=np.int64))
    bsel = dfx.faiss_search_batched("hgb", 5, xb[:16], params, batch_size=8,
                                    catalog=catalog, selector=sel)
    assert np.all(bsel["label"] % 2 == 0)
    # With a tail, dispatch opts out (host merge needed) but batched
    # serving still returns correct results via the fallback.
    rng = np.random.default_rng(72)
    extra = rng.standard_normal((6, d)).astype(np.float32) * 20
    dfx.faiss_add(extra, "hgb", catalog=catalog)
    assert idx.search_dispatch(xb[:8], 5, ParamMap(params)) is None
    bt = dfx.faiss_search_batched("hgb", 3, extra, params, batch_size=4,
                                  catalog=catalog)
    assert np.all(bt["label"][:, 0] >= n)


def test_hnsw_graph_sharded_placement(catalog):
    """faiss_to_device on HNSW in the graph regime: per-shard subgraph
    walks under shard_map, merged top-k matches the exact oracle on
    clustered data; a selector falls back to the sharded exact scan; tail
    rows merge."""
    from duckdb_faiss_ext_tpu.parallel.sharded import make_mesh

    d, n = 16, 6000
    xb = _clustered(n, d, seed=70)
    xq = xb[:12]
    dfx.faiss_create("hgs", d, "HNSW32", metric_type="L2", catalog=catalog)
    idx = catalog.get("hgs").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hgs", catalog=catalog)
    mesh = make_mesh(8, batch_axis=2)
    dfx.faiss_to_device("hgs", mesh, catalog=catalog)
    assert idx._effective_mode() == "graph_sharded"

    exact = dfx.faiss_search("hgs", 5, xq, {"exact": "true"},
                             catalog=catalog)
    res = dfx.faiss_search("hgs", 5, xq, {"efSearch": "64"},
                           catalog=catalog)
    assert idx._graph_sharded is not None
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(12))
    recall = np.mean([len(set(res["label"][q]) & set(exact["label"][q]))
                      for q in range(12)]) / 5
    assert recall > 0.9

    # Selector: falls back to the sharded exact filtered scan.
    sel = dfx.SetSelector(np.arange(0, n, 3, dtype=np.int64))
    rs = dfx.faiss_search("hgs", 5, xq[:4], catalog=catalog, selector=sel)
    assert np.all(rs["label"] % 3 == 0)

    # Tail rows (no rebuild) still found via the exact tail merge.
    rng = np.random.default_rng(71)
    extra = rng.standard_normal((8, d)).astype(np.float32) * 20
    dfx.faiss_add(extra, "hgs", catalog=catalog)
    rt = dfx.faiss_search("hgs", 3, extra, {"efSearch": "64"},
                          catalog=catalog)
    assert np.all(rt["label"][:, 0] >= n)


def test_graph_build_lock_single_build(catalog, monkeypatch):
    """Concurrent first searches trigger exactly ONE graph build (the
    per-index build lock; a duplicate build costs O(n²))."""
    import threading

    d, n = 8, 3000
    xb = _clustered(n, d, seed=90)
    dfx.faiss_create("hlock", d, "HNSW16", metric_type="L2",
                     catalog=catalog)
    idx = catalog.get("hlock").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hlock", catalog=catalog)

    calls = []
    from duckdb_faiss_ext_tpu.ops import graph as graph_ops

    orig = graph_ops.build_graph

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(graph_ops, "build_graph", counting)
    errs = []

    def run():
        try:
            dfx.faiss_search("hlock", 3, xb[:4], {"efSearch": "32"},
                             catalog=catalog)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errs
    assert len(calls) == 1


def test_hnsw_sharded_clustered_build(catalog):
    """Sharded placement + graph_max below the shard block size: each
    shard's subgraph builds via the clustered path; results stay sane."""
    from duckdb_faiss_ext_tpu.parallel.sharded import make_mesh

    d, n = 8, 4000
    xb = _clustered(n, d, seed=92)
    dfx.faiss_create("hgsc", d, "HNSW16", metric_type="L2", catalog=catalog)
    idx = catalog.get("hgsc").index
    idx.ann_threshold = 1000
    idx.graph_max = 400            # per-shard blocks (1000 rows) exceed it
    dfx.faiss_add(xb, "hgsc", catalog=catalog)
    dfx.faiss_to_device("hgsc", make_mesh(4, batch_axis=1), catalog=catalog)
    res = dfx.faiss_search("hgsc", 5, xb[:8], {"efSearch": "64"},
                           catalog=catalog)
    assert idx._graph_sharded is not None
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(8))


def test_hnsw_graph_inner_product(catalog):
    """Graph regime under INNER_PRODUCT: similarity ordering (descending),
    self-hits first on normalised clustered data."""
    d, n = 16, 3000
    xb = _clustered(n, d, seed=91)
    xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    dfx.faiss_create("hip", d, "HNSW32", metric_type="INNER_PRODUCT",
                     catalog=catalog)
    idx = catalog.get("hip").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hip", catalog=catalog)
    res = dfx.faiss_search("hip", 5, xb[:8], {"efSearch": "64"},
                           catalog=catalog)
    assert idx._graph is not None
    np.testing.assert_array_equal(res["label"][:, 0], np.arange(8))
    assert (np.diff(res["distance"], axis=1) <= 1e-6).all()  # descending
    exact = dfx.faiss_search("hip", 5, xb[:8], {"exact": "true"},
                             catalog=catalog)
    hits = np.mean([len(set(res["label"][q]) & set(exact["label"][q]))
                    for q in range(8)]) / 5
    assert hits > 0.9


def test_nsg_graph_regime(catalog):
    """NSG at scale rides the same graph walk; search_L maps to the pool."""
    d, n = 8, 3000
    xb = _clustered(n, d, seed=65)
    dfx.faiss_create("nsgg", d, "NSG32", metric_type="L2", catalog=catalog)
    idx = catalog.get("nsgg").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "nsgg", catalog=catalog)
    res = dfx.faiss_search("nsgg", 5, xb[:8], {"search_L": "64"},
                           catalog=catalog)
    assert idx._graph is not None
    assert np.all(res["label"][:, 0] == np.arange(8))


def test_augment_graph_forward_first_default():
    """Default augmentation keeps every forward edge (reverse edges only
    backfill missing slots) — measured better on uniform corpora; the
    CAGRA half/half split stays available via fkeep."""
    from duckdb_faiss_ext_tpu.ops.graph import augment_graph

    rng = np.random.default_rng(0)
    n, inter, deg = 64, 16, 8
    scores = rng.standard_normal((n, n))
    np.fill_diagonal(scores, np.inf)                 # no self edges
    knn = np.argsort(scores, axis=1)[:, :inter].astype(np.int32)
    g = augment_graph(knn, deg)
    np.testing.assert_array_equal(g, knn[:, :deg])   # pure forward

    half = augment_graph(knn, deg, fkeep=deg // 2)
    np.testing.assert_array_equal(half[:, : deg // 2], knn[:, : deg // 2])
    assert not np.array_equal(half, knn[:, :deg])    # reverse edges landed

    # Rows with missing forward edges get reverse backfill under the default.
    knn2 = knn.copy()
    knn2[0, 2:] = -1
    g2 = augment_graph(knn2, deg)
    assert (g2[0] >= 0).sum() > 2


def test_build_graph_refine_rounds_knob():
    from duckdb_faiss_ext_tpu.ops.graph import build_graph

    rng = np.random.default_rng(1)
    xb = rng.standard_normal((600, 16)).astype(np.float32)
    # Force the clustered+refine path with exact_max below n.
    g1 = build_graph(xb, 8, "L2", exact_max=100, refine_rounds=1)
    g3 = build_graph(xb, 8, "L2", exact_max=100, refine_rounds=3)
    assert g1.shape == g3.shape == (600, 8)
    # More rounds converge toward the exact kNN graph.
    exact = build_graph(xb, 8, "L2")

    def overlap(a, b):
        return np.mean([len(set(x[x >= 0]) & set(y[y >= 0])) / 8
                        for x, y in zip(a, b)])

    assert overlap(g3, exact) >= overlap(g1, exact) - 0.02


def test_int4_pack_roundtrip_and_walk():
    """int4 nibble packs decode to within quantization error and the
    packed walk stays near the unpacked one (final pool is fp32-reranked
    either way, so distances of agreeing labels are exact)."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.graph import (build_graph, graph_search,
                                                pack_neighbors,
                                                unpack_i4_blocks)

    rng = np.random.default_rng(7)
    n, d, deg, k = 4000, 33, 16, 10          # odd d exercises the pad
    xb = rng.standard_normal((n, d)).astype(np.float32)
    xq = rng.standard_normal((64, d)).astype(np.float32)
    xb_dev = jnp.asarray(xb)
    g = jnp.asarray(build_graph(xb, deg, "L2"))

    p4, inv = pack_neighbors(xb_dev, g, "int4")
    w4 = (d + 1) // 2
    assert p4.dtype == jnp.uint8 and p4.shape == (n, deg * w4)
    dec = np.asarray(unpack_i4_blocks(p4.reshape(n, deg, w4), d, inv))
    ref = xb[np.maximum(np.asarray(g), 0)]
    step = float(inv)                        # one quantization step
    assert np.abs(dec - ref).max() <= 0.51 * step + 1e-6

    s0, p0 = graph_search(xb_dev, g, jnp.asarray(xq), n, k, "L2", pool=32)
    s4, pp = graph_search(xb_dev, g, jnp.asarray(xq), n, k, "L2", pool=32,
                          pack=(p4, inv))
    r0 = np.asarray(p0)
    r4 = np.asarray(pp)
    overlap = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / k
                       for a, b in zip(r0, r4)])
    assert overlap > 0.9, overlap
    # Agreeing labels carry identical fp32-reranked scores.
    same = (r0 == r4) & (r0 >= 0)
    np.testing.assert_allclose(np.asarray(s4)[same], np.asarray(s0)[same],
                               rtol=1e-5, atol=1e-5)


def test_coded_graph_build_and_walk():
    """SQ8-coded corpus variants of the clustered kNN build, NN-descent,
    and walk: the 8.8M x 1536 regime where fp32 rows cannot exist on-chip.
    With a fine-grained codec the coded paths must closely match the fp32
    ones (decode error only)."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu.ops.graph import (
        _clustered_knn_scan, _top2_assign, augment_graph, graph_search,
        membership_table, refine_knn_graph)
    from duckdb_faiss_ext_tpu.ops.kmeans import kmeans_fit
    from duckdb_faiss_ext_tpu.ops.sq import (SQ_LEVELS, sq_quantize,
                                             sq_train)
    from duckdb_faiss_ext_tpu.utils.config import next_capacity, pad_rows

    n, d, k, deg = 12000, 24, 10, 16
    xb = _clustered(n, d, seed=21, ncenters=64)
    xq = _clustered(64, d, seed=22, ncenters=64)
    vmin, scale = sq_train(jnp.asarray(xb), SQ_LEVELS["sq8"])
    codes = np.asarray(sq_quantize(jnp.asarray(xb), vmin, scale,
                                   levels=SQ_LEVELS["sq8"]))
    # Oracle over the DECODED corpus (coded paths are exact vs it).
    xb_dec = np.asarray(codes, np.float32) * np.asarray(scale) \
        + np.asarray(vmin)

    cents, _ = kmeans_fit(xb[::3], 32, seed=0)
    a12 = _top2_assign(xb_dec, np.asarray(cents), "L2", 0.0, None)
    table, lmax = membership_table(a12, 32, 2 * deg)
    cap = max(128, next_capacity(n))
    codes_dev = jnp.asarray(pad_rows(codes, cap))

    import jax
    knn = np.asarray(_clustered_knn_scan(
        codes_dev, jnp.asarray(table), jnp.float32(0.0),
        degree=2 * deg, lmax=int(lmax), nlist=32, metric="L2",
        precision=jax.lax.Precision.DEFAULT, codec="sq8", vmin=vmin,
        scale=scale)[:n])
    assert not (knn == np.arange(n)[:, None]).any()
    knn2 = refine_knn_graph(xb_dec, knn, "L2", rounds=1)
    g = augment_graph(knn2, deg)
    g_dev = jnp.asarray(np.concatenate(
        [g, np.full((cap - n, deg), -1, np.int32)]))

    s, p = graph_search(codes_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                        pool=64, width=8, codec="sq8", vmin=vmin,
                        scale=scale)
    dist, pos = finalize_scores(s, p, "L2")
    dist, pos = np.asarray(dist), np.asarray(pos)
    d2 = ((xq[:, None, :] - xb_dec[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1)[:, :k]
    recall = np.mean([len(set(pos[i]) & set(oracle[i])) / k
                      for i in range(len(xq))])
    assert recall > 0.9
    # Output distances are exact vs the DECODED rows (IVF,SQ semantics).
    dd = np.take_along_axis(d2, np.maximum(pos, 0), axis=1)
    assert np.allclose(dd, dist, rtol=1e-4, atol=1e-4)


def test_chunked_build_paths_match_monolithic():
    """clustered_knn_scan_chunked / nn_descent_round_chunked are exact
    host-chunked equivalents of the single-dispatch ops (the chunking
    exists because one fori over 32k cells / 550k row-blocks is a
    single ~30-min XLA dispatch at an 8.8M-row build)."""
    import jax
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.graph import (
        _clustered_knn_scan, _nn_descent_round, _top2_assign,
        clustered_knn_scan_chunked, membership_table,
        nn_descent_round_chunked)
    from duckdb_faiss_ext_tpu.ops.kmeans import kmeans_fit

    n, d, deg, nlist = 4096, 16, 8, 16
    xb = _clustered(n, d, seed=31, ncenters=32).astype(np.float32)
    cents, _ = kmeans_fit(xb[::3], nlist, seed=0)
    a12 = _top2_assign(xb, np.asarray(cents), "L2", 0.0, None)
    table, lmax = membership_table(a12, nlist, deg)
    xb_dev, table_dev = jnp.asarray(xb), jnp.asarray(table)
    kw = dict(degree=deg, lmax=int(lmax), nlist=nlist, metric="L2",
              precision=jax.lax.Precision.HIGHEST)
    mono = np.asarray(_clustered_knn_scan(
        xb_dev, table_dev, jnp.float32(0.0), **kw))
    chunked = np.asarray(clustered_knn_scan_chunked(
        xb_dev, table_dev, jnp.float32(0.0), cells_per_call=5, **kw))
    assert (mono == chunked).all()

    knn = jnp.asarray(mono)
    dkw = dict(sample=3, q_block=16, metric="L2",
               precision=jax.lax.Precision.HIGHEST)
    r_mono = np.asarray(_nn_descent_round(
        xb_dev, knn, jnp.float32(0.0), **dkw))
    r_chunk = np.asarray(nn_descent_round_chunked(
        xb_dev, knn, jnp.float32(0.0), rows_per_call=1024, **dkw))
    assert (r_mono == r_chunk).all()


def test_sq6_coded_walk():
    """SQ6-coded serving walk (the marco deg-64 regime: SQ6 codes free
    ~3.4 GiB of HBM vs SQ8 for a deg-64 adjacency).  Walk over row-major
    packed sq6 codes must closely match the decoded-corpus oracle."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.flat_search import finalize_scores
    from duckdb_faiss_ext_tpu.ops.graph import (augment_graph,
                                                graph_search)
    from duckdb_faiss_ext_tpu.ops.sq import (SQ_LEVELS, sq6_pack,
                                             sq6_unpack_host, sq_quantize,
                                             sq_train)
    from duckdb_faiss_ext_tpu.utils.config import next_capacity, pad_rows

    n, d, k, deg = 6000, 24, 10, 16
    xb = _clustered(n, d, seed=31, ncenters=32)
    xq = _clustered(32, d, seed=32, ncenters=32)
    vmin, scale = sq_train(jnp.asarray(xb), SQ_LEVELS["sq6"])
    q = np.asarray(sq_quantize(jnp.asarray(xb), vmin, scale,
                               levels=SQ_LEVELS["sq6"]))
    codes = sq6_pack(q)
    xb_dec = sq6_unpack_host(codes, d).astype(np.float32) \
        * np.asarray(scale) + np.asarray(vmin)

    # exact kNN graph over the decoded corpus (build quality is not the
    # subject here — the sq6 DECODE inside the walk is)
    d2 = ((xb_dec[:, None, :] - xb_dec[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1)[:, : 2 * deg].astype(np.int32)
    g = augment_graph(knn, deg)
    cap = max(128, next_capacity(n))
    codes_dev = jnp.asarray(pad_rows(codes, cap))
    g_dev = jnp.asarray(np.concatenate(
        [g, np.full((cap - n, deg), -1, np.int32)]))

    s, p = graph_search(codes_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                        pool=64, width=8, codec="sq6", vmin=vmin,
                        scale=scale)
    dist, pos = finalize_scores(s, p, "L2")
    pos = np.asarray(pos)
    dq = ((xq[:, None, :] - xb_dec[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(dq, axis=1)[:, :k]
    recall = np.mean([len(set(pos[i]) & set(oracle[i])) / k
                      for i in range(len(xq))])
    assert recall > 0.85


def test_folded_adjacency_walk_matches():
    """Lane-folded adjacency ((N/f, f*deg) with deg passed explicitly)
    must walk identically to the plain (N, deg) table — the fold exists
    purely to avoid XLA's 64->128 lane-pad copy of the gather operand
    (the 8.8M deg-64 compile OOM)."""
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.graph import (augment_graph,
                                                graph_search)
    from duckdb_faiss_ext_tpu.utils.config import next_capacity, pad_rows

    n, d, k, deg = 4000, 16, 8, 16     # fold = 8
    xb = _clustered(n, d, seed=41, ncenters=16)
    xq = _clustered(16, d, seed=42, ncenters=16)
    d2 = ((xb[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1)[:, : 2 * deg].astype(np.int32)
    g = augment_graph(knn, deg)
    cap = max(128, next_capacity(n))
    xb_dev = jnp.asarray(pad_rows(xb, cap))
    g_pad = np.concatenate([g, np.full((cap - n, deg), -1, np.int32)])
    g_dev = jnp.asarray(g_pad)
    fold = 128 // deg
    g_folded = jnp.asarray(g_pad.reshape(cap // fold, fold * deg))

    s1, p1 = graph_search(xb_dev, g_dev, jnp.asarray(xq), n, k, "L2",
                          pool=32, width=4)
    s2, p2 = graph_search(xb_dev, g_folded, jnp.asarray(xq), n, k, "L2",
                          pool=32, width=4, deg=deg)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
