"""Regression tests for the round-1 code-review findings."""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx

RNG = np.random.default_rng(99)


def test_elementwise_metric_large_k(catalog):
    """choose_blocks must keep c_block ≥ k (crashed with L1, d=512, k=200)."""
    d, n, k = 512, 300, 200
    xb = RNG.random((n, d), dtype=np.float32)
    xq = RNG.random((256, d), dtype=np.float32)
    dfx.faiss_create("ek", d, "Flat", metric_type="L1", catalog=catalog)
    dfx.faiss_add(xb, "ek", catalog=catalog)
    res = dfx.faiss_search("ek", k, xq, catalog=catalog)
    assert res.shape == (256, k)
    assert (res["label"][:, :n] >= 0).all()


def test_graft_entry_callable():
    """entry() must stay in sync with the kernel signature."""
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    fn, args = g.entry()
    d, p = fn(*args)
    assert d.shape == (64, 10)


def test_sequential_selectors_not_confused(catalog):
    """Distinct consecutive filters must not share cached masks."""
    n, d = 200, 8
    ids = np.arange(n)
    xb = RNG.random((n, d), dtype=np.float32)
    dfx.faiss_create("sel2", d, "IDMap,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add((ids, xb), "sel2", catalog=catalog)
    db = dfx.Database()
    db.register("t", {"id": ids})
    for expr, pred in [("id%2==0", lambda l: l % 2 == 0),
                       ("id%2==1", lambda l: l % 2 == 1),
                       ("id<50", lambda l: l < 50),
                       ("id>=150", lambda l: l >= 150)]:
        res = dfx.faiss_search_filter("sel2", 5, xb[:3], expr, "id", "t",
                                      catalog=catalog, database=db)
        got = res["label"][res["label"] >= 0]
        assert got.size and pred(got).all(), expr


def test_deferred_add_failure_resets_latch(catalog):
    """A failed unlabeled add to IDMap,IVF must not poison the latch or
    keep the failed batch staged (mirror of the reference's :518-521)."""
    xb = RNG.random((64, 8), dtype=np.float32)
    ids = np.arange(64)
    dfx.faiss_create("latch", 8, "IDMap,IVF2,Flat", metric_type="L2",
                     catalog=catalog)
    with pytest.raises(dfx.InvalidInputError):
        dfx.faiss_add(xb, "latch", catalog=catalog)  # unlabeled → inner add fails
    # A labeled add must now succeed (latch was reset, stage rolled back).
    dfx.faiss_add((ids, xb), "latch", catalog=catalog)
    res = dfx.faiss_search("latch", 2, xb[:2], {"nprobe": "2"},
                           catalog=catalog)
    assert res["label"][0, 0] == 0


def test_placement_sticky_across_adds(catalog):
    """faiss_to_device sharding survives subsequent adds."""
    xb = RNG.random((300, 16), dtype=np.float32)
    dfx.faiss_create("plc", 16, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "plc", catalog=catalog)
    dfx.faiss_to_device("plc", catalog=catalog)
    dfx.faiss_add(RNG.random((2000, 16), dtype=np.float32), "plc",
                  catalog=catalog)  # grows past the original capacity
    entry = catalog.get("plc")
    buf = entry.index.device_vectors()
    assert len(buf.sharding.device_set) > 1
    res = dfx.faiss_search("plc", 3, xb[:2], catalog=catalog)
    np.testing.assert_array_equal(res["label"][:, 0], [0, 1])


def test_incremental_device_update(catalog):
    """Adds within the capacity bucket update the buffer in place."""
    dfx.faiss_create("inc", 8, "Flat", metric_type="L2", catalog=catalog)
    a = RNG.random((60, 8), dtype=np.float32)
    b = RNG.random((40, 8), dtype=np.float32)
    dfx.faiss_add(a, "inc", catalog=catalog)
    entry = catalog.get("inc")
    buf0 = entry.index.device_vectors()
    dfx.faiss_add(b, "inc", catalog=catalog)   # fits the 128 bucket
    assert entry.index._device_xb is not None  # no invalidation
    res = dfx.faiss_search("inc", 1, b[:5], catalog=catalog)
    np.testing.assert_array_equal(res["label"][:, 0], 60 + np.arange(5))


def test_sql_quoted_literals_preserved():
    """Operator normalisation must not rewrite inside string literals."""
    db = dfx.Database()
    db.register("t", {"tag": np.array([1, 2, 3]), "id": np.arange(3)})
    from duckdb_faiss_ext_tpu.sql.engine import _normalise

    assert _normalise("tag = 'AND'") == "tag == 'AND'"
    assert _normalise("col = 'a=b' AND id=1") == "col == 'a=b' and id==1"
    assert _normalise('x = "NOT y"') == 'x == "NOT y"'


def test_faiss_to_device_ivf_default_mesh(catalog):
    """faiss_to_device('ivf') with no mesh argument must work (builds a
    2-axis default mesh) — regressed as a late search-time crash."""
    xb = RNG.random((600, 8), dtype=np.float32)
    dfx.faiss_create("dmi", 8, "IVF4,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "dmi", catalog=catalog)
    before = dfx.faiss_search("dmi", 3, xb[:2], {"nprobe": "4"},
                              catalog=catalog)
    dfx.faiss_to_device("dmi", catalog=catalog)
    after = dfx.faiss_search("dmi", 3, xb[:2], {"nprobe": "4"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])


def test_sharded_ivf_rejects_unsupported_metric(catalog):
    xb = RNG.random((600, 8), dtype=np.float32)
    dfx.faiss_create("l1i", 8, "IVF4,Flat", metric_type="L1",
                     catalog=catalog)
    dfx.faiss_add(xb, "l1i", catalog=catalog)
    with pytest.raises(dfx.InvalidInputError, match="cannot be sharded"):
        dfx.faiss_to_device("l1i", catalog=catalog)


def test_batched_search_empty_and_bad_batch(catalog):
    dfx.faiss_create("eb", 4, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(RNG.random((10, 4), dtype=np.float32), "eb",
                  catalog=catalog)
    res = dfx.faiss_search_batched("eb", 3, np.empty((0, 4), np.float32),
                                   catalog=catalog)
    assert res.shape == (0, 3)
    with pytest.raises(dfx.InvalidInputError, match="batch_size"):
        dfx.faiss_search_batched("eb", 3, RNG.random((4, 4),
                                                     dtype=np.float32),
                                 batch_size=0, catalog=catalog)


def test_idmap_reconstruct_ivf_inner(catalog):
    # IVF gained reconstruct (IDMap2 composites decode through it); the
    # label-5 row is position 5 with these sequential ids.
    xb = RNG.random((64, 8), dtype=np.float32)
    ids = np.arange(64)
    dfx.faiss_create("rci", 8, "IDMap2,IVF2,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add((ids, xb), "rci", catalog=catalog)
    np.testing.assert_allclose(catalog.get("rci").index.reconstruct(5),
                               xb[5], rtol=1e-6)
    with pytest.raises(dfx.InvalidInputError, match="out of range"):
        catalog.get("rci").index.inner.reconstruct(64)


def test_nested_quantizer_save_load(catalog, tmp_path):
    """Loading an IVFn(IVFm,...) composite retrains the rebuilt (untrained)
    mirror quantizer on the centroid table instead of crashing with
    'Index is not trained' (review finding on the paren grammar)."""
    xb = RNG.random((400, 8), dtype=np.float32)
    dfx.faiss_create("nq", 8, "IVF8(IVF4,Flat)", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "nq", catalog=catalog)
    before = dfx.faiss_search("nq", 3, xb[:5], {"nprobe": "8"},
                              catalog=catalog)
    path = str(tmp_path / "nested.idx")
    dfx.faiss_save("nq", path, catalog=catalog)
    dfx.faiss_load("nq2", path, catalog=catalog)
    after = dfx.faiss_search("nq2", 3, xb[:5], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=1e-6)


def test_lsh0_rejected(catalog):
    """LSH0 must hit the positive-bit-count guard, not silently become
    LSH<d> (review finding: the falsy-0 fallback made the guard dead)."""
    with pytest.raises(dfx.InvalidInputError, match="positive"):
        dfx.faiss_create("lsh0", 16, "LSH0", catalog=catalog)


def test_factory_trailing_junk_rejected(catalog):
    for desc in ("NSG16,SQ8,JUNK", "HNSW16,Flat,JUNK"):
        with pytest.raises(dfx.InvalidInputError, match="could not parse"):
            dfx.faiss_create("junk", 16, desc, catalog=catalog)


def test_ivf_reshard_moves_index(catalog):
    """Re-invoking faiss_to_device with a different mesh must rebuild the
    sharded placement (review finding: caches keyed only on _version made
    re-sharding a silent no-op)."""
    from duckdb_faiss_ext_tpu.parallel.sharded import make_mesh

    xb = RNG.random((600, 8), dtype=np.float32)
    dfx.faiss_create("rs", 8, "IVF8,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "rs", catalog=catalog)
    dfx.faiss_to_device("rs", make_mesh(4, batch_axis=1), catalog=catalog)
    r1 = dfx.faiss_search("rs", 3, xb[:4], {"nprobe": "8"},
                          catalog=catalog)
    ix = catalog.get("rs").index
    old_mesh = ix._shard_mesh
    arrays_before = ix._build_sharded()
    dfx.faiss_to_device("rs", make_mesh(8, batch_axis=1), catalog=catalog)
    assert ix._shard_mesh is not old_mesh
    arrays_after = ix._build_sharded()
    assert arrays_after[0] is not arrays_before[0]
    assert len(arrays_after[0].sharding.mesh.devices.reshape(-1)) == 8
    r2 = dfx.faiss_search("rs", 3, xb[:4], {"nprobe": "8"},
                          catalog=catalog)
    np.testing.assert_array_equal(r1["label"], r2["label"])


def test_imi_quantizer_mirror_not_duplicated(catalog):
    """IMI leaves the mirror quantizer empty — the cell table would
    otherwise be held twice (review finding)."""
    xb = RNG.random((300, 8), dtype=np.float32)
    dfx.faiss_create("imim", 8, "IMI2x3,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "imim", catalog=catalog)
    ix = catalog.get("imim").index
    assert ix.quantizer.ntotal == 0
    assert ix._centroids.shape == (64, 8)


def test_rerank_fp32_exact_in_fast_mode(catalog):
    """RFlat re-rank (and by the same rule the graph-walk pool rerank) must
    compute fp32-exact distances even in fast precision mode: its einsum
    previously inherited the global precision and silently downcast to
    bf16, defeating the wrapper's purpose."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(17)
    xb = rng.standard_normal((512, 32)).astype(np.float32)
    xq = rng.standard_normal((8, 32)).astype(np.float32)
    dfx.set_precision("fast")
    try:
        dfx.faiss_create("rrk", 32, "Flat,RFlat", metric_type="INNER_PRODUCT",
                         catalog=catalog)
        dfx.faiss_add(xb, "rrk", catalog=catalog)
        res = dfx.faiss_search("rrk", 5, xq, {"k_factor": "8"},
                               catalog=catalog)
    finally:
        dfx.set_precision("parity")
    exact = xq @ xb.T
    for q in range(8):
        got_d = res["distance"][q]
        want = exact[q][res["label"][q]]
        # fp32-exact re-scores of whatever candidates the bf16 base chose
        np.testing.assert_allclose(got_d, want, rtol=1e-6)


def test_ivf_fast_mode_inchunk_rerank_noharm(catalog):
    """Fast-mode IVF gather scan widens its reduced-precision top-k and
    exact-rescores in-chunk (HIGHEST).  On CPU both precisions are fp32,
    so this checks the rerank branch executes without changing results vs
    parity mode; the recall lift needs the GPU's TF32."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((32, 32)).astype(np.float32) * 4
    xb = (centers[rng.integers(0, 32, 4000)]
          + rng.standard_normal((4000, 32)).astype(np.float32) * 0.3)
    xq = xb[:32]
    dfx.faiss_create("ivr", 32, "IVF32,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivr", catalog=catalog)
    ref = dfx.faiss_search("ivr", 10, xq, {"nprobe": "32"}, catalog=catalog)
    dfx.set_precision("fast")
    try:
        fast = dfx.faiss_search("ivr", 10, xq, {"nprobe": "32"},
                                catalog=catalog)
    finally:
        dfx.set_precision("parity")
    np.testing.assert_array_equal(ref["label"], fast["label"])
    np.testing.assert_allclose(ref["distance"], fast["distance"], rtol=1e-6)


def test_flat_rerank_param(catalog):
    """Flat fast mode: widened reduced-precision scan + HIGHEST re-score
    of the candidates (always on; a legacy {"rerank": "true"} param is
    accepted) — results match parity mode (trivially on CPU; the lift
    needs the GPU's TF32), through both the plain and the batched serving
    paths, with selectors honoured."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.ops.selectors import BitmapSelector

    rng = np.random.default_rng(6)
    xb = rng.standard_normal((3000, 24)).astype(np.float32)
    xq = xb[:32]
    dfx.faiss_create("frr", 24, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "frr", catalog=catalog)
    ref = dfx.faiss_search("frr", 10, xq, catalog=catalog)
    dfx.set_precision("fast")
    try:
        rr = dfx.faiss_search("frr", 10, xq, {"rerank": "true"},
                              catalog=catalog)
        rb = dfx.faiss_search_batched("frr", 10, xq, {"rerank": "true"},
                                      batch_size=8, catalog=catalog)
        flags = np.zeros(3000, bool)
        flags[::3] = True
        rs = dfx.faiss_search("frr", 10, xq, {"rerank": "true"},
                              catalog=catalog,
                              selector=BitmapSelector.from_bool(flags))
    finally:
        dfx.set_precision("parity")
    np.testing.assert_array_equal(ref["label"], rr["label"])
    np.testing.assert_allclose(ref["distance"], rr["distance"], rtol=1e-6)
    np.testing.assert_array_equal(rr["label"], rb["label"])
    got = rs["label"][rs["label"] >= 0]
    assert np.all(flags[got])


def test_sq8_int8_scan_path(catalog, tmp_path):
    """SQ8's fast-mode int8 MXU scan (codes stay int8 in the dot; per-query
    symmetric quantization + decode-rerank): matches the parity decode path
    labels exactly on clustered data, selector honoured, save/load stable."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.ops.selectors import BitmapSelector

    rng = np.random.default_rng(9)
    centers = rng.standard_normal((32, 48)).astype(np.float32) * 3
    xb = (centers[rng.integers(0, 32, 5000)]
          + rng.standard_normal((5000, 48)).astype(np.float32) * 0.3)
    xq = xb[:32]
    dfx.faiss_create("sq8i", 48, "SQ8", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "sq8i", catalog=catalog)
    ref = dfx.faiss_search("sq8i", 10, xq, catalog=catalog)
    flags = np.zeros(5000, bool)
    flags[::2] = True
    dfx.set_precision("fast")
    try:
        fast = dfx.faiss_search("sq8i", 10, xq, catalog=catalog)
        fsel = dfx.faiss_search("sq8i", 10, xq, catalog=catalog,
                                selector=BitmapSelector.from_bool(flags))
        p = str(tmp_path / "sq8i.dfx")
        dfx.faiss_save("sq8i", p, catalog=catalog)
        dfx.faiss_load("sq8i2", p, catalog=catalog)
        reload = dfx.faiss_search("sq8i2", 10, xq, catalog=catalog)
    finally:
        dfx.set_precision("parity")
    np.testing.assert_array_equal(ref["label"], fast["label"])
    got = fsel["label"][fsel["label"] >= 0]
    assert np.all(flags[got])
    np.testing.assert_array_equal(fast["label"], reload["label"])


def test_ivf_sq8_int8_scan_path(catalog):
    """IVF,SQ8's fast-mode int8 gathered scan matches the parity decode
    path exactly on clustered data; selectors honoured."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.ops.selectors import BitmapSelector

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((64, 48)).astype(np.float32) * 3
    xb = (centers[rng.integers(0, 64, 8000)]
          + rng.standard_normal((8000, 48)).astype(np.float32) * 0.3)
    xq = xb[:32]
    dfx.faiss_create("iv8i", 48, "IVF64,SQ8", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "iv8i", catalog=catalog)
    ref = dfx.faiss_search("iv8i", 10, xq, {"nprobe": "64"}, catalog=catalog)
    flags = np.zeros(8000, bool)
    flags[::2] = True
    dfx.set_precision("fast")
    try:
        fast = dfx.faiss_search("iv8i", 10, xq, {"nprobe": "64"},
                                catalog=catalog)
        fsel = dfx.faiss_search("iv8i", 10, xq, {"nprobe": "64"},
                                catalog=catalog,
                                selector=BitmapSelector.from_bool(flags))
    finally:
        dfx.set_precision("parity")
    np.testing.assert_array_equal(ref["label"], fast["label"])
    got = fsel["label"][fsel["label"] >= 0]
    assert np.all(flags[got])


def test_sq_scan_covers_nonpow2_capacity_tail(catalog):
    """Corpus capacities above 2^20 rows grow in 1M-row steps and are NOT
    powers of two; the SQ scan loops cap//chunk steps, and a chunk that
    does not divide cap silently skipped the tail rows (cap=3*2^20 with
    chunk=2^21 scanned only the first 2/3 of the corpus).  Queries drawn
    from the tail must find themselves, on both the decode and the int8
    paths."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(13)
    n, d = 2_400_000, 4
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("sqt", d, "SQ8", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "sqt", catalog=catalog)
    idx = catalog.get("sqt").index
    cap = idx._capacity()
    assert cap & (cap - 1) != 0, f"test needs a non-pow2 capacity, got {cap}"
    xq = xb[n - 128:]                     # tail rows (beyond 2^21)
    res = dfx.faiss_search("sqt", 1, xq, catalog=catalog)   # decode path
    want = np.arange(n - 128, n)
    assert (res["label"][:, 0] == want).mean() > 0.95   # SQ8 quant ties
    dfx.set_precision("fast")
    try:
        res8 = dfx.faiss_search("sqt", 1, xq, catalog=catalog)  # int8 path
    finally:
        dfx.set_precision("parity")
    # d=4 with 2.4M rows is an extreme near-tie regime (margins ~1e-4, at
    # the int8 query-quantization noise floor), so exact agreement with
    # the decode path is not guaranteed here — tail VISIBILITY is what
    # this test pins: every query comes from the tail and must find
    # itself (distance 0 beats any noise).
    assert (res8["label"][:, 0] == want).mean() > 0.95


def test_pq_scan_covers_nonpow2_capacity_tail(catalog):
    """Same non-pow2-capacity tail guard for the PQ scan (pq_search loops
    cap // chunk steps too)."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(14)
    n, d = 2_400_000, 8
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("pqt", d, "PQ2", metric_type="L2", catalog=catalog)
    dfx.faiss_manual_train(xb[:20000], "pqt", catalog=catalog)
    dfx.faiss_add(xb, "pqt", catalog=catalog)
    idx = catalog.get("pqt").index
    cap = idx._capacity()
    assert cap & (cap - 1) != 0, f"test needs a non-pow2 capacity, got {cap}"
    xq = xb[n - 64:]
    res = dfx.faiss_search("pqt", 32, xq, catalog=catalog)
    # PQ2 at d=8 is very lossy — tail VISIBILITY is the invariant: results
    # must include rows beyond the last pow2 chunk boundary.
    assert (res["label"] >= 1 << 21).any(), \
        "no results from the tail region — chunk loop skipped it"


def test_sq8_int8_edge_cases(catalog):
    """Int8 scan degenerate inputs: constant dimensions (scale → 0 clamp)
    and all-zero queries (su → 0 clamp) agree with the decode path."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(3)
    xb = rng.standard_normal((3000, 32)).astype(np.float32)
    xb[:, 5] = 7.0
    xb[:, 20] = -3.0
    dfx.faiss_create("sq8e", 32, "SQ8", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "sq8e", catalog=catalog)
    zq = np.zeros((2, 32), np.float32)
    ref = dfx.faiss_search("sq8e", 10, xb[:16], catalog=catalog)
    refz = dfx.faiss_search("sq8e", 5, zq, catalog=catalog)
    dfx.set_precision("fast")
    try:
        fast = dfx.faiss_search("sq8e", 10, xb[:16], catalog=catalog)
        fz = dfx.faiss_search("sq8e", 5, zq, catalog=catalog)
    finally:
        dfx.set_precision("parity")
    np.testing.assert_array_equal(ref["label"], fast["label"])
    np.testing.assert_array_equal(refz["label"], fz["label"])
