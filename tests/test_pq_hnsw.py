"""PQ and HNSW-surface index tests."""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx

RNG = np.random.default_rng(11)


def _clustered(n, d, ncl=16):
    centers = RNG.standard_normal((ncl, d)).astype(np.float32) * 5
    a = RNG.integers(0, ncl, n)
    return (centers[a] + RNG.standard_normal((n, d)).astype(np.float32) * 0.2)


def test_pq_recall_on_clustered_data(catalog):
    d, n, nq, k = 16, 2000, 8, 10
    xb = _clustered(n, d)
    xq = _clustered(nq, d)
    dfx.faiss_create("pq", d, "PQ4", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "pq", catalog=catalog)
    dfx.faiss_create("flat", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "flat", catalog=catalog)
    rp = dfx.faiss_search("pq", k, xq, catalog=catalog)
    rf = dfx.faiss_search("flat", k, xq, catalog=catalog)
    recall = np.mean([
        len(set(rp["label"][q]) & set(rf["label"][q])) / k for q in range(nq)])
    assert recall >= 0.5, recall
    # Distances are to reconstructions: nonnegative and finite.
    assert np.isfinite(rp["distance"]).all()


def test_pq_self_search(catalog):
    d = 8
    xb = _clustered(600, d)
    dfx.faiss_create("pqs", d, "PQ2", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "pqs", catalog=catalog)
    res = dfx.faiss_search("pqs", 1, xb[:8], catalog=catalog)
    # Codes collide, but each vector's nearest reconstruction should be very
    # close to its own cell's distance; sanity: nearest distance small.
    assert (res["distance"][:, 0] < 5.0).all()


def test_pq_dim_not_divisible(catalog):
    with pytest.raises(dfx.InvalidInputError, match="multiple of"):
        dfx.faiss_create("bad", 10, "PQ3", metric_type="L2", catalog=catalog)


def test_pq_unsupported_metric(catalog):
    with pytest.raises(dfx.InvalidInputError, match="only L2 and"):
        dfx.faiss_create("bad", 8, "PQ2", metric_type="L1", catalog=catalog)


def test_pq_save_load(catalog, tmp_path):
    d = 8
    xb = _clustered(400, d)
    dfx.faiss_create("pq", d, "PQ2", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "pq", catalog=catalog)
    a = dfx.faiss_search("pq", 3, xb[:2], catalog=catalog)
    p = str(tmp_path / "pq.dfx")
    dfx.faiss_save("pq", p, catalog=catalog)
    dfx.faiss_load("pq2", p, catalog=catalog)
    b = dfx.faiss_search("pq2", 3, xb[:2], catalog=catalog)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-6)


def test_hnsw_exact_results(catalog):
    """HNSW surface with exact execution: results equal Flat (documented
    deviation: recall 1.0 ≥ reference HNSW)."""
    d, n = 8, 500
    xb = _clustered(n, d)
    xq = _clustered(4, d)
    dfx.faiss_create_params("h", d, "HNSW16", {"efConstruction": "32"},
                            metric_type="INNER_PRODUCT", catalog=catalog)
    dfx.faiss_add(xb, "h", catalog=catalog)
    dfx.faiss_create("f", d, "Flat", catalog=catalog)
    dfx.faiss_add(xb, "f", catalog=catalog)
    rh = dfx.faiss_search("h", 5, xq, {"efSearch": "64"}, catalog=catalog)
    rf = dfx.faiss_search("f", 5, xq, catalog=catalog)
    np.testing.assert_array_equal(rh["label"], rf["label"])


def test_hnsw_idmap_composite(catalog):
    """IDMap,HNSW128,Flat — the reference's benchmark index string
    (Makefile:93)."""
    d, n = 8, 300
    xb = _clustered(n, d)
    ids = np.arange(1000, 1000 + n)
    dfx.faiss_create("bench_idx", d, "IDMap,HNSW128,Flat",
                     metric_type="INNER_PRODUCT", catalog=catalog)
    dfx.faiss_add((ids, xb), "bench_idx", catalog=catalog)
    res = dfx.faiss_search("bench_idx", 3, xb[:2], catalog=catalog)
    assert (res["label"] >= 1000).all()


def test_hnsw_save_load_keeps_params(catalog, tmp_path):
    d = 8
    xb = _clustered(200, d)
    dfx.faiss_create_params("h", d, "HNSW16", {"efConstruction": "77"},
                            catalog=catalog)
    dfx.faiss_add(xb, "h", catalog=catalog)
    p = str(tmp_path / "h.dfx")
    dfx.faiss_save("h", p, catalog=catalog)
    dfx.faiss_load("h2", p, catalog=catalog)
    entry = catalog.get("h2")
    assert entry.index.ef_construction == 77


def test_sq8_close_to_exact(catalog):
    d, n, nq, k = 16, 1500, 6, 5
    xb = _clustered(n, d)
    xq = _clustered(nq, d)
    dfx.faiss_create("sq", d, "SQ8", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "sq", catalog=catalog)   # deferred train on first add
    dfx.faiss_create("fl", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "fl", catalog=catalog)
    rs = dfx.faiss_search("sq", k, xq, catalog=catalog)
    rf = dfx.faiss_search("fl", k, xq, catalog=catalog)
    recall = np.mean([len(set(rs["label"][q]) & set(rf["label"][q])) / k
                      for q in range(nq)])
    # Tightly clustered points sit within a few quantization steps of each
    # other, so some rank swaps are expected — recall stays high.
    assert recall >= 0.7, recall
    np.testing.assert_allclose(rs["distance"], rf["distance"],
                               rtol=0.2, atol=0.2)
    # Memory: one byte per dim.
    inner = catalog.get("sq").index
    assert inner._codes.dtype == np.uint8


def test_sqfp16_roundtrip(catalog, tmp_path):
    d = 8
    xb = _clustered(300, d)
    dfx.faiss_create("s16", d, "SQfp16", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "s16", catalog=catalog)  # no training needed
    a = dfx.faiss_search("s16", 3, xb[:2], catalog=catalog)
    assert a["label"][0, 0] == 0  # fp16 error ≪ inter-point L2 distance
    p = str(tmp_path / "s16.dfx")
    dfx.faiss_save("s16", p, catalog=catalog)
    dfx.faiss_load("s16b", p, catalog=catalog)
    b = dfx.faiss_search("s16b", 3, xb[:2], catalog=catalog)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-6)


def test_idmap_composites_with_codecs(catalog):
    """IDMap over PQ and SQ8: labeled adds with deferred training."""
    d, n = 16, 800
    xb = _clustered(n, d)
    ids = np.arange(n) * 7 + 3
    for name, desc in [("ipq", "IDMap,PQ4"), ("isq", "IDMap,SQ8")]:
        dfx.faiss_create(name, d, desc, metric_type="L2", catalog=catalog)
        dfx.faiss_add((ids, xb), name, catalog=catalog)
        res = dfx.faiss_search(name, 3, xb[:4], catalog=catalog)
        assert res.shape == (4, 3)
        # labels come from the custom id space
        valid = res["label"][res["label"] >= 0]
        assert ((valid - 3) % 7 == 0).all(), desc


def test_idmap2_reconstruct(catalog):
    """IDMap2 surface: reconstruct by label (faiss IndexIDMap2 semantics)."""
    d = 8
    xb = _clustered(100, d)
    ids = np.arange(100) + 1000
    dfx.faiss_create("im2", d, "IDMap2,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add((ids, xb), "im2", catalog=catalog)
    inner = catalog.get("im2").index
    rec = inner.reconstruct(1005)
    np.testing.assert_allclose(rec, xb[5], rtol=1e-6)


def test_hnsw_ivf_acceleration(catalog):
    """With accel=ivf, at scale HNSW lowers to an internal IVF partition
    (efSearch→nprobe); small corpora and {'exact': 'true'} keep the exact
    scan."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(50)
    d, n = 16, 6000
    centers = rng.standard_normal((32, d)).astype(np.float32) * 4
    xb = centers[rng.integers(0, 32, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * 0.3
    xq = xb[:10]
    dfx.faiss_create_params("hacc", d, "HNSW32", {"accel": "ivf"},
                            metric_type="L2", catalog=catalog)
    idx = catalog.get("hacc").index
    idx.ann_threshold = 1000          # force the ANN regime at test scale
    dfx.faiss_add(xb, "hacc", catalog=catalog)

    exact = dfx.faiss_search("hacc", 5, xq, {"exact": "true"},
                             catalog=catalog)
    approx = dfx.faiss_search("hacc", 5, xq, {"efSearch": "64"},
                              catalog=catalog)
    assert idx._accel is not None     # partition was built
    # clustered data + efSearch 64 → nprobe 16 of 128 lists: self-hits hold
    assert np.all(approx["label"][:, 0] == np.arange(10))
    recall = np.mean([len(set(approx["label"][q]) & set(exact["label"][q]))
                      for q in range(10)]) / 5
    assert recall > 0.9

    # Tail rows added after the build are found without a rebuild.
    extra = centers[:1] + rng.standard_normal((10, d)).astype(np.float32) * .1
    dfx.faiss_add(extra, "hacc", catalog=catalog)
    accel_before = idx._accel
    res = dfx.faiss_search("hacc", 3, extra, {"efSearch": "64"},
                           catalog=catalog)
    assert idx._accel is accel_before  # no rebuild for a small tail
    assert np.all(res["label"][:, 0] >= n)  # each finds its tail self-hit

    # Growing the tail past the threshold rebuilds the partition.
    more = rng.standard_normal((3000, d)).astype(np.float32)
    dfx.faiss_add(more, "hacc", catalog=catalog)
    dfx.faiss_search("hacc", 3, xq[:2], catalog=catalog)
    assert idx._accel is not accel_before
    assert idx._accel[1] == idx.ntotal


def test_hnsw_accel_selector(catalog):
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(51)
    d, n = 8, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create_params("hsel", d, "HNSW16", {"accel": "ivf"},
                            metric_type="L2", catalog=catalog)
    idx = catalog.get("hsel").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hsel", catalog=catalog)
    dfx.faiss_add(xb[:200] + 0.001, "hsel", catalog=catalog)  # tail rows
    sel = dfx.SetSelector(np.arange(0, n + 200, 3, dtype=np.int64))
    res = dfx.faiss_search("hsel", 5, xb[:6], {"efSearch": "512"},
                           catalog=catalog, selector=sel)
    assert np.all(res["label"] % 3 == 0)


def test_hnsw_accel_save_load(catalog, tmp_path):
    """The partition persists through save/load (no k-means on load)."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(52)
    d, n = 8, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create_params("hsl", d, "HNSW16", {"accel": "ivf"},
                            metric_type="L2", catalog=catalog)
    idx = catalog.get("hsl").index
    idx.ann_threshold = 1000
    dfx.faiss_add(xb, "hsl", catalog=catalog)
    before = dfx.faiss_search("hsl", 5, xb[:6], {"efSearch": "256"},
                              catalog=catalog)
    assert idx._accel is not None
    path = str(tmp_path / "hnsw.idx")
    dfx.faiss_save("hsl", path, catalog=catalog)
    dfx.faiss_load("hsl2", path, catalog=catalog)
    idx2 = catalog.get("hsl2").index
    assert idx2._accel is not None          # restored, not retrained
    np.testing.assert_array_equal(idx2._accel[0]._assign,
                                  idx._accel[0]._assign)
    idx2.ann_threshold = 1000
    after = dfx.faiss_search("hsl2", 5, xb[:6], {"efSearch": "256"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=1e-5, atol=1e-5)


def test_nsg_surface(catalog):
    """NSG factory strings (NSG / NSG64 / NSG64,SQ8) execute with the same
    device lowering as HNSW; search_L is the pool knob (faiss IndexNSG)."""
    d, n = 8, 400
    xb = _clustered(n, d)
    xq = _clustered(4, d)
    dfx.faiss_create("nsg", d, "NSG32", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "nsg", catalog=catalog)
    dfx.faiss_create("nsgf", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "nsgf", catalog=catalog)
    rn = dfx.faiss_search("nsg", 5, xq, {"search_L": "64"}, catalog=catalog)
    rf = dfx.faiss_search("nsgf", 5, xq, catalog=catalog)
    np.testing.assert_array_equal(rn["label"], rf["label"])
    from duckdb_faiss_ext_tpu.models.hnsw import NSGIndex

    ix = catalog.get("nsg").index
    assert isinstance(ix, NSGIndex)
    assert ix.ef_search == 64  # search_L latched


def test_nsg_save_load(catalog, tmp_path):
    d, n = 8, 300
    xb = _clustered(n, d)
    dfx.faiss_create("nsgsv", d, "NSG64,SQ8", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "nsgsv", catalog=catalog)
    before = dfx.faiss_search("nsgsv", 3, xb[:5], catalog=catalog)
    path = str(tmp_path / "nsg.idx")
    dfx.faiss_save("nsgsv", path, catalog=catalog)
    dfx.faiss_load("nsgsv2", path, catalog=catalog)
    after = dfx.faiss_search("nsgsv2", 3, xb[:5], catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])


def test_pq_anisotropic_eta_one_is_kmeans():
    """eta=1 reduces the score-aware loss exactly to k-means: same
    codebooks as the plain trainer."""
    from duckdb_faiss_ext_tpu.ops.pq import pq_train, pq_train_anisotropic

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    cb0 = np.asarray(pq_train(x, 4, 16))
    cb1 = np.asarray(pq_train_anisotropic(x, 4, 16, eta=1.0))
    np.testing.assert_allclose(cb0, cb1, rtol=1e-5, atol=1e-5)


def test_pq_anisotropic_improves_ip_recall(catalog):
    """ScaNN-style score-aware quantization: eta>1 yields higher
    inner-product recall@10 than plain k-means PQ at the same code budget
    (training AND encoding both use the weighted loss)."""
    rng = np.random.default_rng(1)
    ncl, d, n, nq = 64, 32, 12000, 128
    centers = rng.standard_normal((ncl, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    xb = (centers[rng.integers(0, ncl, n)] * 2.0
          + rng.standard_normal((n, d)).astype(np.float32) * 0.35)
    xq = (centers[rng.integers(0, ncl, nq)] * 2.0
          + rng.standard_normal((nq, d)).astype(np.float32) * 0.35)
    truth = np.argsort(-(xq @ xb.T), axis=1)[:, :10]

    def recall(name, params):
        dfx.faiss_create_params(name, d, "PQ8", params,
                                metric_type="INNER_PRODUCT",
                                catalog=catalog)
        dfx.faiss_add(xb, name, catalog=catalog)
        got = dfx.faiss_search(name, 10, xq, catalog=catalog)["label"]
        return np.mean([len(set(g) & set(t)) / 10
                        for g, t in zip(got, truth)])

    r_plain = recall("pqplain", {})
    r_aniso = recall("pqaniso", {"anisotropic_eta": "4.0"})
    assert r_aniso > r_plain, (r_aniso, r_plain)


def test_pq_anisotropic_save_load(catalog, tmp_path):
    rng = np.random.default_rng(4)
    d, n = 16, 2000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create_params("pqan", d, "PQ4", {"anisotropic_eta": "3.0"},
                            metric_type="INNER_PRODUCT", catalog=catalog)
    dfx.faiss_add(xb, "pqan", catalog=catalog)
    before = dfx.faiss_search("pqan", 4, xb[:5], catalog=catalog)
    path = str(tmp_path / "pqan.idx")
    dfx.faiss_save("pqan", path, catalog=catalog)
    dfx.faiss_load("pqan2", path, catalog=catalog)
    ix = catalog.get("pqan2").index
    assert ix.aniso_eta == 3.0
    after = dfx.faiss_search("pqan2", 4, xb[:5], catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    with pytest.raises(dfx.errors.InvalidInputError, match=">= 1.0"):
        dfx.faiss_create_params("pqbad", d, "PQ4",
                                {"anisotropic_eta": "0.5"},
                                catalog=catalog)
    with pytest.raises(dfx.errors.InvalidInputError, match="PQ codebooks"):
        dfx.faiss_create_params("rqbad", d, "RQ2x4",
                                {"anisotropic_eta": "2.0"},
                                catalog=catalog)


def test_ivfpq_anisotropic_improves_ip_recall(catalog):
    """anisotropic_eta on IVFn,PQm: residual codebooks trained/encoded with
    the ORIGINAL datapoint as the anisotropy axis (ScaNN residual AVQ)."""
    rng = np.random.default_rng(2)
    ncl, d, n, nq = 64, 32, 12000, 128
    centers = rng.standard_normal((ncl, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    xb = (centers[rng.integers(0, ncl, n)] * 2.0
          + rng.standard_normal((n, d)).astype(np.float32) * 0.35)
    xq = (centers[rng.integers(0, ncl, nq)] * 2.0
          + rng.standard_normal((nq, d)).astype(np.float32) * 0.35)
    truth = np.argsort(-(xq @ xb.T), axis=1)[:, :10]

    def recall(name, params):
        dfx.faiss_create_params(name, d, "IVF16,PQ8", params,
                                metric_type="INNER_PRODUCT",
                                catalog=catalog)
        dfx.faiss_add(xb, name, catalog=catalog)
        got = dfx.faiss_search(name, 10, xq, {"nprobe": "16"},
                               catalog=catalog)["label"]
        return np.mean([len(set(g) & set(t)) / 10
                        for g, t in zip(got, truth)])

    r_plain = recall("ivfplain", {})
    r_aniso = recall("ivfaniso", {"anisotropic_eta": "4.0"})
    # Deterministic seeds: measured 0.616 -> 0.639 on this setup.
    assert r_aniso > r_plain, (r_aniso, r_plain)
    with pytest.raises(dfx.errors.InvalidInputError, match="PQ storage"):
        dfx.faiss_create_params("ivfsqan", d, "IVF4,SQ8",
                                {"anisotropic_eta": "2.0"},
                                catalog=catalog)


def test_hnsw_accel_soar(catalog, tmp_path):
    """soar_lambda on the HNSW surface: the internal IVF partition uses
    SOAR dual assignment — higher recall per efSearch at 2x partition
    storage; persists through save/load."""
    rng = np.random.default_rng(41)
    d, n = 24, 30000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    xq = rng.standard_normal((64, d)).astype(np.float32)
    dfx.faiss_create("hso_oracle", d, "Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "hso_oracle", catalog=catalog)
    truth = dfx.faiss_search("hso_oracle", 10, xq, catalog=catalog)["label"]

    def recall(name, params):
        params = dict(params, ann_threshold="10000")
        dfx.faiss_create_params(name, d, "HNSW32", params,
                                metric_type="L2", catalog=catalog)
        dfx.faiss_add(xb, name, catalog=catalog)
        got = dfx.faiss_search(name, 10, xq, {"efSearch": "32"},
                               catalog=catalog)["label"]
        for row in got:
            live = row[row >= 0]
            assert len(set(live)) == len(live)
        return np.mean([len(set(g) & set(t)) / 10
                        for g, t in zip(got, truth)])

    # The SOAR comparison is within the IVF partition: pin the plain
    # baseline to accel=ivf (the default graph walk would otherwise win
    # outright — 0.99 vs 0.66 recall on this workload).
    r_plain = recall("hsoplain", {"accel": "ivf"})
    r_soar = recall("hsosoar", {"soar_lambda": "1.0"})
    assert r_soar > r_plain, (r_soar, r_plain)

    path = str(tmp_path / "hso.idx")
    before = dfx.faiss_search("hsosoar", 5, xq[:6], {"efSearch": "32"},
                              catalog=catalog)
    dfx.faiss_save("hsosoar", path, catalog=catalog)
    dfx.faiss_load("hsosoar2", path, catalog=catalog)
    after = dfx.faiss_search("hsosoar2", 5, xq[:6], {"efSearch": "32"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
