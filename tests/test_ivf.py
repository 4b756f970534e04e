"""IVF: training semantics, exactness vs flat oracle, filters, persistence."""

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx

RNG = np.random.default_rng(5)


def _clustered(n, d, ncl=8):
    centers = RNG.standard_normal((ncl, d)).astype(np.float32) * 5
    a = RNG.integers(0, ncl, n)
    return (centers[a] + RNG.standard_normal((n, d)).astype(np.float32) * 0.3)


def test_ivf_full_probe_matches_flat(catalog):
    d, n, nq, k = 16, 500, 6, 5
    xb = _clustered(n, d)
    xq = _clustered(nq, d)
    dfx.faiss_create("ivf", d, "IVF8,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivf", catalog=catalog)  # deferred train then add
    dfx.faiss_create("flat", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "flat", catalog=catalog)

    rf = dfx.faiss_search("flat", k, xq, catalog=catalog)
    ri = dfx.faiss_search("ivf", k, xq, {"nprobe": "8"}, catalog=catalog)
    # Probing every list ⇒ identical results to exact flat search.
    np.testing.assert_array_equal(ri["label"], rf["label"])
    np.testing.assert_allclose(ri["distance"], rf["distance"], rtol=1e-5)


def test_ivf_nprobe_subset_recall(catalog):
    d, n, nq, k = 16, 2000, 8, 10
    xb = _clustered(n, d, ncl=16)
    xq = _clustered(nq, d, ncl=16)
    dfx.faiss_create("ivf", d, "IVF16,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivf", catalog=catalog)
    dfx.faiss_create("flat", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "flat", catalog=catalog)

    rf = dfx.faiss_search("flat", k, xq, catalog=catalog)
    r4 = dfx.faiss_search("ivf", k, xq, {"nprobe": "4"}, catalog=catalog)
    recall = np.mean([
        len(set(r4["label"][q]) & set(rf["label"][q])) / k
        for q in range(nq)])
    assert recall >= 0.8, recall
    # Determinism under fixed seed: run again, identical candidates.
    r4b = dfx.faiss_search("ivf", k, xq, {"nprobe": "4"}, catalog=catalog)
    np.testing.assert_array_equal(r4["label"], r4b["label"])


def test_ivf_too_few_training_points(catalog):
    dfx.faiss_create("big", 8, "IVF64,Flat", catalog=catalog)
    with pytest.raises(dfx.InvalidInputError) as exc:
        dfx.faiss_add(RNG.random((10, 8), dtype=np.float32), "big",
                      catalog=catalog)
    msg = str(exc.value)
    assert msg.startswith(
        "Index big needs to be trained, but amount of datapoints is too "
        "small. Considere adding more data.")
    assert "at least as large as number of clusters (64)" in msg
    # Adding more data afterwards succeeds (staging retained the batch? No —
    # the failed batch was rolled back; a big-enough batch works).
    dfx.faiss_add(RNG.random((128, 8), dtype=np.float32), "big",
                  catalog=catalog)


def test_idmap_ivf1_add_with_ids(catalog):
    """faiss_add_ids_with_train copy.test: IDMap,IVF1,Flat single labeled row."""
    dfx.faiss_create("demo_index", 2, "IDMap,IVF1,Flat", catalog=catalog)
    dfx.faiss_add((np.array([231]),
                   np.array([[0.0040321066, 0.023423655]], np.float32)),
                  "demo_index", catalog=catalog)
    res = dfx.faiss_search("demo_index", 1,
                           np.array([[0.0, 0.02]], np.float32),
                           catalog=catalog)
    assert res["label"][0, 0] == 231


def test_ivf_manual_train_then_add(catalog):
    d = 8
    xb = _clustered(600, d)
    dfx.faiss_create("mt", d, "IVF4,Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_manual_train(xb[:300], "mt", catalog=catalog)
    dfx.faiss_add(xb, "mt", catalog=catalog)
    res = dfx.faiss_search("mt", 3, xb[:2], {"nprobe": "4"}, catalog=catalog)
    # Nearest neighbour of a database vector is itself at distance 0.
    assert res["label"][0, 0] == 0
    np.testing.assert_allclose(res["distance"][0, 0], 0.0, atol=1e-4)


def test_ivf_save_load_roundtrip(catalog, tmp_path):
    d = 8
    xb = _clustered(400, d)
    xq = _clustered(3, d)
    dfx.faiss_create("ivf", d, "IVF4,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivf", catalog=catalog)
    a = dfx.faiss_search("ivf", 4, xq, {"nprobe": "4"}, catalog=catalog)
    p = str(tmp_path / "ivf.dfx")
    dfx.faiss_save("ivf", p, catalog=catalog)
    dfx.faiss_load("ivf2", p, catalog=catalog)
    b = dfx.faiss_search("ivf2", 4, xq, {"nprobe": "4"}, catalog=catalog)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-6)
    # Loaded trained index is immutable.
    with pytest.raises(dfx.InvalidInputError, match="immutable"):
        dfx.faiss_add(xb, "ivf2", catalog=catalog)


def test_ivf_filtered_search(catalog):
    d, n = 8, 500
    xb = _clustered(n, d)
    ids = np.arange(n)
    dfx.faiss_create("ivff", d, "IDMap,IVF4,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add((ids, xb), "ivff", catalog=catalog)
    db = dfx.Database()
    db.register("t", {"id": ids})
    res = dfx.faiss_search_filter("ivff", 5, xb[:4], "id%2==0", "id", "t",
                                  {"nprobe": "4"}, catalog=catalog,
                                  database=db)
    valid = res["label"][res["label"] >= 0]
    assert (valid % 2 == 0).all()


def test_ivf_quantiser_params_accepted(catalog):
    """IVFn_HNSWm,Flat with quantiser.efSearch param parses and runs
    (src/faiss_extension.cpp:680-683 recursion)."""
    d = 8
    xb = _clustered(600, d)
    dfx.faiss_create("ivfh", d, "IVF4_HNSW8,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivfh", catalog=catalog)
    res = dfx.faiss_search("ivfh", 3, xb[:2],
                           {"nprobe": "2", "quantiser.efSearch": "64"},
                           catalog=catalog)
    assert res["label"][0, 0] == 0


def test_ivfpq_recall_and_roundtrip(catalog, tmp_path):
    """IVFn,PQm — residual-encoded lists (faiss IndexIVFPQ analogue)."""
    d, n, nq, k = 16, 3000, 8, 10
    xb = _clustered(n, d, ncl=16)
    xq = _clustered(nq, d, ncl=16)
    dfx.faiss_create("ivfpq", d, "IVF8,PQ4", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivfpq", catalog=catalog)
    dfx.faiss_create("flat", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "flat", catalog=catalog)
    rf = dfx.faiss_search("flat", k, xq, catalog=catalog)
    rp = dfx.faiss_search("ivfpq", k, xq, {"nprobe": "8"}, catalog=catalog)
    recall = np.mean([
        len(set(rp["label"][q]) & set(rf["label"][q])) / k
        for q in range(nq)])
    assert recall >= 0.4, recall
    # Memory profile: codes stored, raw vectors absent.
    entry = catalog.get("ivfpq")
    inner = entry.index
    assert inner._codes.shape == (n, 4)
    assert inner._xb.shape[0] == 0
    # Save/load roundtrip preserves results.
    p = str(tmp_path / "ivfpq.dfx")
    dfx.faiss_save("ivfpq", p, catalog=catalog)
    dfx.faiss_load("ivfpq2", p, catalog=catalog)
    rp2 = dfx.faiss_search("ivfpq2", k, xq, {"nprobe": "8"}, catalog=catalog)
    np.testing.assert_array_equal(rp["label"], rp2["label"])


def test_ivf_elementwise_metric(catalog):
    """IVF with a non-MXU metric goes through the gather path for all nine
    metrics (L1 here) and matches the flat oracle at full probe."""
    d, n, nq, k = 8, 400, 4, 5
    xb = _clustered(n, d)
    xq = _clustered(nq, d)
    dfx.faiss_create("ivl1", d, "IVF4,Flat", metric_type="L1",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivl1", catalog=catalog)
    dfx.faiss_create("fl1", d, "Flat", metric_type="L1", catalog=catalog)
    dfx.faiss_add(xb, "fl1", catalog=catalog)
    ri = dfx.faiss_search("ivl1", k, xq, {"nprobe": "4"}, catalog=catalog)
    rf = dfx.faiss_search("fl1", k, xq, catalog=catalog)
    np.testing.assert_allclose(ri["distance"], rf["distance"], rtol=1e-5)
    np.testing.assert_array_equal(ri["label"], rf["label"])


def test_errors_on_missing_index(catalog):
    for fn in (lambda: dfx.faiss_save("ghost", "/tmp/x", catalog=catalog),
               lambda: dfx.faiss_destroy("ghost", catalog=catalog),
               lambda: dfx.faiss_add(np.zeros((1, 4), np.float32), "ghost",
                                     catalog=catalog),
               lambda: dfx.faiss_manual_train(np.zeros((4, 4), np.float32),
                                              "ghost", catalog=catalog),
               lambda: dfx.faiss_search("ghost", 1,
                                        np.zeros((1, 4), np.float32),
                                        catalog=catalog)):
        with pytest.raises(dfx.InvalidInputError,
                           match="Could not find index ghost."):
            fn()


def test_ivf_sq_encodings(catalog):
    """IVFn,SQ8/SQ4/SQfp16: scalar-quantized list storage (faiss
    IndexIVFScalarQuantizer, by_residual=false)."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(60)
    d, n = 16, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    for enc, err in (("SQ8", 0.05), ("SQ4", 1.0), ("SQfp16", 1e-3)):
        name = "ivfsq" + enc
        dfx.faiss_create(name, d, f"IVF8,{enc}", metric_type="L2",
                         catalog=catalog)
        dfx.faiss_add(xb, name, catalog=catalog)
        res = dfx.faiss_search(name, 5, xb[:6], {"nprobe": "8"},
                               catalog=catalog)
        assert np.all(res["label"][:, 0] == np.arange(6)), enc
        assert np.all(res["distance"][:, 0] < err), enc


def test_ivf_sq_save_load(catalog, tmp_path):
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(61)
    xb = rng.standard_normal((2000, 9)).astype(np.float32)  # odd dim
    dfx.faiss_create("ivfsqs", 9, "IVF4,SQ4", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivfsqs", catalog=catalog)
    before = dfx.faiss_search("ivfsqs", 4, xb[:5], {"nprobe": "4"},
                              catalog=catalog)
    path = str(tmp_path / "ivfsq.idx")
    dfx.faiss_save("ivfsqs", path, catalog=catalog)
    dfx.faiss_load("ivfsql", path, catalog=catalog)
    after = dfx.faiss_search("ivfsql", 4, xb[:5], {"nprobe": "4"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"])


def test_ivf_sq_range_and_filter(catalog):
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(62)
    d, n = 8, 1500
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("ivfsqr", d, "IVF4,SQ8", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "ivfsqr", catalog=catalog)
    sel = dfx.SetSelector(np.arange(0, n, 2, dtype=np.int64))
    res = dfx.faiss_search("ivfsqr", 5, xb[:4], {"nprobe": "4"},
                           catalog=catalog, selector=sel)
    assert np.all(res["label"] % 2 == 0)
    r = dfx.faiss_range_search("ivfsqr", 5.0, xb[:3], {"nprobe": "4"},
                               catalog=catalog)
    for q in range(3):
        seg = r["label"][r["lims"][q]:r["lims"][q + 1]]
        assert q in seg


def test_idmap2_ivfpq_reconstruct(catalog):
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(63)
    d, n = 16, 2000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) * 3 + 1
    dfx.faiss_create("r2", d, "IDMap2,IVF8,PQ4", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add((ids, xb), "r2", catalog=catalog)
    rec = catalog.get("r2").index.reconstruct(int(ids[7]))
    # PQ reconstruction error is bounded, not exact
    assert np.linalg.norm(rec - xb[7]) < 0.5 * np.linalg.norm(xb[7])


def _imi_clustered(n, d, ncent=16, seed=11, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncent, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, ncent, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def test_imi_full_probe_matches_flat(catalog):
    """IMI2x3 (64 cells) probed fully is exact — parity with Flat."""
    d, n = 16, 1500
    xb = _imi_clustered(n, d)
    dfx.faiss_create("imif", d, "IMI2x3,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_create("imioracle", d, "Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "imif", catalog=catalog)
    dfx.faiss_add(xb, "imioracle", catalog=catalog)
    a = dfx.faiss_search("imif", 6, xb[:10], {"nprobe": "64"},
                         catalog=catalog)
    b = dfx.faiss_search("imioracle", 6, xb[:10], catalog=catalog)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"],
                               rtol=1e-4, atol=1e-4)


def test_imi_trains_below_nlist(catalog):
    """The IMI advantage: 256 cells (2x4) train from only >= 16 points per
    half codebook — a plain IVF256 would refuse this corpus."""
    d = 8
    xb = _imi_clustered(120, d, ncent=8, seed=12)
    dfx.faiss_create("imismall", d, "IMI2x4,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "imismall", catalog=catalog)   # n=120 < nlist=256
    res = dfx.faiss_search("imismall", 3, xb[:5], {"nprobe": "256"},
                           catalog=catalog)
    assert (res["label"][:, 0] == np.arange(5)).all()


def test_imi_too_few_points(catalog):
    d = 8
    dfx.faiss_create("imitiny", d, "IMI2x4,Flat", metric_type="L2",
                     catalog=catalog)
    with pytest.raises(dfx.errors.InvalidInputError,
                       match="too small"):
        dfx.faiss_add(np.random.default_rng(0).standard_normal(
            (10, d)).astype(np.float32), "imitiny", catalog=catalog)


def test_imi_partial_probe_recall(catalog):
    d, n = 16, 4000
    xb = _imi_clustered(n, d, ncent=32, seed=13)
    dfx.faiss_create("imir", d, "IMI2x4,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_create("imiro", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "imir", catalog=catalog)
    dfx.faiss_add(xb, "imiro", catalog=catalog)
    xq = xb[:64]
    truth = dfx.faiss_search("imiro", 10, xq, catalog=catalog)["label"]
    got = dfx.faiss_search("imir", 10, xq, {"nprobe": "32"},
                           catalog=catalog)["label"]
    hits = sum(len(set(g) & set(t)) for g, t in zip(got, truth))
    assert hits / truth.size > 0.8, hits / truth.size


def test_imi_pq_encoding_and_roundtrip(catalog, tmp_path):
    d, n = 16, 3000
    xb = _imi_clustered(n, d, ncent=16, seed=14)
    dfx.faiss_create("imipq", d, "IMI2x3,PQ8", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "imipq", catalog=catalog)
    before = dfx.faiss_search("imipq", 5, xb[:8], {"nprobe": "64"},
                              catalog=catalog)
    assert (before["label"][:, 0] == np.arange(8)).sum() >= 6
    path = str(tmp_path / "imi.idx")
    dfx.faiss_save("imipq", path, catalog=catalog)
    dfx.faiss_load("imipq2", path, catalog=catalog)
    after = dfx.faiss_search("imipq2", 5, xb[:8], {"nprobe": "64"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=1e-5, atol=1e-5)


def test_imi_guards(catalog):
    with pytest.raises(dfx.errors.InvalidInputError, match="even"):
        dfx.faiss_create("imiodd", 15, "IMI2x4,Flat", catalog=catalog)
    with pytest.raises(dfx.errors.InvalidInputError, match="cell table"):
        dfx.faiss_create("imibig", 1536, "IMI2x12,Flat", catalog=catalog)
    with pytest.raises(dfx.errors.InvalidInputError, match="metric"):
        dfx.faiss_create("imil1", 16, "IMI2x4,Flat", metric_type="L1",
                         catalog=catalog)


# --- SOAR (spilled orthogonality-amplified residual assignment) -----------

def _soar_data(n, d, ncent, seed, spread=0.45):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((ncent, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, ncent, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * spread)


def test_soar_improves_recall_at_fixed_nprobe(catalog):
    """SOAR dual assignment: each row also joins a second list with
    near-orthogonal residual, so low-nprobe recall rises vs plain IVF."""
    d, n, nq = 24, 8000, 96
    xb = _soar_data(n, d, ncent=64, seed=31)
    xq = _soar_data(nq, d, ncent=64, seed=32)
    dfx.faiss_create("soar_oracle", d, "Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "soar_oracle", catalog=catalog)
    truth = dfx.faiss_search("soar_oracle", 10, xq,
                             catalog=catalog)["label"]

    def recall(name, params):
        dfx.faiss_create_params(name, d, "IVF64,Flat", params,
                                metric_type="L2", catalog=catalog)
        dfx.faiss_add(xb, name, catalog=catalog)
        got = dfx.faiss_search(name, 10, xq, {"nprobe": "4"},
                               catalog=catalog)["label"]
        return np.mean([len(set(g) & set(t)) / 10
                        for g, t in zip(got, truth)])

    r_plain = recall("ivfplainq", {})
    r_soar = recall("ivfsoarq", {"soar_lambda": "1.0"})
    assert r_soar > r_plain, (r_soar, r_plain)
    # No duplicate labels in any result row.
    got = dfx.faiss_search("ivfsoarq", 10, xq, {"nprobe": "8"},
                           catalog=catalog)["label"]
    for row in got:
        live = row[row >= 0]
        assert len(set(live)) == len(live)


def test_soar_full_probe_matches_flat(catalog):
    """Probing every list with SOAR still returns the exact top-k (the
    duplicate copies dedup away)."""
    d, n = 16, 1000
    xb = _soar_data(n, d, ncent=8, seed=33)
    dfx.faiss_create_params("soarx", d, "IVF8,Flat",
                            {"soar_lambda": "1.5"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add(xb, "soarx", catalog=catalog)
    dfx.faiss_create("soarf", d, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "soarf", catalog=catalog)
    a = dfx.faiss_search("soarx", 5, xb[:8], {"nprobe": "8"},
                         catalog=catalog)
    b = dfx.faiss_search("soarf", 5, xb[:8], catalog=catalog)
    np.testing.assert_array_equal(a["label"], b["label"])
    np.testing.assert_allclose(a["distance"], b["distance"],
                               rtol=1e-4, atol=1e-4)


def test_soar_batched_and_roundtrip(catalog, tmp_path):
    d, n = 16, 2000
    xb = _soar_data(n, d, ncent=16, seed=34)
    ids = np.arange(n, dtype=np.int64) + 100
    dfx.faiss_create_params("soarb", d, "IDMap,IVF16,Flat",
                            {"soar_lambda": "1.0"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add((ids, xb), "soarb", catalog=catalog)
    seq = dfx.faiss_search("soarb", 5, xb[:12], {"nprobe": "4"},
                           catalog=catalog)
    bat = dfx.faiss_search_batched("soarb", 5, xb[:12], {"nprobe": "4"},
                                   batch_size=4, catalog=catalog)
    np.testing.assert_array_equal(seq["label"], bat["label"])
    np.testing.assert_allclose(seq["distance"], bat["distance"],
                               rtol=1e-5, atol=1e-6)
    path = str(tmp_path / "soar.idx")
    dfx.faiss_save("soarb", path, catalog=catalog)
    dfx.faiss_load("soarb2", path, catalog=catalog)
    after = dfx.faiss_search("soarb2", 5, xb[:12], {"nprobe": "4"},
                             catalog=catalog)
    np.testing.assert_array_equal(seq["label"], after["label"])
    # Loaded index still dedups (soar_lambda persisted).
    for row in after["label"]:
        live = row[row >= 0]
        assert len(set(live)) == len(live)


def test_soar_range_dedup(catalog):
    d, n = 8, 600
    xb = _soar_data(n, d, ncent=8, seed=35, spread=0.3)
    dfx.faiss_create_params("soarr", d, "IVF8,Flat",
                            {"soar_lambda": "1.0"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add(xb, "soarr", catalog=catalog)
    res = dfx.faiss_range_search("soarr", 1.0, xb[:4], {"nprobe": "8"},
                                 catalog=catalog)
    lims, labels = res["lims"], res["label"]
    for q in range(4):
        seg = labels[lims[q]:lims[q + 1]]
        assert len(set(seg)) == len(seg)
        assert q in seg


def test_soar_sequential_labels_across_adds(catalog):
    """Review finding (confirmed): the duplicated storage rows must not
    leak into the sequential label space — the second faiss_add's labels
    continue at n, not 2n, and ntotal reports logical datapoints."""
    d = 8
    xb1 = _soar_data(200, d, ncent=4, seed=36)
    xb2 = _soar_data(200, d, ncent=4, seed=37)
    dfx.faiss_create_params("soarseq", d, "IVF4,Flat",
                            {"soar_lambda": "1.0"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add(xb1, "soarseq", catalog=catalog)
    dfx.faiss_add(xb2, "soarseq", catalog=catalog)
    ix = catalog.get("soarseq").index
    assert ix.ntotal == 400
    # Searching for a row of the second batch returns its logical label.
    res = dfx.faiss_search("soarseq", 1, xb2[:5], {"nprobe": "4"},
                           catalog=catalog)
    np.testing.assert_array_equal(res["label"][:, 0],
                                  np.arange(200, 205))
    # reconstruct uses logical positions through the indirection.
    np.testing.assert_allclose(ix.reconstruct(200), xb2[0], rtol=1e-6)
    np.testing.assert_allclose(ix.reconstruct(0), xb1[0], rtol=1e-6)


def test_soar_keeps_genuine_duplicate_labels(catalog):
    """Review finding: dedup keys on the SOURCE row, so two DISTINCT
    vectors sharing a user label both stay in the results."""
    d = 8
    rng = np.random.default_rng(38)
    xb = rng.standard_normal((64, d)).astype(np.float32) * 3
    ids = np.arange(64, dtype=np.int64)
    ids[1] = ids[0]  # two distinct vectors, same label
    dfx.faiss_create_params("soardup", d, "IVF4,Flat",
                            {"soar_lambda": "1.0"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add((ids, xb), "soardup", catalog=catalog)
    q = ((xb[0] + xb[1]) / 2)[None, :]
    res = dfx.faiss_search("soardup", 64, q, {"nprobe": "4"},
                           catalog=catalog)
    labels = res["label"][0]
    assert (labels == ids[0]).sum() == 2  # both survivors
    assert (labels >= 0).sum() == 64


def test_soar_aniso_beam_persist_before_training(catalog, tmp_path):
    """Review finding: create params must survive an untrained save/load
    (the loaded-untrained index is still mutable and will train later)."""
    dfx.faiss_create_params("persisted", 16, "IVF4,PQ4",
                            {"anisotropic_eta": "3.0"}, catalog=catalog)
    path = str(tmp_path / "p1.idx")
    dfx.faiss_save("persisted", path, catalog=catalog)
    dfx.faiss_load("persisted2", path, catalog=catalog)
    assert catalog.get("persisted2").index.aniso_eta == 3.0
    dfx.faiss_create_params("persistedb", 16, "IVF4,RQ2x4",
                            {"beam": "7"}, catalog=catalog)
    path2 = str(tmp_path / "p2.idx")
    dfx.faiss_save("persistedb", path2, catalog=catalog)
    dfx.faiss_load("persistedb2", path2, catalog=catalog)
    assert catalog.get("persistedb2").index.rq_beam == 7
    with pytest.raises(dfx.errors.InvalidInputError, match="RQ storage"):
        dfx.faiss_create_params("beambad", 16, "IVF4,PQ4", {"beam": "7"},
                                catalog=catalog)


@pytest.mark.parametrize("enc", ["SQ8", "SQ6", "SQ4"])
def test_ivf_sq_int8_accurate_on_clustered_data(catalog, enc):
    """Round-2 regression: a single-digit int8 query quantization's noise
    (~0.4% of the u·c magnitude) swamps the distance gaps between
    near-duplicate rows in clustered corpora — the int8 fast path then
    returned ~70% wrong labels while passing on uniform data.  The
    recentred two-digit scheme (ops/sq.py::sq_query_digits) must match
    the exact decode path."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.utils.config import set_sq_dot

    rng = np.random.default_rng(78)
    d, n = 16, 3000
    centers = rng.standard_normal((8, d)).astype(np.float32) * 5
    which = np.where(rng.random(n) < 0.6, 0, rng.integers(0, 8, n))
    xb = centers[which] + rng.standard_normal((n, d)).astype(np.float32) * .3
    xq = xb[:16]
    name = "cl" + enc
    dfx.faiss_create(name, d, f"IVF8,{enc}", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, name, catalog=catalog)
    ref = dfx.faiss_search(name, 10, xq, {"nprobe": "8"}, catalog=catalog)
    set_sq_dot("int8")
    try:
        got = dfx.faiss_search(name, 10, xq, {"nprobe": "8"},
                               catalog=catalog)
    finally:
        set_sq_dot("auto")
    # Clustered near-duplicates quantize to IDENTICAL codes, so rank
    # tails are full of exact ties — label equality is brittle (rerank
    # pool widths legitimately shuffle tied members).  Assert what the
    # round-2 bug actually broke: the distance MULTISET must match the
    # decode path (the bug returned ~70% wrong labels at wrong
    # distances), and every disagreeing label must be a tie.
    np.testing.assert_allclose(np.sort(got["distance"], axis=1),
                               np.sort(ref["distance"], axis=1),
                               rtol=3e-4, atol=3e-4)
    same = ref["label"] == got["label"]
    assert same.mean() > 0.8, same.mean()
    # The decode path scores via the expansion form (qn − 2xy + bn, ~1e-4
    # cancellation on clustered data); the int8 rerank via direct diff².
    np.testing.assert_allclose(got["distance"][same], ref["distance"][same],
                               rtol=3e-4, atol=3e-4)


def test_k1000_result_width(catalog):
    """k=1000 through the SQ pairs/spill serving path (the TREC
    conformance width): k_eff clamps, the >128-k spill routing, and the
    query-blocked wide rerank must produce exactly the brute-force
    decoded ranking."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.ops.sq import sq_decode

    rng = np.random.default_rng(37)
    n, d, k = 5000, 32, 1000
    xb = np.concatenate([
        rng.standard_normal((3500, d)).astype(np.float32),
        rng.standard_normal((1500, d)).astype(np.float32) + 5.0,
    ])
    dfx.faiss_create("wide", d, "IVF8,SQ8", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "wide", catalog=catalog)
    res = dfx.faiss_search("wide", k, xb[:4], {"nprobe": "8"},
                           catalog=catalog)
    assert res["label"].shape == (4, k)
    # nprobe=8 == nlist: every row is a candidate, so exactly n valid
    # results per query padded with -1 to k... n > k here, so all k.
    assert (res["label"] >= 0).all()
    idx = catalog.get("wide").index
    import jax.numpy as jnp
    vmin = jnp.asarray(idx._sq_vmin)
    scale = jnp.asarray(idx._sq_scale)
    codes = np.asarray(sq_decode(
        jnp.asarray(idx._codes), vmin, scale, "sq8"))
    d2 = ((xb[:4, None, :] - codes[None, :, :]) ** 2).sum(-1)
    oracle = np.sort(d2, axis=1)[:, :k]
    np.testing.assert_allclose(np.sort(res["distance"], axis=1), oracle,
                               rtol=2e-3, atol=2e-3)
