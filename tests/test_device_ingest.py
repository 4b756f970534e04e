"""Device-resident IVF ingest (models/ivf_device.py): parity vs the host
ingest path on the same data, spill handling, selectors, save/load, and the
mode-mixing guards."""

import numpy as np
import pytest

import jax.numpy as jnp

import duckdb_faiss_ext_tpu as dfx
from duckdb_faiss_ext_tpu import InvalidInputError
from duckdb_faiss_ext_tpu.catalog import GLOBAL_CATALOG
from duckdb_faiss_ext_tpu.ops.selectors import SetSelector


def _mk(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


def _cleanup(*names):
    for n in names:
        try:
            dfx.faiss_destroy(n)
        except Exception:
            pass


@pytest.mark.parametrize("storage,metric", [
    ("SQ8", "L2"), ("SQ8", "INNER_PRODUCT"),
    ("SQ4", "L2"), ("Flat", "L2"),
    ("SQ6", "L2"), ("SQ6", "INNER_PRODUCT"),
])
def test_device_ingest_matches_host_path(storage, metric):
    rng = np.random.default_rng(3)
    n, d, nlist, k = 4000, 32, 16, 5
    xb, xq = _mk(rng, n, d), _mk(rng, 64, d)
    desc = f"IVF{nlist},{storage}" if storage != "Flat" else f"IVF{nlist}"
    try:
        dfx.faiss_create("h", d, desc, metric_type=metric)
        dfx.faiss_manual_train(xb[:1000], "h")
        dfx.faiss_add(xb, "h")

        dfx.faiss_create("dev", d, desc, metric_type=metric)
        dfx.faiss_train_device(jnp.asarray(xb[:1000]), "dev")
        # Two chunks, to exercise running-count slots.
        dfx.faiss_add_device(jnp.asarray(xb[:2500]), "dev",
                             expected_total=n)
        dfx.faiss_add_device(jnp.asarray(xb[2500:]), "dev")

        params = {"nprobe": "4"}
        rh = dfx.faiss_search("h", k, xq, params)
        rd = dfx.faiss_search("dev", k, xq, params)
        # Same trained state (same seed/data) -> same lists; the device
        # path serves via the padded-layout scan, the host path via the
        # sorted-layout scan — labels must agree and distances match fp32.
        assert (rh["label"] == rd["label"]).mean() > 0.98
        same = rh["label"] == rd["label"]
        np.testing.assert_allclose(rd["distance"][same],
                                   rh["distance"][same], rtol=2e-5,
                                   atol=2e-5)
    finally:
        _cleanup("h", "dev")


def test_device_ingest_spill_and_selector():
    """A tiny forced lmax pushes most rows into the spill region; results
    must still match the host path, with and without a selector."""
    rng = np.random.default_rng(5)
    n, d, nlist, k = 3000, 16, 8, 6
    xb, xq = _mk(rng, n, d), _mk(rng, 32, d)
    try:
        dfx.faiss_create("h", d, f"IVF{nlist},SQ8")
        dfx.faiss_manual_train(xb[:800], "h")
        dfx.faiss_add(xb, "h")

        dfx.faiss_create("dev", d, f"IVF{nlist},SQ8")
        dfx.faiss_train_device(jnp.asarray(xb[:800]), "dev")
        dfx.faiss_add_device(jnp.asarray(xb), "dev", lmax=128)

        idx = GLOBAL_CATALOG.get("dev").index
        assert idx._dr.spill_n > 0          # the cap actually binds

        params = {"nprobe": str(nlist)}     # all lists -> exhaustive
        rh = dfx.faiss_search("h", k, xq, params)
        rd = dfx.faiss_search("dev", k, xq, params)
        assert (rh["label"] == rd["label"]).mean() > 0.98

        sel = SetSelector(np.arange(0, n, 3, dtype=np.int64))
        rh = dfx.faiss_search("h", k, xq, params, selector=sel)
        rd = dfx.faiss_search("dev", k, xq, params, selector=sel)
        assert set(np.unique(rd["label"])) <= set(
            np.arange(0, n, 3)) | {-1}
        assert (rh["label"] == rd["label"]).mean() > 0.98
    finally:
        _cleanup("h", "dev")


@pytest.mark.parametrize("storage,tol", [("SQ4", 0.25), ("SQ6", 0.1)])
def test_device_ingest_save_load_reconstruct(tmp_path, storage, tol):
    rng = np.random.default_rng(7)
    n, d, nlist = 2000, 24, 8
    xb = _mk(rng, n, d)
    xq = _mk(rng, 16, d)
    try:
        dfx.faiss_create("dev", d, f"IVF{nlist},{storage}")
        dfx.faiss_train_device(jnp.asarray(xb[:600]), "dev")
        dfx.faiss_add_device(jnp.asarray(xb), "dev", expected_total=n,
                             lmax=128)

        idx = GLOBAL_CATALOG.get("dev").index
        assert idx._dr.spill_n > 0          # the tiny lmax binds
        # reconstruct decodes through the device layout (incl. spill).
        for key in (0, 1, n // 2, n - 1):
            rec = idx.reconstruct(key)
            assert np.abs(rec - xb[key]).max() < tol    # quantization

        path = str(tmp_path / "dev.dfx")
        dfx.faiss_save("dev", path)
        dfx.faiss_load("loaded", path)
        params = {"nprobe": "8"}
        rd = dfx.faiss_search("dev", 5, xq, params)
        rl = dfx.faiss_search("loaded", 5, xq, params)
        np.testing.assert_array_equal(rd["label"], rl["label"])
        np.testing.assert_allclose(rd["distance"], rl["distance"],
                                   rtol=2e-5, atol=2e-5)
    finally:
        _cleanup("dev", "loaded")


def test_device_ingest_guards():
    rng = np.random.default_rng(9)
    xb = _mk(rng, 600, 8)
    try:
        dfx.faiss_create("g", 8, "IVF4,SQ8")
        dfx.faiss_manual_train(xb[:200], "g")
        # sizing required on the first call
        with pytest.raises(InvalidInputError, match="expected_total"):
            dfx.faiss_add_device(jnp.asarray(xb), "g")
        dfx.faiss_add_device(jnp.asarray(xb), "g", expected_total=600)
        # no host adds after device ingest
        with pytest.raises(InvalidInputError, match="mix"):
            dfx.faiss_add(xb, "g")
        # no re-sharding of a device-resident index
        idx = GLOBAL_CATALOG.get("g").index
        with pytest.raises(InvalidInputError, match="device-resident"):
            from duckdb_faiss_ext_tpu.parallel.placement import default_mesh
            idx.shard_over(default_mesh())

        # no device ingest after host adds
        dfx.faiss_create("g2", 8, "IVF4,SQ8")
        dfx.faiss_manual_train(xb[:200], "g2")
        dfx.faiss_add(xb[:100], "g2")
        with pytest.raises(InvalidInputError, match="mix"):
            dfx.faiss_add_device(jnp.asarray(xb), "g2", expected_total=600)

        # unsupported storage
        dfx.faiss_create("g3", 8, "IVF4,PQ2")
        with pytest.raises(InvalidInputError,
                           match="Flat, SQ8, SQ6 and SQ4"):
            dfx.faiss_train_device(jnp.asarray(xb), "g3")
    finally:
        _cleanup("g", "g2", "g3")


def test_device_ingest_with_ids():
    rng = np.random.default_rng(11)
    n, d = 1500, 16
    xb, xq = _mk(rng, n, d), _mk(rng, 8, d)
    ids = np.arange(n, dtype=np.int64) * 10 + 7
    try:
        dfx.faiss_create("di", d, "IVF8,SQ8")
        dfx.faiss_train_device(jnp.asarray(xb[:500]), "di")
        dfx.faiss_add_device(jnp.asarray(xb), "di", ids, expected_total=n)
        r = dfx.faiss_search("di", 3, xq, {"nprobe": "8"})
        valid = r["label"][r["label"] >= 0]
        assert valid.size and np.all(valid % 10 == 7)
        # labels must match the host path exactly (same data, same train
        # state; SQ8 at d=16 misses some self-hits inherently, so compare
        # paths, not an absolute recall).
        dfx.faiss_create("hi", d, "IVF8,SQ8")
        dfx.faiss_manual_train(xb[:500], "hi")
        dfx.faiss_add((ids, xb), "hi")
        r2 = dfx.faiss_search("di", 1, xb[:32], {"nprobe": "8"})
        rh = dfx.faiss_search("hi", 1, xb[:32], {"nprobe": "8"})
        np.testing.assert_array_equal(r2["label"], rh["label"])
        np.testing.assert_allclose(r2["distance"], rh["distance"],
                                   rtol=2e-5, atol=2e-5)
    finally:
        _cleanup("di", "hi")


def test_capped_assign_respects_capacity():
    from duckdb_faiss_ext_tpu.models.ivf_device import capped_assign

    rng = np.random.default_rng(5)
    nlist, m, cap = 8, 600, 100
    # heavily skewed candidates: most rows want list 0 first
    top1 = np.where(rng.random(m) < 0.7, 0, rng.integers(0, nlist, m))
    cand = np.stack([top1] + [rng.integers(0, nlist, m) for _ in range(3)],
                    axis=1).astype(np.int32)
    counts = np.zeros((nlist,), np.int64)
    counts[0] = 90                     # list 0 nearly full already
    assign, displaced = capped_assign(cand, counts, cap)
    assert assign.shape == (m,) and (assign >= 0).all()
    new = counts + np.bincount(assign, minlength=nlist)
    # Every list is at/below cap EXCEPT overflow rows that kept their true
    # nearest list (they spill); those rows all carry cand[:, 0].
    over = np.flatnonzero(new > cap)
    for li in over:
        rows = np.flatnonzero(assign == li)
        # the rows beyond capacity must be true-nearest keepers
        assert (cand[rows, 0] == li).sum() >= new[li] - cap
    assert displaced > 0               # skew forced displacement


def test_device_ingest_capped_assignment_small_spill(catalog):
    """Capped assignment keeps the padded layout within capacity (tiny
    spill) on skewed data, and search remains valid vs brute force."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(6)
    n, d, nlist = 6000, 16, 16
    # one hot cluster holding half the mass
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 4
    which = np.where(rng.random(n) < 0.5, 0, rng.integers(0, nlist, n))
    xb = centers[which] + rng.standard_normal((n, d)).astype(np.float32)

    dfx.faiss_create_params("dcap", d, f"IVF{nlist},SQ8",
                            {"assign_topk": "4"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_train_device(xb[:4000], "dcap", catalog=catalog)
    lmax = 512                        # ~1.4x avg: plain nearest would spill
    dfx.faiss_add_device(xb, "dcap", lmax=lmax, catalog=catalog)
    idx = catalog.get("dcap").index
    frac = idx._dr.spill_n / n
    assert frac < 0.05, frac          # plain nearest spills ~25% here

    xq = xb[:32]
    res = dfx.faiss_search("dcap", 5, xq, {"nprobe": str(nlist)},
                           catalog=catalog)
    # nprobe = nlist scans everything: results equal brute force over the
    # SQ-decoded corpus regardless of which list holds each row.
    assert (res["label"][:, 0] == np.arange(32)).mean() == 1.0


def test_spill_int8_scoring_matches_decode(catalog):
    """The decode-free int8 spill branch (spill_rn/spill_rs, fast mode)
    must agree with the decode spill path."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(9)
    n, d, nlist = 8000, 32, 8
    centers = rng.standard_normal((nlist, d)).astype(np.float32) * 4
    which = np.where(rng.random(n) < 0.6, 0, rng.integers(0, nlist, n))
    xb = centers[which] + rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("sp8", d, f"IVF{nlist},SQ8", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_train_device(xb[:4000], "sp8", catalog=catalog)
    dfx.faiss_add_device(xb, "sp8", lmax=512, catalog=catalog)  # big spill
    idx = catalog.get("sp8").index
    assert idx._dr.spill_n > 1000
    xq = xb[:64]
    dfx.set_precision("fast")
    try:
        dfx.set_sq_dot("int8")
        r8 = dfx.faiss_search("sp8", 10, xq, {"nprobe": str(nlist)},
                              catalog=catalog)
        dfx.set_sq_dot("decode")
        rd = dfx.faiss_search("sp8", 10, xq, {"nprobe": str(nlist)},
                              catalog=catalog)
    finally:
        dfx.set_sq_dot("auto")
        dfx.set_precision("parity")
    assert (r8["label"][:, 0] == np.arange(64)).all()
    np.testing.assert_allclose(np.sort(r8["distance"], 1),
                               np.sort(rd["distance"], 1),
                               rtol=3e-4, atol=3e-4)


def test_spill_rerank_query_blocking(catalog):
    """The spill rerank's query-blocked gather (rerank_qb) returns the
    same results as the unblocked path — the (nq, k_scan, d) decoded tile
    is bounded for the filtered bench's k in the thousands."""
    import jax
    import jax.numpy as jnp_

    from duckdb_faiss_ext_tpu.ops.ivf_scan import ivf_spill_scan

    rng = np.random.default_rng(13)
    s, d, nlist, nq, k = 2048, 32, 8, 12, 40
    xb = rng.standard_normal((s, d)).astype(np.float32)
    codes = np.clip(np.round((xb + 3.0) / (6.0 / 255)), 0,
                    255).astype(np.uint8)
    vmin = jnp_.full((d,), -3.0, jnp_.float32)
    scale = jnp_.full((d,), 6.0 / 255, jnp_.float32)
    qf = codes.astype(np.float32)
    rn = jnp_.asarray((qf * (6.0 / 255)) ** 2 @ np.ones(d, np.float32))
    rs = jnp_.asarray(qf.sum(1))
    args = (jnp_.asarray(codes),
            jnp_.asarray(rng.integers(0, nlist, s).astype(np.int32)),
            jnp_.asarray(np.arange(s, dtype=np.int32)),
            jnp_.asarray(rng.standard_normal((nlist, d)).astype(np.float32)),
            None,
            jnp_.asarray(np.tile(np.arange(nlist, dtype=np.int32),
                                 (nq, 1))),
            jnp_.asarray(rng.standard_normal((nq, d)).astype(np.float32)),
            None, jnp_.float32(0))
    kw = dict(k=k, metric="L2", precision=jax.lax.Precision.DEFAULT,
              sq="sq8", sq_vmin=vmin, sq_scale=scale, n_used=s,
              spill_rn=rn, spill_rs=rs, int8_dot=True)
    b1, p1 = ivf_spill_scan(*args, **kw)                 # auto qb
    b2, p2 = ivf_spill_scan(*args, rerank_qb=3, **kw)    # forced blocks
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                               rtol=1e-6, atol=1e-6)

def test_spill_membership_cmp_matches_gather(catalog):
    """The compare-loop probed-list membership (nprobe fused equality
    passes, no gather/transpose) selects exactly the rows the one-hot
    gather path selects."""
    import jax
    import jax.numpy as jnp_

    from duckdb_faiss_ext_tpu.ops.ivf_scan import ivf_spill_scan

    rng = np.random.default_rng(29)
    s, d, nlist, nq, nprobe, k = 4096, 32, 64, 16, 5, 20
    xb = rng.standard_normal((s, d)).astype(np.float32)
    codes = np.clip(np.round((xb + 3.0) / (6.0 / 255)), 0,
                    255).astype(np.uint8)
    vmin = jnp_.full((d,), -3.0, jnp_.float32)
    scale = jnp_.full((d,), 6.0 / 255, jnp_.float32)
    qf = codes.astype(np.float32)
    rn = jnp_.asarray((qf * (6.0 / 255)) ** 2 @ np.ones(d, np.float32))
    rs = jnp_.asarray(qf.sum(1))
    # Partial, per-query-distinct probe sets (membership varies by row).
    probes = np.stack([rng.choice(nlist, nprobe, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    args = (jnp_.asarray(codes),
            jnp_.asarray(rng.integers(0, nlist, s).astype(np.int32)),
            jnp_.asarray(np.arange(s, dtype=np.int32)),
            jnp_.asarray(rng.standard_normal((nlist, d)).astype(np.float32)),
            None, jnp_.asarray(probes),
            jnp_.asarray(rng.standard_normal((nq, d)).astype(np.float32)),
            None, jnp_.float32(0))
    for metric in ("L2", "INNER_PRODUCT"):
        kw = dict(k=k, metric=metric, precision=jax.lax.Precision.DEFAULT,
                  sq="sq8", sq_vmin=vmin, sq_scale=scale, n_used=s,
                  spill_rn=rn, spill_rs=rs, int8_dot=True)
        b1, p1 = ivf_spill_scan(*args, membership="cmp", **kw)
        b2, p2 = ivf_spill_scan(*args, membership="gather", **kw)
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                                   rtol=1e-6, atol=1e-6)
