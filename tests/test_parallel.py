"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import pytest

import duckdb_faiss_ext_tpu as dfx
from duckdb_faiss_ext_tpu import errors
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from duckdb_faiss_ext_tpu.ops.flat_search import choose_chunk, flat_search
from duckdb_faiss_ext_tpu.parallel.sharded import (
    make_mesh, multichip_dryrun, sharded_flat_search_fn,
    sharded_kmeans_step_fn)

RNG = np.random.default_rng(31)


def test_sharded_search_matches_single_device():
    mesh = make_mesh(8, batch_axis=2)   # 4 corpus shards × 2 query shards
    d, cap, n, nq, k = 32, 1024, 1000, 16, 7
    xb = np.zeros((cap, d), np.float32)
    xb[:n] = RNG.standard_normal((n, d)).astype(np.float32)
    xq = RNG.standard_normal((nq, d)).astype(np.float32)

    ref_d, ref_p = flat_search(jnp.asarray(xb), n, jnp.asarray(xq), k, "L2")

    xb_s = jax.device_put(xb, NamedSharding(mesh, P("shard", None)))
    xq_s = jax.device_put(xq, NamedSharding(mesh, P("batch", None)))
    fn = sharded_flat_search_fn(
        mesh, k=k, metric="L2",
        chunk=choose_chunk(cap // 4, nq, d, "L2"))
    got_d, got_p = fn(xb_s, jnp.int32(n), xq_s, jnp.float32(0.0))

    np.testing.assert_allclose(np.asarray(got_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))


def test_sharded_search_similarity_metric():
    mesh = make_mesh(8, batch_axis=1)
    d, cap, n, nq, k = 16, 512, 512, 8, 4
    xb = RNG.standard_normal((cap, d)).astype(np.float32)
    xq = RNG.standard_normal((nq, d)).astype(np.float32)
    ref_d, ref_p = flat_search(jnp.asarray(xb), n, jnp.asarray(xq), k,
                               "INNER_PRODUCT")
    xb_s = jax.device_put(xb, NamedSharding(mesh, P("shard", None)))
    fn = sharded_flat_search_fn(mesh, k=k, metric="INNER_PRODUCT",
                                chunk=64)
    got_d, got_p = fn(xb_s, jnp.int32(n), jnp.asarray(xq), jnp.float32(0.0))
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))


def test_sharded_kmeans_step_matches_oracle():
    mesh = make_mesh(8, batch_axis=2)
    d, n, k = 8, 512, 4
    x = RNG.standard_normal((n, d)).astype(np.float32)
    cents = RNG.standard_normal((k, d)).astype(np.float32)

    # numpy oracle for one Lloyd step
    dist = ((x[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    lab = dist.argmin(1)
    expect = cents.copy()
    for c in range(k):
        if (lab == c).any():
            expect[c] = x[lab == c].mean(0)

    step = sharded_kmeans_step_fn(mesh, k=k)
    x_s = jax.device_put(x, NamedSharding(mesh, P(("shard", "batch"), None)))
    v_s = jax.device_put(np.ones(n, bool),
                         NamedSharding(mesh, P(("shard", "batch"))))
    got = np.asarray(step(x_s, v_s, jnp.asarray(cents)))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)


def test_multichip_dryrun():
    multichip_dryrun(8)


def test_shard_entry_flat(catalog):
    import duckdb_faiss_ext_tpu as dfx

    xb = RNG.standard_normal((500, 16)).astype(np.float32)
    dfx.faiss_create("sh", 16, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "sh", catalog=catalog)
    before = dfx.faiss_search("sh", 3, xb[:2], catalog=catalog)
    dfx.faiss_to_device("sh", catalog=catalog)   # shard over all devices
    entry = catalog.get("sh")
    assert entry.index._device_xb.sharding.is_fully_replicated is False
    after = dfx.faiss_search("sh", 3, xb[:2], catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])


def test_sharded_ivf_search_matches_single_device():
    import jax.numpy as jnp
    from duckdb_faiss_ext_tpu.parallel.sharded import sharded_ivf_search_fn

    mesh = make_mesh(8, batch_axis=2)   # 4 list shards × 2 query shards
    d, nlist, lmax, nq, k, nprobe = 16, 16, 128, 8, 5, 6
    rng = np.random.default_rng(77)
    counts = rng.integers(20, lmax, nlist).astype(np.int32)
    xb_lists = np.zeros((nlist, lmax, d), np.float32)
    row_pos = np.full((nlist, lmax), -1, np.int32)
    next_pos = 0
    for l in range(nlist):
        xb_lists[l, :counts[l]] = rng.standard_normal(
            (counts[l], d)).astype(np.float32)
        row_pos[l, :counts[l]] = np.arange(next_pos, next_pos + counts[l])
        next_pos += counts[l]
    centroids = rng.standard_normal((nlist, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)

    # Plain numpy oracle: float64 scan of every member of the nprobe
    # nearest lists.
    q64 = xq.astype(np.float64)
    cd = ((q64[:, None, :] - centroids[None].astype(np.float64)) ** 2).sum(-1)
    probes = np.argsort(cd, axis=1, kind="stable")[:, :nprobe]
    ref_d = np.zeros((nq, k))
    ref_p = np.zeros((nq, k), np.int64)
    for q in range(nq):
        rows = np.concatenate([xb_lists[l, :counts[l]] for l in probes[q]])
        pos = np.concatenate([row_pos[l, :counts[l]] for l in probes[q]])
        dist = ((rows.astype(np.float64) - q64[q]) ** 2).sum(-1)
        o = np.argsort(dist, kind="stable")[:k]
        ref_d[q], ref_p[q] = dist[o], pos[o]

    fn = sharded_ivf_search_fn(mesh, k=k, nprobe=nprobe, metric="L2",
                               precision=jax.lax.Precision.HIGHEST)
    xb_s = jax.device_put(xb_lists,
                          NamedSharding(mesh, P("shard", None, None)))
    cnt_s = jax.device_put(counts, NamedSharding(mesh, P("shard")))
    rp_s = jax.device_put(row_pos, NamedSharding(mesh, P("shard", None)))
    xq_s = jax.device_put(xq, NamedSharding(mesh, P("batch", None)))
    got_d, got_p = fn(xb_s, cnt_s, rp_s, jnp.asarray(centroids), xq_s,
                      jnp.float32(0.0))
    np.testing.assert_allclose(np.asarray(got_d), np.asarray(ref_d),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_p), np.asarray(ref_p))


def test_faiss_to_device_ivf(catalog):
    """faiss_to_device on an IVF index: lists sharded over the mesh, search
    results unchanged."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(8)
    d, n = 16, 2000
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    xb = centers[rng.integers(0, 8, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * 0.3
    dfx.faiss_create("shivf", d, "IVF8,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shivf", catalog=catalog)
    before = dfx.faiss_search("shivf", 5, xb[:4], {"nprobe": "8"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shivf", mesh, catalog=catalog)
    after = dfx.faiss_search("shivf", 5, xb[:4], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    # Sharded path computes L2 as direct diff² vs the gather path's
    # decomposition — equal answers modulo summation order.
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)
    # Adds keep working and the placement sticks.
    dfx.faiss_add(xb[:100], "shivf", catalog=catalog)
    again = dfx.faiss_search("shivf", 5, xb[:4], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(again["label"][:, 0],
                                  before["label"][:, 0])


def test_faiss_to_device_ivfpq(catalog):
    """faiss_to_device on an IVFPQ index: byte-code lists sharded over the
    mesh, candidates reconstructed on-device (round-2 queue item 1)."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(21)
    d, n = 16, 3000
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    xb = centers[rng.integers(0, 8, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * 0.3
    dfx.faiss_create("shivfpq", d, "IVF8,PQ4", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shivfpq", catalog=catalog)
    before = dfx.faiss_search("shivfpq", 5, xb[:6], {"nprobe": "8"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shivfpq", mesh, catalog=catalog)
    after = dfx.faiss_search("shivfpq", 5, xb[:6], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)


def test_faiss_to_device_ivf_filtered(catalog):
    """Filtered search on a device-sharded IVF index (round-2 queue item 2):
    mask sharded alongside the lists, fused into the per-shard scan."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.ops.selectors import SetSelector

    rng = np.random.default_rng(33)
    d, n = 16, 2000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("shivf_f", d, "IVF8,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shivf_f", catalog=catalog)
    keep = np.arange(0, n, 3, dtype=np.int64)        # every 3rd id passes
    sel = SetSelector(keep)
    before = dfx.faiss_search("shivf_f", 5, xb[:6], {"nprobe": "8"},
                              catalog=catalog, selector=sel)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shivf_f", mesh, catalog=catalog)
    after = dfx.faiss_search("shivf_f", 5, xb[:6], {"nprobe": "8"},
                             catalog=catalog, selector=sel)
    np.testing.assert_array_equal(before["label"], after["label"])
    assert np.all(before["label"] % 3 == 0)
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)


def test_faiss_to_device_ivfpq_filtered(catalog):
    """Both round-2 queue items combined: PQ payload + selector mask through
    the sharded scan."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.ops.selectors import SetSelector

    rng = np.random.default_rng(34)
    d, n = 16, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("shpq_f", d, "IVF8,PQ4", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shpq_f", catalog=catalog)
    keep = np.arange(0, n, 2, dtype=np.int64)
    sel = SetSelector(keep)
    before = dfx.faiss_search("shpq_f", 5, xb[:6], {"nprobe": "8"},
                              catalog=catalog, selector=sel)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shpq_f", mesh, catalog=catalog)
    after = dfx.faiss_search("shpq_f", 5, xb[:6], {"nprobe": "8"},
                             catalog=catalog, selector=sel)
    np.testing.assert_array_equal(before["label"], after["label"])
    assert np.all(before["label"] % 2 == 0)


def test_to_device_integer_index(catalog):
    """The reference's faiss_to_gpu(name, device) integer-device form:
    index 0 reshards onto that device; out-of-range mirrors the
    Invalid-GPU-index error (src/gpu/gpu.cpp:57)."""
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((64, 8)).astype(np.float32)
    dfx.faiss_create("dev0", 8, "Flat", metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, "dev0", catalog=catalog)
    dfx.faiss_to_device("dev0", 0, catalog=catalog)
    res = dfx.faiss_search("dev0", 3, xb[:4], catalog=catalog)
    assert (res["label"][:, 0] == np.arange(4)).all()
    with pytest.raises(errors.InvalidInputError, match="Invalid device"):
        dfx.faiss_to_device("dev0", 99, catalog=catalog)


@pytest.mark.parametrize("storage", ["SQ8", "SQ4", "SQfp16", "SQbf16"])
def test_faiss_to_device_ivfsq(catalog, storage):
    """faiss_to_device on IVF with scalar-quantized storage: packed code
    lists sharded over the mesh, decoded in-shard with replicated ranges
    (closes the 'IVF with SQ encoding cannot be sharded yet' gap)."""
    rng = np.random.default_rng(22)
    d, n = 16, 3000
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    xb = centers[rng.integers(0, 8, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * 0.3
    name = f"shivfsq{storage}"
    dfx.faiss_create(name, d, f"IVF8,{storage}", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, name, catalog=catalog)
    before = dfx.faiss_search(name, 5, xb[:6], {"nprobe": "8"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device(name, mesh, catalog=catalog)
    after = dfx.faiss_search(name, 5, xb[:6], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"],
                                  err_msg=storage)
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4, err_msg=storage)


def test_faiss_to_device_ivfrq(catalog):
    """faiss_to_device on IVFn,RQMxb: residual byte codes sharded with the
    lists, decoded additively in-shard (codec switch in
    sharded_ivf_search_fn)."""
    rng = np.random.default_rng(23)
    d, n = 16, 3000
    centers = rng.standard_normal((8, d)).astype(np.float32) * 4
    xb = centers[rng.integers(0, 8, n)] + \
        rng.standard_normal((n, d)).astype(np.float32) * 0.2
    dfx.faiss_create("shivfrq", d, "IVF8,RQ4x4", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shivfrq", catalog=catalog)
    before = dfx.faiss_search("shivfrq", 5, xb[:6], {"nprobe": "8"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shivfrq", mesh, catalog=catalog)
    after = dfx.faiss_search("shivfrq", 5, xb[:6], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)


def test_faiss_to_device_soar(catalog):
    """SOAR's duplicated rows ride the sharded list layout unchanged; the
    host dedup applies after the all-gather merge."""
    rng = np.random.default_rng(29)
    d, n = 16, 3000
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create_params("shsoar", d, "IVF8,Flat",
                            {"soar_lambda": "1.0"}, metric_type="L2",
                            catalog=catalog)
    dfx.faiss_add(xb, "shsoar", catalog=catalog)
    before = dfx.faiss_search("shsoar", 5, xb[:6], {"nprobe": "8"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shsoar", mesh, catalog=catalog)
    after = dfx.faiss_search("shsoar", 5, xb[:6], {"nprobe": "8"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)
    for row in after["label"]:
        live = row[row >= 0]
        assert len(set(live)) == len(live)


def test_faiss_to_device_imi(catalog):
    """IMI's materialized cell table rides the standard sharded-IVF path
    (nlist = 4^b lists partitioned over the mesh)."""
    rng = np.random.default_rng(30)
    d, n = 16, 2500
    xb = rng.standard_normal((n, d)).astype(np.float32)
    dfx.faiss_create("shimi", d, "IMI2x2,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shimi", catalog=catalog)
    before = dfx.faiss_search("shimi", 5, xb[:6], {"nprobe": "16"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shimi", mesh, catalog=catalog)
    after = dfx.faiss_search("shimi", 5, xb[:6], {"nprobe": "16"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("desc", ["PQ4", "SQ8", "SQ4", "SQfp16", "RQ2x4",
                                  "LSH16"])
def test_faiss_to_device_codec_families(catalog, desc):
    """Standalone codec families shard their byte-code corpus over the
    mesh (row placement under GSPMD, like Flat); search parity holds."""
    rng = np.random.default_rng(33)
    d, n = 16, 900
    xb = rng.standard_normal((n, d)).astype(np.float32)
    name = f"shc_{desc.replace(',', '_')}"
    dfx.faiss_create(name, d, desc, metric_type="L2", catalog=catalog)
    dfx.faiss_add(xb, name, catalog=catalog)
    before = dfx.faiss_search(name, 4, xb[:5], catalog=catalog)
    dfx.faiss_to_device(name, make_mesh(8, batch_axis=1), catalog=catalog)
    after = dfx.faiss_search(name, 4, xb[:5], catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"],
                                  err_msg=desc)
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4, err_msg=desc)


@pytest.mark.parametrize("desc", ["PCA8,Flat", "PQ4,RFlat",
                                  "ITQ8,LSH16", "IDMap2,OPQ4,IVF4,PQ4"])
def test_faiss_to_device_wrapped_composites(catalog, desc):
    """shard_entry unwraps IDMap/PreTransform/RefineFlat wrappers down to
    the storage-owning index (RefineFlat shards its base; the re-rank
    stage's per-query gathers stay replicated)."""
    rng = np.random.default_rng(34)
    d, n = 16, 800
    xb = rng.standard_normal((n, d)).astype(np.float32)
    import re as _re

    name = "shw_" + _re.sub(r"\\W", "_", desc)
    dfx.faiss_create(name, d, desc, metric_type="L2", catalog=catalog)
    data = ((np.arange(n, dtype=np.int64), xb)
            if desc.startswith("IDMap") else xb)
    dfx.faiss_add(data, name, catalog=catalog)
    before = dfx.faiss_search(name, 4, xb[:5], {"nprobe": "4"},
                              catalog=catalog)
    dfx.faiss_to_device(name, make_mesh(8, batch_axis=1), catalog=catalog)
    after = dfx.faiss_search(name, 4, xb[:5], {"nprobe": "4"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"],
                                  err_msg=desc)
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4, err_msg=desc)


def test_untrained_shard_then_train(catalog):
    """faiss_to_device BEFORE training (the FAISS create→to_gpu→train
    flow): the placement is sticky, materialization deferred to the first
    post-train use (review finding: eager _device_state crashed on the
    None codebooks)."""
    rng = np.random.default_rng(35)
    xb = rng.standard_normal((500, 16)).astype(np.float32)
    mesh = make_mesh(8, batch_axis=1)
    for desc in ("PQ4", "SQ8", "RQ2x4"):
        name = f"ut_{desc}"
        dfx.faiss_create(name, 16, desc, metric_type="L2", catalog=catalog)
        dfx.faiss_to_device(name, mesh, catalog=catalog)
        dfx.faiss_add(xb, name, catalog=catalog)
        res = dfx.faiss_search(name, 3, xb[:4], catalog=catalog)
        assert (res["label"][:, 0] == np.arange(4)).sum() >= 3, desc


def test_refine_store_sharded(catalog):
    """RefineFlat sharding covers BOTH parts: the compressed base and the
    raw refine store (review finding: the fp32 store dominated per-device
    memory when left unsharded)."""
    rng = np.random.default_rng(36)
    xb = rng.standard_normal((640, 16)).astype(np.float32)
    dfx.faiss_create("rfsh", 16, "PQ4,RFlat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "rfsh", catalog=catalog)
    dfx.faiss_to_device("rfsh", make_mesh(8, batch_axis=1),
                        catalog=catalog)
    ix = catalog.get("rfsh").index
    refine_buf = ix.refine.device_vectors()
    assert len(refine_buf.sharding.mesh.devices.reshape(-1)) == 8
    res = dfx.faiss_search("rfsh", 3, xb[:4], catalog=catalog)
    assert (res["label"][:, 0] == np.arange(4)).all()


def test_sharded_ivf_ip_fast_mode_rerank():
    """The sharded IVF scan's fast-mode IP in-chunk rerank: results match
    the parity-precision run exactly (CPU computes fp32 either way; this
    exercises the widened-top-k + re-score + index-mapping branch)."""
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.catalog import Catalog
    from duckdb_faiss_ext_tpu.parallel.sharded import make_mesh

    rng = np.random.default_rng(8)
    xb = rng.standard_normal((4096, 16)).astype(np.float32)
    xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    cat = Catalog()
    dfx.faiss_create("sip", 16, "IVF16,Flat", metric_type="INNER_PRODUCT",
                     catalog=cat)
    dfx.faiss_add(xb, "sip", catalog=cat)
    dfx.faiss_to_device("sip", make_mesh(4, batch_axis=1), catalog=cat)
    ref = dfx.faiss_search("sip", 10, xb[:16], {"nprobe": "16"}, catalog=cat)
    dfx.set_precision("fast")
    try:
        fast = dfx.faiss_search("sip", 10, xb[:16], {"nprobe": "16"},
                                catalog=cat)
    finally:
        dfx.set_precision("parity")
    np.testing.assert_array_equal(ref["label"], fast["label"])
    np.testing.assert_allclose(ref["distance"], fast["distance"], rtol=1e-6)


def test_balanced_list_partition_property():
    """LPT bin-pack: equal group cardinality, every list placed once,
    per-shard Σcounts spread far below the contiguous-block split on a
    front-loaded skew distribution (SURVEY §2.3 data-partitioning row)."""
    from duckdb_faiss_ext_tpu.parallel.sharded import balanced_list_partition

    rng = np.random.default_rng(3)
    nlist, nshards = 64, 8
    # marco-like skew: a few huge lists (packed first), long tail.
    counts = np.concatenate([
        rng.integers(4000, 7500, 8),
        rng.integers(100, 2000, nlist - 8)]).astype(np.int64)
    perm = balanced_list_partition(counts, nshards)
    assert sorted(perm.tolist()) == list(range(nlist))
    npl = nlist // nshards
    loads = np.asarray([counts[perm[s * npl:(s + 1) * npl]].sum()
                        for s in range(nshards)], np.float64)
    contig = np.asarray([counts[s * npl:(s + 1) * npl].sum()
                         for s in range(nshards)], np.float64)
    assert loads.max() / loads.mean() < 1.3
    assert contig.max() / contig.mean() > 1.5   # the problem being fixed
    assert loads.max() < contig.max()


def test_faiss_to_device_ivf_skewed(catalog):
    """Skew-aware placement end to end: a corpus whose k-means lists are
    heavily skewed, sharded with faiss_to_device — results identical to
    the single-device search, and the recorded _shard_perm balances
    per-shard Σcounts."""
    import duckdb_faiss_ext_tpu as dfx

    rng = np.random.default_rng(9)
    d, n = 16, 4000
    # one dominant cluster (hot lists) + sparse outliers
    xb = np.concatenate([
        rng.standard_normal((n - 256, d)).astype(np.float32) * 0.2,
        rng.standard_normal((256, d)).astype(np.float32) * 4 + 8,
    ])
    dfx.faiss_create("shskew", d, "IVF16,Flat", metric_type="L2",
                     catalog=catalog)
    dfx.faiss_add(xb, "shskew", catalog=catalog)
    before = dfx.faiss_search("shskew", 5, xb[:8], {"nprobe": "16"},
                              catalog=catalog)
    mesh = make_mesh(8, batch_axis=1)
    dfx.faiss_to_device("shskew", mesh, catalog=catalog)
    after = dfx.faiss_search("shskew", 5, xb[:8], {"nprobe": "16"},
                             catalog=catalog)
    np.testing.assert_array_equal(before["label"], after["label"])
    np.testing.assert_allclose(before["distance"], after["distance"],
                               rtol=3e-4, atol=3e-4)
    idx = catalog.get("shskew").index
    counts = idx._counts()
    perm = idx._shard_perm
    nshards = 8
    npl = counts.shape[0] // nshards
    loads = np.asarray([counts[perm[s * npl:(s + 1) * npl]].sum()
                        for s in range(nshards)], np.float64)
    assert loads.max() / max(loads.mean(), 1.0) < 1.5
