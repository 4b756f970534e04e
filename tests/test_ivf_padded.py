"""Device-resident IVF serving (models/ivf_device.py + ops/ivf_padded.py):
the XLA scan of the padded list payload, the spill scan and their merge,
against a float64 numpy scan of exactly the probed lists.

Cases cover every payload codec (Flat, SQ8, SQ4, SQ6 — SQ6 plane-major),
both metrics, a layout with and without spilled rows, with and without a
selector, and k beyond nprobe·lmax."""

import numpy as np
import pytest

import jax.numpy as jnp

import duckdb_faiss_ext_tpu as dfx
from duckdb_faiss_ext_tpu.catalog import Catalog
from duckdb_faiss_ext_tpu.ops.ivf_padded import (choose_lmax,
                                                 choose_padded_q_chunk,
                                                 gather_lists, padded_lmax)
from duckdb_faiss_ext_tpu.ops.selectors import SetSelector

N, D, NLIST, NPROBE, K = 1200, 18, 8, 2, 5
LEVELS = {"SQ8": 255, "SQ4": 15, "SQ6": 63}
SPILL_LMAX, FULL_LMAX = 128, 1024
_BUILT = {}


def _data():
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((6, D)).astype(np.float32) * 3
    xb = (centers[rng.integers(0, 6, N)]
          + rng.standard_normal((N, D)).astype(np.float32))
    xq = (centers[rng.integers(0, 6, 16)]
          + rng.standard_normal((16, D)).astype(np.float32))
    return xb, xq


def _index(codec, metric, spill):
    key = (codec, metric, spill)
    if key not in _BUILT:
        xb, xq = _data()
        cat = Catalog()
        desc = f"IVF{NLIST}" + ("" if codec == "Flat" else f",{codec}")
        dfx.faiss_create("p", D, desc, metric_type=metric, catalog=cat)
        dfx.faiss_train_device(jnp.asarray(xb), "p", catalog=cat)
        ids = np.arange(N, dtype=np.int64) * 3 + 7
        dfx.faiss_add_device(jnp.asarray(xb), "p", ids,
                             lmax=SPILL_LMAX if spill else FULL_LMAX,
                             catalog=cat)
        _BUILT[key] = (cat, xb, xq, ids)
    return _BUILT[key]


def _reference(idx, codec, metric, xb, xq, ids, k, keep):
    """float64 scan of every stored row whose list is among the query's
    NPROBE nearest centroids (decoded through the SQ codec)."""
    rows = xb.astype(np.float64)
    if codec != "Flat":
        vmin = idx._sq_vmin.astype(np.float64)
        scale = idx._sq_scale.astype(np.float64)
        q = np.clip(np.round((xb - idx._sq_vmin) / idx._sq_scale), 0,
                    LEVELS[codec])
        rows = q * scale + vmin
    cents = idx._centroids.astype(np.float64)
    labels = np.full((xq.shape[0], k), -1, np.int64)
    dists = np.full((xq.shape[0], k), np.nan)
    for i, qv in enumerate(xq.astype(np.float64)):
        if metric == "L2":
            probes = np.argsort(((cents - qv) ** 2).sum(1))[:NPROBE]
        else:
            probes = np.argsort(-(cents @ qv))[:NPROBE]
        cand = np.nonzero(np.isin(idx._assign, probes) & keep)[0]
        if metric == "L2":
            score = -((rows[cand] - qv) ** 2).sum(1)
        else:
            score = rows[cand] @ qv
        o = np.argsort(-score, kind="stable")[:k]
        labels[i, :o.size] = ids[cand[o]]
        dists[i, :o.size] = -score[o] if metric == "L2" else score[o]
    return labels, dists


@pytest.mark.parametrize("big_k", [False, True], ids=["k", "k>nprobe*lmax"])
@pytest.mark.parametrize("selector", [False, True], ids=["all", "selector"])
@pytest.mark.parametrize("spill", [False, True], ids=["no-spill", "spill"])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("codec", ["Flat", "SQ8", "SQ4", "SQ6"])
def test_padded_scan_matches_numpy(codec, metric, spill, selector, big_k):
    cat, xb, xq, ids = _index(codec, metric, spill)
    idx = cat.get("p").index
    assert (idx._dr.spill_n > 0) == spill
    lmax = idx._dr.lmax
    k = NPROBE * lmax + 10 if big_k else K
    sel = None
    keep = np.ones(N, bool)
    if selector:
        keep = ids % 2 == 1
        sel = SetSelector(ids[keep])
    res = dfx.faiss_search("p", k, xq, {"nprobe": str(NPROBE)},
                           catalog=cat, selector=sel)
    assert idx._last_scan_path == "padded-" + codec.lower()
    ref_l, ref_d = _reference(idx, codec, metric, xb, xq, ids, k, keep)
    np.testing.assert_array_equal(res["label"], ref_l)
    live = ref_l >= 0
    np.testing.assert_allclose(res["distance"][live], ref_d[live],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("counts_max,want", [
    (1, 128), (128, 128), (129, 256), (512, 512), (513, 1024),
    (1500, 1536),
])
def test_choose_lmax(counts_max, want):
    assert choose_lmax(counts_max) == want


def test_gather_lists_reads_sq6_planes_as_packed_rows():
    rng = np.random.default_rng(3)
    nlist, lmax, d4 = 4, 8, 5
    packed = rng.integers(0, 256, (nlist, lmax, 3 * d4), dtype=np.uint8)
    planes = (packed.reshape(nlist, lmax, d4, 3).transpose(0, 3, 1, 2)
              .reshape(nlist, 3 * lmax, d4))
    probes = np.array([[2, 0], [3, 3]], np.int32)
    got = np.asarray(gather_lists(jnp.asarray(planes), jnp.asarray(probes),
                                  codec="sq6"))
    want = packed[probes].reshape(2, 2 * lmax, 3 * d4)
    np.testing.assert_array_equal(got, want)
    assert padded_lmax(planes, "sq6") == lmax


@pytest.mark.parametrize("nq,ncand,row_bytes,want", [
    (1024, 16 * 512, 1536 + 1536, 8),    # bounded by the memory share
    (8, 256, 64, 8),                     # the whole batch fits
    (48, 100, 8, 16),                    # a power of two dividing nq
])
def test_query_chunk_bounds_the_gathered_tile(nq, ncand, row_bytes, want):
    q = choose_padded_q_chunk(nq, ncand, row_bytes)
    assert q == want and nq % q == 0
