"""Multi-host primitives: hash partitioning and the host-side top-k merge
(single-process; the distributed bootstrap is exercised by the driver)."""

import numpy as np
import pytest

from duckdb_faiss_ext_tpu.native import load_native
from duckdb_faiss_ext_tpu.parallel.multihost import (hash_partition,
                                                     local_rows,
                                                     merge_host_topk)


def test_hash_partition_uniform_and_deterministic():
    ids = np.arange(100_000, dtype=np.int64)
    parts = hash_partition(ids, 8)
    counts = np.bincount(parts, minlength=8)
    assert counts.min() > 100_000 / 8 * 0.9
    np.testing.assert_array_equal(parts, hash_partition(ids, 8))
    # Every row owned by exactly one partition.
    owned = np.zeros(ids.size, dtype=int)
    for p in range(8):
        owned += local_rows(ids, 8, p)
    assert (owned == 1).all()


def _merge_oracle(dists, labels, descending, k):
    s, nq, kk = dists.shape
    fd = dists.transpose(1, 0, 2).reshape(nq, s * kk)
    fl = labels.transpose(1, 0, 2).reshape(nq, s * kk)
    key = np.where(fl < 0, -np.inf if descending else np.inf, fd)
    order = np.argsort(-key if descending else key, axis=1,
                       kind="stable")[:, :k]
    return np.take_along_axis(fd, order, 1), np.take_along_axis(fl, order, 1)


@pytest.mark.parametrize("metric,descending", [("L2", False),
                                               ("INNER_PRODUCT", True)])
def test_merge_host_topk(metric, descending):
    rng = np.random.default_rng(9)
    s, nq, k = 4, 6, 5
    # Build sorted per-shard lists with some exhausted (-1) tails.
    dists = np.sort(rng.random((s, nq, k)).astype(np.float32), axis=2)
    if descending:
        dists = dists[:, :, ::-1].copy()
    labels = rng.integers(0, 10_000, (s, nq, k)).astype(np.int64)
    labels[0, :, 3:] = -1  # shard 0 found only 3

    got_d, got_l = merge_host_topk(dists, labels, metric)
    exp_d, exp_l = _merge_oracle(dists, labels, descending, k)
    np.testing.assert_allclose(got_d, exp_d, rtol=1e-6)
    # labels may differ on exact distance ties; values must match
    np.testing.assert_allclose(
        np.sort(got_d, axis=1), np.sort(exp_d, axis=1), rtol=1e-6)


def test_native_merge_matches_numpy_fallback():
    native = load_native()
    if native is None:
        pytest.skip("native library unavailable (no g++)")
    rng = np.random.default_rng(10)
    s, nq, k = 3, 4, 6
    dists = np.sort(rng.random((s, nq, k)).astype(np.float32), axis=2)
    labels = rng.integers(0, 100, (s, nq, k)).astype(np.int64)
    nat = native.merge_topk(np.ascontiguousarray(dists),
                            np.ascontiguousarray(labels), False)
    exp = _merge_oracle(dists, labels, False, k)
    np.testing.assert_allclose(nat[0], exp[0], rtol=1e-6)


def test_partitioned_index_matches_single(catalog):
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.factory import build_index
    from duckdb_faiss_ext_tpu.metrics import resolve_metric
    from duckdb_faiss_ext_tpu.parallel.multihost import PartitionedIndex

    rng = np.random.default_rng(3)
    d, n, nq, k = 16, 2000, 6, 8
    xb = rng.standard_normal((n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) * 3 + 11
    xq = rng.standard_normal((nq, d)).astype(np.float32)
    metric = resolve_metric("L2")

    single = build_index(d, "IDMap,Flat", metric)
    single.add_with_ids(xb, ids)
    ref = single.search(xq, k)

    part = PartitionedIndex(
        [build_index(d, "IDMap,Flat", metric) for _ in range(4)])
    part.add_with_ids(xb, ids)
    assert part.ntotal == n
    got = part.search(xq, k)
    np.testing.assert_allclose(got.distances, ref.distances, rtol=1e-5)
    # Same label sets (ties may order differently across partitions).
    for q in range(nq):
        assert set(got.labels[q]) == set(ref.labels[q])


def test_two_process_distributed_search():
    """Run the real jax.distributed 2-process demo (CPU, Gloo collectives)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DFX_DEMO_PORT="12411")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "multihost_demo.py")],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MULTIHOST OK" in out.stdout, out.stdout[-2000:]
