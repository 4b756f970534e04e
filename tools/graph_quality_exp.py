"""Graph build/walk quality ablation (CPU) — localizes the recall loss that
caps the HNSW analogue: build quality vs walk iterations vs
seeding, on uniform and clustered corpora.

Usage: python tools/graph_quality_exp.py [n] [d] [deg]
"""

from __future__ import annotations

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from duckdb_faiss_ext_tpu.ops.graph import (  # noqa: E402
    augment_graph, build_knn_graph, default_iters, graph_search)
from duckdb_faiss_ext_tpu.harness.datasets import synthetic_dataset  # noqa: E402


def recall_at(res_ids, gt, k=10):
    return float(np.mean([len(set(a[a >= 0][:k]) & set(b[:k])) / k
                          for a, b in zip(res_ids, gt)]))


def exact_gt(xb, xq, k=10):
    d2 = ((xq[:, None, :] - xb[None, :, :]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def walk(xb_dev, graph, xq, n, k=10, pool=64, iters=None, width=8):
    g = jnp.asarray(graph)
    s, p = graph_search(xb_dev, g, jnp.asarray(xq), n, k, "L2",
                        pool=pool, width=width, iters=iters)
    return np.asarray(p)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60000
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 96
    deg = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    nq, k = 256, 10
    rng = np.random.default_rng(3)

    for kind in ("uniform", "clustered"):
        if kind == "uniform":
            xb = rng.standard_normal((n, d)).astype(np.float32)
            xq = rng.standard_normal((nq, d)).astype(np.float32)
        else:
            xb, xq = synthetic_dataset(n, d, nq, seed=5)
        gt = exact_gt(xb, xq, k)
        xb_dev = jnp.asarray(xb)

        t0 = time.time()
        inter = 2 * deg
        knn = build_knn_graph(xb, inter, "L2")
        t_knn = time.time() - t0
        print(f"\n== {kind} {n}x{d} deg{deg} (knn build {t_knn:.1f}s) ==")

        g_base = augment_graph(knn, deg)

        for pool in (32, 64, 128):
            it0 = default_iters(pool, 8, deg)
            r_base = recall_at(walk(xb_dev, g_base, xq, n, k, pool), gt, k)
            r_iter2 = recall_at(
                walk(xb_dev, g_base, xq, n, k, pool, iters=2 * it0), gt, k)
            r_iter4 = recall_at(
                walk(xb_dev, g_base, xq, n, k, pool, iters=4 * it0), gt, k)
            # Oracle reachability probe: walk long with a huge width — any
            # remaining miss is a graph-connectivity (build) defect, not a
            # search-budget one.
            print(f"pool {pool:4d}: base {r_base:.3f}  2x-iters {r_iter2:.3f}"
                  f"  4x-iters {r_iter4:.3f}")

        # Reachability ceiling: pool=256, width=16, 4x iters
        it = 4 * default_iters(256, 16, deg)
        r_ceil = recall_at(walk(xb_dev, g_base, xq, n, k, 256,
                                iters=it, width=16), gt, k)
        print(f"ceiling (pool256 w16 iters{it}): {r_ceil:.3f}")

        # Variant: denser candidate graph (4x degree intermediate)
        knn4 = build_knn_graph(xb, 4 * deg, "L2")
        g_dense = augment_graph(knn4, deg)
        for pool in (64, 128):
            r = recall_at(walk(xb_dev, g_dense, xq, n, k, pool), gt, k)
            print(f"inter4x pool {pool:4d}: {r:.3f}")

        # Variant: all-forward (no reverse augmentation) at full degree
        g_fwd = np.ascontiguousarray(knn[:, :deg])
        for pool in (64, 128):
            r = recall_at(walk(xb_dev, g_fwd, xq, n, k, pool), gt, k)
            print(f"pure-knn pool {pool:4d}: {r:.3f}")


if __name__ == "__main__":
    main()
