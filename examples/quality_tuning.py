#!/usr/bin/env python
"""Recall-tuning showcase: the beyond-FAISS quality knobs on one workload.

Compares, against the exact Flat oracle at a fixed candidate budget:

    IVF256,Flat                      — baseline partition
    IVF256,Flat + soar_lambda=1.0    — SOAR dual assignment (2x storage,
                                       ~2x effective nprobe)
    IVF16,PQ8                        — compressed baseline
    IVF16,PQ8 + anisotropic_eta=4.0  — ScaNN-style score-aware residual
                                       codebooks (inner-product search)
    RQ8x8                            — additive residual quantizer
                                       (beam-search encode)
    HNSW32 (graph walk)              — CAGRA-style batched graph ANN
                                       (efSearch = candidate pool)

Run: python examples/quality_tuning.py   (CPU or GPU)
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import duckdb_faiss_ext_tpu as dfx

D, N, NQ, K = 64, 40_000, 128, 10

rng = np.random.default_rng(0)
centers = rng.standard_normal((128, D)).astype(np.float32)
centers /= np.linalg.norm(centers, axis=1, keepdims=True)
xb = (centers[rng.integers(0, 128, N)] * 2.0
      + rng.standard_normal((N, D)).astype(np.float32) * 0.35)
xq = (centers[rng.integers(0, 128, NQ)] * 2.0
      + rng.standard_normal((NQ, D)).astype(np.float32) * 0.35)

dfx.faiss_create("oracle", D, "Flat", metric_type="INNER_PRODUCT")
dfx.faiss_add(xb, "oracle")
truth = dfx.faiss_search("oracle", K, xq)["label"]


def run(name, desc, create_params, search_params):
    dfx.faiss_create_params(name, D, desc, create_params,
                            metric_type="INNER_PRODUCT")
    t0 = time.perf_counter()
    dfx.faiss_add(xb, name)
    dfx.faiss_search(name, 1, xq[:1], search_params)  # force lazy builds
    build = time.perf_counter() - t0
    got = dfx.faiss_search(name, K, xq, search_params)["label"]
    recall = np.mean([len(set(g) & set(t)) / K for g, t in zip(got, truth)])
    print(f"{desc:14s} {str(create_params):34s} recall@{K} {recall:.3f}  "
          f"(build {build:.1f}s)")
    return recall


print(f"corpus {N}x{D}, {NQ} queries, INNER_PRODUCT, k={K}\n")
base = run("ivfp", "IVF256,Flat", {}, {"nprobe": "8"})
soar = run("ivfs", "IVF256,Flat", {"soar_lambda": "1.0"}, {"nprobe": "8"})
pq = run("pqp", "IVF16,PQ8", {}, {"nprobe": "16"})
aniso = run("pqa", "IVF16,PQ8", {"anisotropic_eta": "4.0"},
            {"nprobe": "16"})
rq = run("rq", "RQ8x8", {"beam": "4"}, {})
graph = run("hnswg", "HNSW32", {"ann_threshold": "10000"},
            {"efSearch": "64"})

assert soar >= base and aniso >= pq - 0.02
assert graph >= base  # the graph walk beats an equal-effort IVF probe
print("\nSOAR and anisotropic quantization lift recall at the same "
      "candidate budget; RQ trades build time for byte-code accuracy.")
