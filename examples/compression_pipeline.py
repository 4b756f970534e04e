#!/usr/bin/env python
"""Compression-pipeline showcase: OPQ rotation → IVF partition → PQ codes
→ exact RFlat re-rank, compared against the exact Flat oracle.

Demonstrates the full factory grammar on one workload:

    Flat                      — exact oracle, 4·d bytes/vector
    IVF64,PQ16                — 16 bytes/vector (32× compression at d=128)
    OPQ16,IVF64,PQ16          — + learned rotation (better codes)
    OPQ16,IVF64,PQ16,RFlat    — + exact re-rank of the candidates

Run: python examples/compression_pipeline.py   (CPU or GPU)
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import duckdb_faiss_ext_tpu as dfx

D, N, NQ, K = 128, 50_000, 64, 10

rng = np.random.default_rng(0)
# Anisotropic, clustered data — the regime real embeddings live in.
scales = np.linspace(2.5, 0.2, D).astype(np.float32)
centers = rng.standard_normal((64, D)).astype(np.float32) * scales * 2
xb = (centers[rng.integers(0, 64, N)]
      + rng.standard_normal((N, D)).astype(np.float32) * scales)
xq = (centers[rng.integers(0, 64, NQ)]
      + rng.standard_normal((NQ, D)).astype(np.float32) * scales)

dfx.faiss_create("oracle", D, "Flat", metric_type="L2")
dfx.faiss_add(xb, "oracle")
truth = dfx.faiss_search("oracle", K, xq)

CONFIGS = [
    ("IVF64,PQ16", {"nprobe": "16"}),
    ("OPQ16,IVF64,PQ16", {"nprobe": "16"}),
    ("OPQ16,IVF64,PQ16,RFlat", {"nprobe": "16", "k_factor": "8"}),
]

print(f"{'factory':34s} {'recall@10':>9s} {'build s':>8s} {'search ms':>9s}")
for desc, params in CONFIGS:
    name = desc.replace(",", "_")
    t0 = time.time()
    dfx.faiss_create(name, D, desc, metric_type="L2")
    dfx.faiss_add(xb, name)
    build = time.time() - t0
    res = dfx.faiss_search(name, K, xq, params)   # warm
    t0 = time.time()
    res = dfx.faiss_search(name, K, xq, params)
    ms = (time.time() - t0) * 1e3
    recall = np.mean([
        len(set(res["label"][q]) & set(truth["label"][q])) / K
        for q in range(NQ)])
    print(f"{desc:34s} {recall:9.3f} {build:8.1f} {ms:9.1f}")
