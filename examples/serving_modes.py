#!/usr/bin/env python
"""Serving-mode tour: precision, reranks, the int8 SQ scan, batched
serving, and autotuning — the knobs that trade throughput for exactness.

    python examples/serving_modes.py      (CPU or GPU)
"""

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import duckdb_faiss_ext_tpu as dfx
from duckdb_faiss_ext_tpu.harness import autotune_index, recall_at_k

D, N, NQ, K = 96, 200_000, 256, 10

rng = np.random.default_rng(0)
centers = rng.standard_normal((256, D)).astype(np.float32) * 4
xb = (centers[rng.integers(0, 256, N)]
      + rng.standard_normal((N, D)).astype(np.float32))
xq = (centers[rng.integers(0, 256, NQ)]
      + rng.standard_normal((NQ, D)).astype(np.float32))


def bench(fn, reps=3):
    fn()                                    # warm the jit cache
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, reps * NQ / (time.perf_counter() - t0)


# Exact ground truth (parity precision = fp32 MXU accumulation).
dfx.faiss_create("flat", D, "Flat", metric_type="L2")
dfx.faiss_add(xb, "flat")
gt, qps = bench(lambda: dfx.faiss_search("flat", K, xq))
print(f"Flat parity (fp32-exact):            {qps:7.0f} qps")

# Fast mode: bf16 MXU scans; ~0.9 top-10 agreement with fp32.
dfx.set_precision("fast")
fast, qps = bench(lambda: dfx.faiss_search("flat", K, xq))
print(f"Flat fast (bf16):                    {qps:7.0f} qps  "
      f"recall@10 {recall_at_k(fast['label'], gt['label'], K):.3f}")

# Fast + rerank param: widened bf16 scan + fp32 re-score = exact again.
rr, qps = bench(lambda: dfx.faiss_search("flat", K, xq, {"rerank": "true"}))
print(f"Flat fast + rerank:                  {qps:7.0f} qps  "
      f"recall@10 {recall_at_k(rr['label'], gt['label'], K):.3f}")

# Batched serving: many batches dispatched, ONE packed fetch.
rb, qps = bench(lambda: dfx.faiss_search_batched("flat", K, xq,
                                                 batch_size=64))
print(f"Flat fast batched (4×b64, 1 fetch):  {qps:7.0f} qps")

# SQ8: 4× less memory; fast mode runs the int8-native MXU scan.
dfx.faiss_create("sq", D, "SQ8", metric_type="L2")
dfx.faiss_add(xb, "sq")
s8, qps = bench(lambda: dfx.faiss_search("sq", K, xq))
print(f"SQ8 fast (int8 MXU scan):            {qps:7.0f} qps  "
      f"recall@10 {recall_at_k(s8['label'], gt['label'], K):.3f}")
dfx.set_sq_dot("decode")
sd, qps = bench(lambda: dfx.faiss_search("sq", K, xq))
print(f"SQ8 fast (decode path, set_sq_dot):  {qps:7.0f} qps  "
      f"recall@10 {recall_at_k(sd['label'], gt['label'], K):.3f}")
dfx.set_sq_dot("auto")

# IVF: the fast-mode gather scan reranks in-chunk automatically.
dfx.faiss_create("ivf", D, "IVF512,Flat", metric_type="L2")
dfx.faiss_add(xb, "ivf")
iv, qps = bench(lambda: dfx.faiss_search("ivf", K, xq, {"nprobe": "32"}))
print(f"IVF512 fast nprobe=32:               {qps:7.0f} qps  "
      f"recall@10 {recall_at_k(iv['label'], gt['label'], K):.3f}")

# Autotune: cheapest setting reaching a recall target vs its own
# exhaustive scan (ParameterSpace/OperatingPoints analogue).
res = autotune_index("ivf", xq[:64], k=K, target_recall=0.95, repeat=1)
print("\nautotune (IVF512):")
print(res)

dfx.set_precision("parity")
