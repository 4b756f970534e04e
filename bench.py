"""Headline benchmark: Flat exact search QPS/chip at SIFT1M scale.

Workload: BASELINE.json config 2 — corpus 1M × 128-dim fp32 (CLUSTERED,
harness.datasets.synthetic_dataset, queries drawn near corpus clusters so
the supplementary IVF recall@10 is meaningful — a uniform-random corpus
makes any ANN recall number meaningless), query batch 48, k=10, fused
distance+top-k through the public API (the reference's hot path,
Index::search via src/faiss_extension.cpp:629-638).

Runs on one GPU and exits non-zero without one.  Prints the card's name and
power limit (nvidia-smi), then ONE JSON line to stdout: {"metric", "value",
"unit", "vs_baseline"} plus supplementary fields {"pipelined_qps",
"ivf_qps", "ivf_qps_b1024", "ivf_recall"} and the device JAX reports, so
the artifact carries the serving-path and ANN numbers, not only the
synchronous b48 point.  Details (large-batch QPS, build-rate
decomposition) go to stderr.

vs_baseline: ratio against a CPU brute-force stand-in for the reference's
FAISS-CPU path (BLAS sgemm + partial select via numpy), measured on this
host on a corpus subsample and scaled linearly to the full corpus size —
the reference publishes no absolute numbers.
"""

import json
import subprocess
import sys
import time

import numpy as np

N, D, K = 1_000_000, 128, 10
BATCH = 48
BIG_BATCH = 1024
BASELINE_SUBSAMPLE = 131_072


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_api(dfx, cat, name, queries, params=None, iters=10, groups=3):
    """Best of N measurement groups of ``iters`` synchronous searches."""
    dfx.faiss_search(name, K, queries, params, catalog=cat)  # warmup
    best = 0.0
    for _ in range(groups):
        t0 = time.perf_counter()
        for _ in range(iters):
            dfx.faiss_search(name, K, queries, params, catalog=cat)
        dt = (time.perf_counter() - t0) / iters
        best = max(best, queries.shape[0] / dt)
    return best


def measure_device(xb, xq, xq_big):
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.catalog import Catalog

    dfx.set_precision("fast")
    cat = Catalog()

    dfx.faiss_create("bench", D, "Flat", metric_type="L2", catalog=cat)
    t0 = time.perf_counter()
    dfx.faiss_add(xb, "bench", catalog=cat)
    dfx.faiss_search("bench", K, xq[:8], catalog=cat)  # force device build
    log(f"flat add+upload: {N/(time.perf_counter()-t0):.0f} vectors/s")

    qps48 = bench_api(dfx, cat, "bench", xq)
    log(f"flat qps b{BATCH}: {qps48:.1f}")
    qps_big = bench_api(dfx, cat, "bench", xq_big, iters=5)
    log(f"flat qps b{BIG_BATCH}: {qps_big:.1f}")

    # Pipelined serving path: many b48 requests in flight
    # (faiss_search_batched dispatches all, then gathers).
    big = np.tile(xq, (16, 1))
    dfx.faiss_search_batched("bench", K, big, batch_size=BATCH, catalog=cat)
    t0 = time.perf_counter()
    for _ in range(3):
        dfx.faiss_search_batched("bench", K, big, batch_size=BATCH,
                                 catalog=cat)
    qps_pipe = big.shape[0] * 3 / (time.perf_counter() - t0)
    log(f"flat qps pipelined 16×b{BATCH}: {qps_pipe:.1f}")

    # IVF: train on a subsample, add everything, one nprobe point.
    dfx.faiss_create("bench_ivf", D, "IVF4096,Flat", metric_type="L2",
                     catalog=cat)
    t0 = time.perf_counter()
    dfx.faiss_manual_train(xb[:262_144], "bench_ivf", catalog=cat)
    t_train = time.perf_counter() - t0
    # Decomposed ingest accounting: t_add = coarse assignment + host
    # bookkeeping; t_build = layout build + upload + first-search compiles.
    t0 = time.perf_counter()
    dfx.faiss_add(xb, "bench_ivf", catalog=cat)
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfx.faiss_search("bench_ivf", K, xq[:8], {"nprobe": "64"}, catalog=cat)
    t_build = time.perf_counter() - t0
    log(f"ivf train (4096 lists, 262k rows): {t_train:.1f}s; "
        f"assign+ingest {N/t_add:.0f} vec/s ({t_add:.1f}s); "
        f"layout build+upload {t_build:.1f}s incl. compile; "
        f"combined {N/(t_add+t_build):.0f} vec/s")
    qps_ivf = bench_api(dfx, cat, "bench_ivf", xq, {"nprobe": "64"})
    rf = dfx.faiss_search("bench", K, xq, catalog=cat)
    ri = dfx.faiss_search("bench_ivf", K, xq, {"nprobe": "64"}, catalog=cat)
    recall = float(np.mean([
        len(set(ri["label"][q]) & set(rf["label"][q])) / K
        for q in range(BATCH)]))
    log(f"ivf qps b{BATCH} nprobe=64: {qps_ivf:.1f} (recall@10 "
        f"{recall:.3f}, clustered corpus)")
    qps_ivf_big = bench_api(dfx, cat, "bench_ivf", xq_big,
                            {"nprobe": "64"}, iters=5)
    log(f"ivf qps b{BIG_BATCH} nprobe=64: {qps_ivf_big:.1f}")
    return qps48, qps_pipe, qps_ivf, recall, qps_ivf_big


def measure_cpu_baseline():
    rng = np.random.default_rng(7)
    xb = rng.standard_normal((BASELINE_SUBSAMPLE, D), dtype=np.float32)
    xq = rng.standard_normal((BATCH, D), dtype=np.float32)
    xb_norms = (xb * xb).sum(axis=1)

    def run():
        d = xb_norms[None, :] - 2.0 * (xq @ xb.T)
        idx = np.argpartition(d, K, axis=1)[:, :K]
        part = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(part, axis=1)
        return np.take_along_axis(idx, order, axis=1)

    run()
    best = float("inf")
    for _ in range(3):
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        best = min(best, (time.perf_counter() - t0) / iters)
    per_batch = best * (N / BASELINE_SUBSAMPLE)
    return BATCH / per_batch


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's default backend is {dev.platform}")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from duckdb_faiss_ext_tpu.harness.datasets import synthetic_dataset

    xb, xq_all = synthetic_dataset(N, D, nq=BATCH + BIG_BATCH, seed=42)
    xq, xq_big = xq_all[:BATCH], xq_all[BATCH:]
    qps, qps_pipe, qps_ivf, recall, qps_ivf_big = measure_device(
        xb, xq, xq_big)
    cpu_qps = measure_cpu_baseline()
    log(f"cpu baseline qps (scaled): {cpu_qps:.1f}")
    print(json.dumps({
        "metric": "flat_search_qps_sift1m_k10_b48",
        "value": qps,
        "unit": "queries/s/chip",
        "vs_baseline": qps / cpu_qps,
        "pipelined_qps": qps_pipe,
        "ivf_qps": qps_ivf,
        "ivf_qps_b1024": qps_ivf_big,
        "ivf_recall": recall,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
