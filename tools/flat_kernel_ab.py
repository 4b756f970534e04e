"""A/B of the fused Flat top-k kernel against the XLA scan, on one GPU.

Times ``faiss_search`` end to end on a 1,000,000 x 128 L2 Flat index at
batches 48 and 1024 in fast precision (the only mode the kernel serves),
through the fused kernel (ops/flat_topk.py) and through the XLA scan
(ops/flat_search.py): ``--pairs`` pairs, alternating which side runs
first, each side the median of ``--reps`` calls.  Reports both sides'
medians and quartiles, the pairs the kernel won, and each side's recall@10
against the parity-mode XLA ids.

Prints the card's name and power limit, then one JSON line per
measurement.  Exits non-zero without a GPU.

Usage:
    python tools/flat_kernel_ab.py [--pairs 10] [--reps 10]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def median_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print("no GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.catalog import Catalog
    from duckdb_faiss_ext_tpu.harness.datasets import synthetic_dataset
    from duckdb_faiss_ext_tpu.models import flat as flat_mod

    n, d, k = 1_000_000, 128, 10
    xb, xq = synthetic_dataset(n, d, nq=48 + 1024, seed=42)
    cat = Catalog()
    dfx.faiss_create("ab", d, "Flat", metric_type="L2", catalog=cat)
    dfx.faiss_add(xb, "ab", catalog=cat)
    choose = flat_mod.use_fused_kernel

    def run(q, fused):
        flat_mod.use_fused_kernel = (choose if fused
                                     else lambda *a, **kw: False)
        try:
            return dfx.faiss_search("ab", k, q, catalog=cat)
        finally:
            flat_mod.use_fused_kernel = choose

    for q in (xq[:48], xq[48:]):
        exact = dfx.faiss_search("ab", k, q, catalog=cat)["label"]
        dfx.set_precision("fast")
        recall = {}
        for side, fused in (("kernel", True), ("xla", False)):
            got = run(q, fused)["label"]
            recall[side] = float(np.mean(
                [len(set(got[i]) & set(exact[i])) / k
                 for i in range(q.shape[0])]))
        times = {"kernel": [], "xla": []}
        wins = 0
        for p in range(args.pairs):
            order = ("kernel", "xla") if p % 2 == 0 else ("xla", "kernel")
            for side in order:
                times[side].append(median_ms(
                    lambda: run(q, side == "kernel"), args.reps))
            wins += times["kernel"][-1] < times["xla"][-1]
        dfx.set_precision("parity")
        print(json.dumps({
            "measure": "flat faiss_search", "shape": [n, d], "k": k,
            "batch": q.shape[0], "mode": "fast", "pairs": args.pairs,
            "reps": args.reps, "kernel_wins": int(wins),
            "kernel_ms_quartiles": np.percentile(
                times["kernel"], [25, 50, 75]).tolist(),
            "xla_ms_quartiles": np.percentile(
                times["xla"], [25, 50, 75]).tolist(),
            "kernel_ms": times["kernel"], "xla_ms": times["xla"],
            "recall_vs_exact": recall}), flush=True)

    return 0


if __name__ == "__main__":
    sys.exit(main())
