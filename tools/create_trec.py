#!/usr/bin/env python
"""Run a query set against a saved index and emit a TREC run file.

Port of the reference's create_trec tool (go/cmd/create_trec/main.go:32-48):
the accuracy-conformance flow scored externally against qrels.

    python tools/create_trec.py --index idx.dfx --queries q.npy \
        --qids qids.txt --output run.trec --k 1000 [--params nprobe=15]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import duckdb_faiss_ext_tpu as dfx
from duckdb_faiss_ext_tpu.harness.datasets import load_fvecs
from duckdb_faiss_ext_tpu.harness.trec import write_trec_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--queries", required=True, help=".npy or .fvecs")
    ap.add_argument("--qids", default=None,
                    help="text file, one query id per line")
    ap.add_argument("--output", required=True)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--run-name", default="dfx")
    ap.add_argument("--params", default=None, help="e.g. nprobe=15")
    args = ap.parse_args(argv)

    q = (load_fvecs(args.queries) if args.queries.endswith(".fvecs")
         else np.load(args.queries).astype(np.float32))
    qids = (open(args.qids).read().split() if args.qids
            else [str(i) for i in range(q.shape[0])])
    params = (dict(kv.split("=", 1) for kv in args.params.split(","))
              if args.params else None)

    dfx.faiss_load("trec", args.index)
    write_trec_run(args.output, "trec", qids, q, k=args.k,
                   run_name=args.run_name, params=params)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
