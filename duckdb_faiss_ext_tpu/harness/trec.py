"""TREC run-file emission + scoring for accuracy conformance.

Port of the reference's create_trec tool (go/cmd/create_trec/main.go:32-48):
run a query set at k=1000 against a named index and emit the standard TREC
run format ``qid Q0 docid rank score runname``.  The reference scores its
run files externally with anserini-tools against TREC-DL19 qrels
(Makefile:73-75); no real MS MARCO data can reach this environment, so the
scoring half lives here too: ``score_trec_run`` computes the TREC-DL
headline metrics (MRR@10, nDCG@10, recall@k — trec_eval conventions) and
``make_synthetic_qrels`` freezes graded qrels from an exact search, giving
the create_index → save → load → create_trec → score flow a deterministic
conformance target (tools/marco_mini.py, tests/test_trec_flow.py)."""

from __future__ import annotations

import numpy as np

from .. import api


def write_trec_run(path: str, index_name: str, query_ids, queries,
                   k: int = 1000, run_name: str = "dfx",
                   params=None, catalog=None, batch: int = 256) -> None:
    query_ids = np.asarray(query_ids)
    queries = np.asarray(queries, dtype=np.float32)
    with open(path, "w") as f:
        for start in range(0, queries.shape[0], batch):
            qb = queries[start:start + batch]
            res = api.faiss_search(index_name, k, qb, params, catalog)
            for qi in range(qb.shape[0]):
                qid = query_ids[start + qi]
                for rank in range(k):
                    label = int(res["label"][qi, rank])
                    if label < 0:
                        break
                    score = float(res["distance"][qi, rank])
                    f.write(f"{qid} Q0 {label} {rank + 1} {score:.6f} "
                            f"{run_name}\n")


def read_trec_run(path: str) -> dict:
    """TREC run file → {qid: [(docid, rank, score), ...] rank-ascending}."""
    runs: dict = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 6:
                continue
            qid, _, docid, rank, score = parts[:5]
            runs.setdefault(qid, []).append((docid, int(rank), float(score)))
    for qid in runs:
        runs[qid].sort(key=lambda t: t[1])
    return runs


def write_qrels(path: str, qrels: dict) -> None:
    """{qid: {docid: grade}} → TREC qrels format ``qid 0 docid grade``."""
    with open(path, "w") as f:
        for qid in qrels:
            for docid, grade in qrels[qid].items():
                f.write(f"{qid} 0 {docid} {int(grade)}\n")


def read_qrels(path: str) -> dict:
    qrels: dict = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, docid, grade = parts[:4]
            qrels.setdefault(qid, {})[docid] = int(grade)
    return qrels


def make_synthetic_qrels(xb, xq, query_ids, *, metric: str = "L2",
                         graded=((3, 3), (7, 2), (20, 1))) -> dict:
    """Graded qrels from an exact search (the frozen-synthetic stand-in for
    TREC-DL19 judgments): per query the top-3 true neighbours get grade 3,
    the next 7 grade 2, the next 20 grade 1.  Row index = docid (the flow's
    create_index assigns sequential labels).  Chunked numpy — no device."""
    # float64 GEMM decomposition: ||q-b||^2 = ||q||^2 - 2 q.b + ||b||^2
    # (constant ||q||^2 dropped — per-query rank only).  The naive
    # (chunk, n, d) fp32 broadcast is ~38 GB at marco-mini's defaults;
    # float64 keeps near-tie ordering exact despite the cancellation.
    xb = np.asarray(xb, np.float64)
    xq = np.asarray(xq, np.float64)
    bnorm = (xb * xb).sum(-1)
    ktot = sum(n for n, _ in graded)
    qrels: dict = {}
    for s in range(0, xq.shape[0], 64):
        qs = xq[s:s + 64]
        if metric == "INNER_PRODUCT":
            score = qs @ xb.T
        else:
            score = 2.0 * (qs @ xb.T) - bnorm[None, :]
        top = np.argsort(-score, axis=1, kind="stable")[:, :ktot]
        for qi in range(qs.shape[0]):
            qid = str(query_ids[s + qi])
            g: dict = {}
            pos = 0
            for count, grade in graded:
                for docid in top[qi, pos:pos + count]:
                    g[str(int(docid))] = grade
                pos += count
            qrels[qid] = g
    return qrels


def score_trec_run(run_path: str, qrels: dict, *, mrr_k: int = 10,
                   ndcg_k: int = 10, recall_k: int = 1000) -> dict:
    """trec_eval-convention metrics of a run file against qrels:

    * ``mrr@10``     — reciprocal rank of the first relevant (grade>0) doc
    * ``ndcg@10``    — gain (2^grade − 1) / log2(rank + 1), ideal-normalised
    * ``recall@k``   — fraction of relevant docs retrieved in the top k

    Averaged over the qrels' queries (queries missing from the run score 0,
    like trec_eval -c)."""
    runs = read_trec_run(run_path)
    mrr = ndcg = recall = 0.0
    nq = len(qrels)
    for qid, judged in qrels.items():
        ranked = [docid for docid, _, _ in runs.get(qid, [])]
        rel = {d for d, g in judged.items() if g > 0}
        for i, docid in enumerate(ranked[:mrr_k]):
            if docid in rel:
                mrr += 1.0 / (i + 1)
                break
        gains = [(2 ** judged.get(d, 0)) - 1 for d in ranked[:ndcg_k]]
        dcg = sum(g / np.log2(i + 2) for i, g in enumerate(gains))
        ideal = sorted(((2 ** g) - 1 for g in judged.values()),
                       reverse=True)[:ndcg_k]
        idcg = sum(g / np.log2(i + 2) for i, g in enumerate(ideal))
        ndcg += dcg / idcg if idcg > 0 else 0.0
        if rel:
            recall += len(rel & set(ranked[:recall_k])) / len(rel)
    return {f"mrr@{mrr_k}": mrr / nq, f"ndcg@{ndcg_k}": ndcg / nq,
            f"recall@{recall_k}": recall / nq, "nq": nq}
