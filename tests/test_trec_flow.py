"""End-to-end TREC accuracy-conformance flow at CI scale.

Drives the reference's accuracy pipeline shape (Makefile:73-99,
go/cmd/create_trec/main.go:32-48) on the frozen synthetic marco-mini
stand-in: generate → create_index (train+add+save) → faiss_load →
create_trec (run file) → score against exact-search qrels, asserting the
conformance scores — not just that the flow runs."""

import os
import sys

import numpy as np
import pytest

import duckdb_faiss_ext_tpu as dfx

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import marco_mini  # noqa: E402


@pytest.fixture(autouse=True)
def _cleanup():
    yield
    for name in ("build", "trec"):
        try:
            dfx.faiss_destroy(name)
        except Exception:
            pass


def _flow(tmp_path, factory, params, n=6000, d=48, nq=32, k=200):
    tmp_path.mkdir(parents=True, exist_ok=True)
    work = str(tmp_path)
    marco_mini.generate(work, n, d, nq, seed=9)
    return marco_mini.run_flow(work, factory, params, k=k,
                               train_fraction=0.5)


def test_exact_flat_flow_is_perfect(tmp_path):
    scores = _flow(tmp_path, "Flat", None)
    # Exact search retrieves the qrels' own ranking: every metric maxes.
    assert scores["mrr@10"] == pytest.approx(1.0)
    assert scores["ndcg@10"] == pytest.approx(1.0)
    assert scores["recall@200"] == pytest.approx(1.0)
    assert scores["nq"] == 32


def test_ivf_flow_meets_conformance_floor(tmp_path):
    scores = _flow(tmp_path, "IVF16,Flat", "nprobe=8")
    assert scores["mrr@10"] >= 0.9
    assert scores["ndcg@10"] >= 0.85
    assert scores["recall@200"] >= 0.9


def test_quantized_flow_discriminates(tmp_path):
    """A lossy-codec index must score strictly BELOW the exact flow's 1.0
    and above a floor — i.e. the conformance score actually measures
    ranking accuracy, not just plumbing (a saturated 1.000 can't catch a
    regression).  Calibrated on the frozen seed: IVF16,SQ8 nDCG@10
    0.9657, IVF16,SQ4 0.4345 (graded qrels punish within-top-10
    reordering that recall metrics miss)."""
    sq8 = _flow(tmp_path / "sq8", "IVF16,SQ8", "nprobe=8")
    assert 0.85 <= sq8["ndcg@10"] <= 0.995          # < 1: discriminating
    assert sq8["mrr@10"] >= 0.9
    for name in ("build", "trec"):                  # two flows, one test
        try:
            dfx.faiss_destroy(name)
        except Exception:
            pass
    sq4 = _flow(tmp_path / "sq4", "IVF16,SQ4", "nprobe=8")
    assert 0.30 <= sq4["ndcg@10"] <= 0.60           # int4 cap, stable seed
    assert 0.80 <= sq4["mrr@10"] <= 0.99
    # The codec ordering itself is a conformance signal.
    assert sq4["ndcg@10"] < sq8["ndcg@10"]


def test_scorer_against_hand_run(tmp_path):
    """score_trec_run agrees with hand-computed values on a tiny fixture."""
    from duckdb_faiss_ext_tpu.harness.trec import score_trec_run

    run = tmp_path / "run.trec"
    run.write_text(
        "1 Q0 5 1 9.0 t\n"      # grade 2 at rank 1
        "1 Q0 7 2 8.0 t\n"      # unjudged
        "1 Q0 6 3 7.0 t\n"      # grade 1 at rank 3
        "2 Q0 9 1 5.0 t\n"      # unjudged: q2 has no relevant retrieved
    )
    qrels = {"1": {"5": 2, "6": 1}, "2": {"8": 1}}
    s = score_trec_run(str(run), qrels, mrr_k=10, ndcg_k=10, recall_k=10)
    assert s["mrr@10"] == pytest.approx(0.5)          # (1/1 + 0) / 2
    dcg = 3.0 / np.log2(2) + 1.0 / np.log2(4)
    idcg = 3.0 / np.log2(2) + 1.0 / np.log2(3)
    assert s["ndcg@10"] == pytest.approx((dcg / idcg) / 2)
    assert s["recall@10"] == pytest.approx(0.5)       # q1: 2/2, q2: 0/1
