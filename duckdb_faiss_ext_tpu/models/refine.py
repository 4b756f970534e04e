"""Refine-Flat wrapper: exact re-ranking of a compressed base index.

Equivalent of faiss::IndexRefineFlat, reachable in the reference through any
``...,RFlat`` factory string (the reference forwards factory strings to
faiss::index_factory verbatim, src/faiss_extension.cpp:154-155, so the whole
grammar is its observable surface).  The base index (PQ / SQ / IVFPQ …)
produces k·k_factor approximate candidates; the wrapper re-scores them
against raw fp32 vectors and returns the exact top-k.

Device design: the raw store reuses FlatIndex (padded capacity-bucketed device
buffer); the re-rank is one jitted gather + distance tile + top_k over the
(nq, k_base) candidate set — matmul work over a tiny tensor, no host math.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import SIMILARITY_METRICS
from ..params import EMPTY
from ..utils.config import config, next_pow2, pad_rows
from ..utils.transfer import fetch_results
from .base import Index, SearchResult, as_matrix
from .flat import FlatIndex


@functools.partial(jax.jit, static_argnames=("k", "metric", "precision"))
def _rerank(xb, labels, xq, metric_arg, *, k, metric, precision):
    """Exact re-rank: score xq against xb[labels] (candidates from the base
    index; label -1 = missing stays missing), return best-first top-k."""
    from ..ops.distance import elementwise_scores
    from ..ops.flat_search import _NEG_INF

    nq, kb = labels.shape
    safe = jnp.maximum(labels, 0)
    xc = xb[safe]                                     # (nq, kb, d)
    if metric == "INNER_PRODUCT":
        s = jnp.einsum("qd,qcd->qc", xq, xc, precision=precision,
                       preferred_element_type=jnp.float32)
    elif metric == "L2":
        diff = xc - xq[:, None, :]
        s = -jnp.sum(diff * diff, axis=-1)
    else:
        d = elementwise_scores(xq[:, None, :], xc, metric, metric_arg)
        s = d if metric in SIMILARITY_METRICS else -d
    s = jnp.where(labels >= 0, s, _NEG_INF)
    best, sel = lax.top_k(s, k)
    pos = jnp.take_along_axis(labels, sel, axis=1)
    pos = jnp.where(jnp.isneginf(best), -1, pos)
    sim = metric in SIMILARITY_METRICS
    dist = best if sim else -best
    sentinel = _NEG_INF if sim else -_NEG_INF
    dist = jnp.where(pos < 0, sentinel, dist)
    return dist, pos


class RefineFlatIndex(Index):
    """IndexRefineFlat analogue: base candidates re-scored on raw vectors."""

    def __init__(self, base: Index):
        super().__init__(base.d, base.metric, base.metric_arg)
        self.base = base
        self.k_factor_default = 1.0   # faiss::IndexRefineFlat::k_factor
        self.refine = FlatIndex(base.d, base.metric, base.metric_arg)

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.base.ntotal

    @property
    def is_trained(self) -> bool:
        return self.base.is_trained

    @property
    def requires_training(self) -> bool:
        return self.base.requires_training

    def train(self, x) -> None:
        self.base.train(x)

    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        self.base.add(x)
        self.refine.add(x)

    def reconstruct(self, key: int) -> np.ndarray:
        return self.refine.reconstruct(key)

    def row_labels(self) -> np.ndarray:
        return self.base.row_labels()

    def apply_create_params(self, params) -> None:
        self.base.apply_create_params(params)

    # --- search ----------------------------------------------------------
    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        sim = self.metric.name in SIMILARITY_METRICS
        sentinel = float("-inf") if sim else float("inf")
        if nq == 0 or k <= 0 or self.ntotal == 0:
            base = self.base.search(xq, k, params, selector)
            return base
        k_factor = params.get_float("k_factor", self.k_factor_default)
        if k_factor < 1.0:
            raise errors.InvalidInputError(
                f"k_factor must be >= 1 (got {k_factor})")
        k_base = min(max(k, int(round(k * k_factor))), self.ntotal)
        base = self.base.search(xq, k_base, params, selector)
        # Base labels are storage positions for every wrappable base (PQ,
        # SQ, IVF with implicit sequential ids) — same contract as
        # faiss::IndexRefine, which indexes its refine storage by them.
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        labels = np.full((nq_pad, k_base), -1, np.int64)
        labels[:nq] = base.labels
        dist, pos = _rerank(
            self.refine.device_vectors(),
            jnp.asarray(labels.astype(np.int32)),
            jnp.asarray(pad_rows(xq, nq_pad)),
            jnp.asarray(self.metric_arg, jnp.float32),
            k=min(k, k_base), metric=self.metric.name,
            # Always fp32-exact: re-ranking exists to restore exactness
            # (faiss::IndexRefineFlat computes raw fp32 distances), and the
            # candidate tensor is tiny — HIGHEST costs nothing even when
            # the global mode is "fast".
            precision=lax.Precision.HIGHEST)
        dist, pos = fetch_results(dist, pos)
        dist = dist[:nq]
        labels_out = pos[:nq].astype(np.int64)
        if labels_out.shape[1] < k:
            pad = k - labels_out.shape[1]
            dist = np.concatenate(
                [dist, np.full((nq, pad), sentinel, np.float32)], axis=1)
            labels_out = np.concatenate(
                [labels_out, np.full((nq, pad), -1, np.int64)], axis=1)
        return SearchResult(dist, labels_out)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(),
                "refine_xb": self.refine.vectors()}

    def load_state(self, state: dict) -> None:
        self.base.load_state(state.get("base", {}))
        self.refine.load_state({"xb": state["refine_xb"]})


def _refine_range_search(self, xq, radius, params=EMPTY, selector=None):
    # Exact by construction: the raw store answers directly.
    return self.refine.range_search(xq, radius, params, selector)


RefineFlatIndex.range_search = _refine_range_search
