"""Metric registry: the nine distance metrics of the reference extension.

The reference maps metric-name strings to ``faiss::MetricType`` via a lookup
table (src/faiss_extension.cpp:54-94) and registers ``metric_type`` as the only
named create-parameter.  We keep the same names, the same default
(INNER_PRODUCT, src/faiss_extension.cpp:105), and the same "higher is better"
split: FAISS treats INNER_PRODUCT and Jaccard as similarity metrics and
everything else as distances to minimise.

Each metric also carries which kind of work dominates: L2 and
INNER_PRODUCT reduce to matmuls; the remaining seven are elementwise
reductions over (query, corpus, dim) tiles.
"""

from __future__ import annotations

import dataclasses

from . import errors


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    #: True when larger values are better (max top-k); FAISS calls these
    #: "similarity metrics" (INNER_PRODUCT, Jaccard).
    is_similarity: bool
    #: True when the pairwise scores lower to a matmul.
    uses_mxu: bool


# Registration order mirrors src/faiss_extension.cpp:58-68.
_REGISTRY: dict[str, Metric] = {}


def register_metric(metric: Metric) -> None:
    _REGISTRY[metric.name] = metric


for _name, _sim, _mxu in [
    ("INNER_PRODUCT", True, True),
    ("L2", False, True),
    ("L1", False, False),
    ("Linf", False, False),
    ("Lp", False, False),
    ("Canberra", False, False),
    ("BrayCurtis", False, False),
    ("JensenShannon", False, False),
    ("Jaccard", True, False),
]:
    register_metric(Metric(_name, _sim, _mxu))

DEFAULT_METRIC = "INNER_PRODUCT"


def resolve_metric(name: str) -> Metric:
    """Resolve a metric-name string, raising the reference's exact error for
    unknown names (src/faiss_extension.cpp:90, asserted by test/sql/faiss6.test:8-10)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise errors.unknown_metric(name) from None


def metric_names() -> list[str]:
    return list(_REGISTRY)
