"""duckdb_faiss_ext_tpu — a vector-similarity-search engine on accelerators.

A from-scratch JAX/XLA rebuild of the capabilities of the
``duckdb-faiss-ext`` reference (a DuckDB extension embedding FAISS): named
index create/train/add/search/filtered-search/save/load/destroy over nine
distance metrics, with distance + top-k fused into device scans, IVF as
coarse-assign + list scans, filtered search as selection-vector semi-joins
fused into the scan, and multi-device scaling via sharded meshes with
distributed top-k merges.

Public surface mirrors the reference's 12 SQL functions (see api.py), plus
the index catalog, metric registry, factory parser, SQL filter tier, and the
parallel placement/search APIs.
"""


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives in ``.jax_cache`` at
    the root of the checkout (git-ignored), so repeat shapes compile once
    per checkout."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compile_cache()

from .api import (
    register_create_parameter,
    RESULT_DTYPE,
    create_mask,
    faiss_add,
    faiss_add_device,
    faiss_create,
    faiss_create_params,
    faiss_destroy,
    faiss_load,
    faiss_manual_train,
    faiss_range_search,
    faiss_train_device,
    faiss_save,
    faiss_search,
    faiss_search_batched,
    faiss_search_filter,
    faiss_search_filter_set,
    faiss_stats,
    faiss_to_device,
)
from .catalog import GLOBAL_CATALOG, Catalog, IndexEntry
from .errors import InvalidInputError
from .factory import build_index
from .metrics import metric_names, resolve_metric
from .ops.selectors import BitmapSelector, SetSelector
from .params import ParamMap
from .sql import Database, register_table
from .utils.config import set_precision, set_sq_dot

__version__ = "0.1.0"

__all__ = [
    "RESULT_DTYPE",
    "create_mask",
    "faiss_add",
    "faiss_add_device",
    "faiss_create",
    "faiss_create_params",
    "faiss_destroy",
    "faiss_load",
    "faiss_manual_train",
    "faiss_range_search",
    "faiss_train_device",
    "faiss_save",
    "faiss_search",
    "faiss_search_batched",
    "faiss_search_filter",
    "faiss_search_filter_set",
    "faiss_stats",
    "faiss_to_device",
    "GLOBAL_CATALOG",
    "Catalog",
    "IndexEntry",
    "InvalidInputError",
    "build_index",
    "metric_names",
    "resolve_metric",
    "BitmapSelector",
    "SetSelector",
    "ParamMap",
    "Database",
    "register_create_parameter",
    "register_table",
    "set_sq_dot",
    "set_precision",
]
