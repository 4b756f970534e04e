"""LSH index model: sign-random-projection binary codes, matmul Hamming search.

Equivalent of ``faiss::IndexLSH`` (factory ``LSH`` / ``LSHr`` / ``LSHt`` /
``LSHrt``), reachable through the reference because it forwards any factory
string to ``faiss::index_factory`` (src/faiss_extension.cpp:154-155).
Semantics mirrored: ``nbits`` defaults to ``d``; the ``r`` suffix applies a
random rotation before binarization; the ``t`` suffix trains per-bit
thresholds (making the index require training); distances returned are
Hamming counts as float32; the metric argument is ignored (FAISS IndexLSH
always ranks by Hamming distance).

Device design — no bit-twiddling popcount loop: codes are stored as ±1
rows in an inner :class:`FlatIndex` with INNER_PRODUCT ordering, because for
±1 vectors ``hamming(a, b) = (nbits − a·b) / 2``.  The whole search is the
same fused matmul + top-k kernel as Flat (max dot product == min
Hamming), followed by one affine transform on device, so it inherits the
Pallas/XLA kernel dispatch, selector masks, and the single-fetch serving
tier.  Engine extension beyond the FAISS grammar: an explicit bit count
(``LSH64``) is accepted.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import errors
from ..metrics import Metric, resolve_metric
from ..params import EMPTY
from .base import Index, SearchResult, as_matrix
from .flat import FlatIndex

#: seed for the random rotation (deterministic per (d, nbits) so factory
#: rebuilds agree; the rotation is also persisted in the checkpoint).
ROTATION_SEED = 1234


class LSHIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 nbits: int | None = None, rotate: bool = False,
                 train_thresholds: bool = False):
        # FAISS IndexLSH has no metric parameter — results are Hamming
        # distances (ascending).  Force L2 ordering semantics regardless of
        # the create-time metric (the reference's default is INNER_PRODUCT,
        # which would invert the ranking).
        super().__init__(d, resolve_metric("L2"), metric_arg)
        self.nbits = int(d) if nbits is None else int(nbits)
        if self.nbits <= 0:
            raise errors.InvalidInputError(
                f"LSH bit count must be positive, got {self.nbits}")
        self.rotate = bool(rotate)
        self.train_thresholds = bool(train_thresholds)
        self._thresholds: np.ndarray | None = None
        if self.rotate or self.nbits != d:
            from ..transforms import RandomRotationMatrix

            self._rot = RandomRotationMatrix(d, self.nbits,
                                             seed=ROTATION_SEED).A
        else:
            self._rot = None
        #: ±1 code rows stored int8 (exact int8 dot at 4× less HBM than
        #: fp32); INNER_PRODUCT so max dot == min Hamming.
        self._codes = FlatIndex(self.nbits, resolve_metric("INNER_PRODUCT"),
                                storage="pm1_i8")

    def shard_over(self, mesh) -> None:
        """faiss_to_gpu analogue: the ±1 code corpus (an inner IP Flat
        index) is row-sharded like any Flat placement."""
        from .base import row_placement

        self._codes.set_placement(row_placement(mesh))
        self._codes.device_vectors()

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self._codes.ntotal

    @property
    def is_trained(self) -> bool:
        return not self.train_thresholds or self._thresholds is not None

    @property
    def requires_training(self) -> bool:
        return self.train_thresholds

    def train(self, x) -> None:
        if self.is_trained:
            return
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            raise errors.TrainingTooSmallError(0, 1)
        self._thresholds = self._project(x).mean(axis=0)

    def _project(self, x: np.ndarray) -> np.ndarray:
        if self._rot is not None:
            return x @ self._rot
        return x[:, :self.nbits]

    def _encode(self, x: np.ndarray) -> np.ndarray:
        """(n, d) float32 → (n, nbits) ±1 float32 sign codes."""
        p = self._project(x)
        if self._thresholds is not None:
            p = p - self._thresholds
        return np.where(p > 0, np.float32(1), np.float32(-1))

    def add(self, x) -> None:
        if not self.is_trained:
            raise errors.InvalidInputError(
                "Index is not trained; call train (or faiss_manual_train) "
                "before adding or searching")
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        self._codes.add(self._encode(x))

    # --- search ----------------------------------------------------------
    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        return self._finish_dispatch(
            self.search_dispatch(xq, k, params, selector), xq, k)

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """Raw device dispatch for the single-fetch serving tier: the inner
        ±1 dot-product top-k, distances mapped to Hamming on device.  The
        inner IP padding sentinel (-inf) maps to +inf, exactly the L2/Hamming
        missing-slot sentinel."""
        if not self.is_trained:
            raise errors.InvalidInputError(
                "Index is not trained; call train (or faiss_manual_train) "
                "before adding or searching")
        xq = as_matrix(xq, self.d)
        disp = self._codes.search_dispatch(self._encode(xq), k, params,
                                           selector)
        if disp is None:
            return None
        dist_dev, pos_dev, nq, k_eff = disp[:4]
        ham_dev = (jnp.float32(self.nbits) - dist_dev) * jnp.float32(0.5)
        return (ham_dev, pos_dev, nq, k_eff)

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        signs = self._codes.vectors() > 0
        state = {
            "code_bits": np.packbits(signs, axis=1),
            "ntotal": np.int64(self.ntotal),
        }
        if self._rot is not None:
            state["rot"] = self._rot
        if self._thresholds is not None:
            state["thresholds"] = self._thresholds
        return state

    def load_state(self, state: dict) -> None:
        n = int(state["ntotal"])
        bits = np.unpackbits(np.asarray(state["code_bits"], np.uint8),
                             axis=1)[:, :self.nbits]
        rot = state.get("rot")
        if rot is not None:
            self._rot = np.asarray(rot, np.float32)
        thr = state.get("thresholds")
        if thr is not None:
            self._thresholds = np.asarray(thr, np.float32)
        self._codes = FlatIndex(self.nbits, resolve_metric("INNER_PRODUCT"),
                                storage="pm1_i8")
        if n:
            self._codes.add(np.where(bits[:n].astype(bool),
                                     np.float32(1), np.float32(-1)))
