"""Scalar-quantizer index models: SQ8, SQ4, SQ6, SQfp16 and SQbf16.

Equivalent of faiss::IndexScalarQuantizer (factory ``SQ8`` / ``SQ4`` /
``SQ6`` / ``SQfp16`` / ``SQbf16``).  The quantized types require training
(per-dim ranges); the float codecs (fp16, and bf16 — the matmul type,
an engine extension matching faiss QT_bf16) are training-free.  Codes are the only storage — SQ4/SQ6 are
bit-packed (ops/sq.py packing layouts), true compression matching the FAISS
memory profile; search decodes chunks on the fly into the matmul distance tile
(ops/sq.py).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import (choose_chunk,
                               finalize_scores)
from ..ops.sq import (SQ_LEVELS, sq4_pack, sq6_pack, sq_code_width,
                      sq_decode, sq_quantize, sq_search, sq_train)
from ..params import EMPTY
from ..utils.config import (config, next_capacity, next_pow2,
                            pad_rows)
from ..utils.transfer import upload_queries
from .base import Index, SearchResult, as_matrix

#: training-free float codecs; bf16 is the matmul storage type.
FLOAT_SQ_TYPES = ("SQfp16", "SQbf16")


def _float_dtype(qtype: str):
    from ..ops.sq import float_codec_dtype

    return float_codec_dtype(qtype[2:])


class SQIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float = 0.0,
                 qtype: str = "SQ8"):
        super().__init__(d, metric, metric_arg)
        if qtype not in ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16"):
            raise errors.InvalidInputError(
                f"Scalar quantizer type {qtype} is not supported "
                f"(use SQ8, SQ4, SQ6, SQfp16 or SQbf16)")
        self.qtype = qtype
        self.codec = qtype[2:] if qtype in FLOAT_SQ_TYPES else qtype.lower()
        self._vmin: np.ndarray | None = None
        self._scale: np.ndarray | None = None
        if qtype in FLOAT_SQ_TYPES:
            self._codes = np.empty((0, d), dtype=_float_dtype(qtype))
        else:
            self._codes = np.empty((0, sq_code_width(d, self.codec)),
                                   dtype=np.uint8)
        self._version = 0
        self._device = None
        self._placement = None
        self._mask_cache: dict = {}

    @property
    def ntotal(self) -> int:
        return self._codes.shape[0]

    @property
    def is_trained(self) -> bool:
        return self.qtype in FLOAT_SQ_TYPES or self._vmin is not None

    @property
    def requires_training(self) -> bool:
        return self.qtype not in FLOAT_SQ_TYPES

    def train(self, x) -> None:
        if self.is_trained:
            return
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            raise errors.TrainingTooSmallError(0, 1)
        vmin, scale = sq_train(x, SQ_LEVELS[self.codec])
        self._vmin = np.asarray(vmin)
        self._scale = np.asarray(scale)
        self._invalidate()

    def add(self, x) -> None:
        if not self.is_trained:
            raise errors.InvalidInputError(
                "Index is not trained; call train (or faiss_manual_train) "
                "before adding or searching")
        x = as_matrix(x, self.d)
        if x.shape[0] == 0:
            return
        if self.qtype in FLOAT_SQ_TYPES:
            codes = x.astype(_float_dtype(self.qtype))
        else:
            q = np.asarray(sq_quantize(jnp.asarray(x),
                                       jnp.asarray(self._vmin),
                                       jnp.asarray(self._scale),
                                       levels=SQ_LEVELS[self.codec]))
            if self.qtype == "SQ4":
                codes = sq4_pack(q)
            elif self.qtype == "SQ6":
                codes = sq6_pack(q)
            else:
                codes = q
        self._codes = np.concatenate([self._codes, codes], axis=0)
        self._invalidate()

    def reconstruct(self, key: int) -> np.ndarray:
        if self.qtype in FLOAT_SQ_TYPES:
            return self._codes[key].astype(np.float32)
        return np.asarray(sq_decode(jnp.asarray(self._codes[key:key + 1]),
                                    jnp.asarray(self._vmin),
                                    jnp.asarray(self._scale), self.codec))[0]

    def _invalidate(self):
        self._version += 1
        self._device = None
        self._int8_state = None
        self._mask_cache.clear()

    def _int8_rows_dev(self):
        """Per-row (Σ(scale·c)², Σc) fp32 (cap,) pair for the int8 matmul
        scan, which reads the SAME packed device code buffer as the decode
        path (see ops/sq.py::sq_int8_search) — this is its only extra
        state."""
        cached = getattr(self, "_int8_state", None)
        if cached is not None:
            return cached
        from ..ops.sq import sq_row_norms, sq_row_sums

        cap = self._capacity()
        rn = sq_row_norms(self._codes, self._scale, self.d, self.codec)
        rs = sq_row_sums(self._codes, self.d, self.codec)
        self._int8_state = (jnp.asarray(pad_rows(rn, cap)),
                            jnp.asarray(pad_rows(rs, cap)))
        return self._int8_state

    def _capacity(self) -> int:
        from .base import placement_capacity

        return placement_capacity(
            max(config.min_capacity, next_capacity(max(self.ntotal, 1))),
            self._placement)

    def _device_state(self):
        if self._device is None:
            cap = self._capacity()
            if self.qtype not in FLOAT_SQ_TYPES:
                vmin = jnp.asarray(self._vmin)
                scale = jnp.asarray(self._scale)
            else:
                vmin = scale = jnp.zeros((self.d,), jnp.float32)
            codes = pad_rows(self._codes, cap)
            if self._placement is not None:
                import jax

                codes_dev = jax.device_put(codes, self._placement)
            else:
                codes_dev = jnp.asarray(codes)
            self._device = (codes_dev, vmin, scale)
        return self._device

    def shard_over(self, mesh) -> None:
        """faiss_to_gpu analogue: packed codes row-sharded over the mesh,
        (vmin, scale) replicated; the decode+scan partitions under GSPMD
        like the Flat path."""
        from .base import row_placement

        self._placement = row_placement(mesh)
        self._device = None
        self._mask_cache.clear()
        if self.is_trained:
            self._device_state()

    def search(self, xq, k, params=EMPTY, selector=None) -> SearchResult:
        return self._finish_dispatch(
            self.search_dispatch(xq, k, params, selector), xq, k)

    def search_dispatch(self, xq, k, params=EMPTY, selector=None):
        """Raw device dispatch for the single-fetch serving tier."""
        if not self.is_trained:
            raise errors.InvalidInputError(
                "Index is not trained; call train (or faiss_manual_train) "
                "before adding or searching")
        xq = as_matrix(xq, self.d)
        nq = xq.shape[0]
        k = int(k)
        if nq == 0 or k <= 0:
            return None

        cap = self._capacity()
        k_eff = min(k, cap)
        nq_pad = max(config.min_query_bucket, next_pow2(nq))
        xq_pad = upload_queries(
            pad_rows(xq, nq_pad),
            lossy_ok=self.codec in ("sq8", "sq4", "sq6"))
        mask = None
        if selector is not None:
            key = (selector.cache_key(), self._version)
            mask = self._mask_cache.get(key)
            if mask is None:
                rows = selector.contains(self.row_labels())
                mask = jnp.asarray(pad_rows(rows, cap, fill=False))
                self._mask_cache = {key: mask}
        chunk = choose_chunk(cap, nq_pad, self.d, self.metric.name)
        # The corpus-chunked loops run cap // chunk steps: clamp to the
        # largest power-of-two divisor of cap (1M-step capacities above
        # 2^20 rows are not powers of two) so no tail rows are skipped.
        chunk = min(chunk, cap & -cap)
        if cap % chunk:
            chunk = cap

        from ..utils.config import sq_int8_active

        if (self.codec in ("sq8", "sq4", "sq6")
                and self.metric.name in ("L2", "INNER_PRODUCT")
                and self.d >= 16         # tiny-d margins sit at the int8 noise floor
                and self._placement is None
                and sq_int8_active()):
            from ..ops.sq import sq_int8_search

            codes_dev, vmin, scale = self._device_state()  # shared buffer
            rn, rs = self._int8_rows_dev()
            k_scan = min(cap, max(4 * k_eff, k_eff + 32))
            scores, pos = sq_int8_search(
                codes_dev, rn, rs, jnp.int32(self.ntotal), vmin, scale,
                xq_pad,
                mask, jnp.asarray(self.metric_arg, jnp.float32),
                k=k_eff, k_scan=k_scan, metric=self.metric.name,
                chunk=chunk, codec=self.codec)
        else:
            codes_dev, vmin, scale = self._device_state()
            scores, pos = sq_search(
                codes_dev, jnp.int32(self.ntotal), vmin, scale, xq_pad, mask,
                jnp.asarray(self.metric_arg, jnp.float32),
                k=k_eff, metric=self.metric.name, chunk=chunk,
                precision=config.precision, codec=self.codec)
        dist, pos = finalize_scores(scores, pos, self.metric.name)
        return dist, pos, nq, k_eff

    def state_dict(self) -> dict:
        state = {"codes": self._codes.view(np.uint8)
                 if self.qtype in FLOAT_SQ_TYPES else self._codes}
        if self._vmin is not None:
            state["vmin"] = self._vmin
            state["scale"] = self._scale
        return state

    def load_state(self, state: dict) -> None:
        codes = np.asarray(state["codes"])
        if self.qtype in FLOAT_SQ_TYPES:
            self._codes = codes.view(
                _float_dtype(self.qtype)).reshape(-1, self.d)
        else:
            self._codes = codes.astype(np.uint8).reshape(
                -1, sq_code_width(self.d, self.codec))
        vmin = state.get("vmin")
        if vmin is not None:
            self._vmin = np.asarray(vmin, np.float32)
            self._scale = np.asarray(state["scale"], np.float32)
        self._invalidate()


def _sq_range_search(self, xq, radius, params=None, selector=None):
    from ..ops.range import (_range_tile_sq, choose_range_chunk, range_num_chunks,
                             empty_range_result, range_scan_dense)

    if not self.is_trained:
        raise errors.InvalidInputError(
            "Index is not trained; call train (or faiss_manual_train) "
            "before adding or searching")
    xq = as_matrix(xq, self.d)
    nq = xq.shape[0]
    if nq == 0 or self.ntotal == 0:
        return empty_range_result(nq)
    codes_dev, vmin, scale = self._device_state()
    cap = codes_dev.shape[0]
    chunk = choose_range_chunk(cap)
    nq_pad = max(config.min_query_bucket, next_pow2(nq))
    xq_dev = jnp.asarray(pad_rows(xq, nq_pad))
    marg = jnp.asarray(self.metric_arg, jnp.float32)
    passing = (selector.contains(self.row_labels())
               if selector is not None else None)
    codec = self.codec

    def get_tile(i):
        return _range_tile_sq(codes_dev[i * chunk:(i + 1) * chunk], vmin,
                              scale, xq_dev, marg, metric=self.metric.name,
                              precision=config.precision, codec=codec)

    return range_scan_dense(get_tile, range_num_chunks(cap, chunk), chunk, self.ntotal, nq,
                            float(radius), self.metric.name, passing)


SQIndex.range_search = _sq_range_search
