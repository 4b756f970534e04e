"""IVF index: k-means-trained inverted lists with gathered device scans.

Equivalent of faiss::IndexIVF(+Flat storage) as the reference exercises it:
``IVFn[,Flat]`` and ``IVFn_HNSWm,Flat`` factory strings, deferred training
through faiss_add, nprobe + ``quantiser.``-prefixed search params
(src/faiss_extension.cpp:675-689), and native add_with_ids (ids stored in
the inverted lists, no IDMap needed — test
faiss_add_ids_with_train copy.test uses IDMap,IVF1,Flat but FAISS IVF also
accepts ids directly).

Storage layout (rebuilt lazily per mutation):
* host: vectors + ids in insertion order, plus per-row list assignments;
* device: rows sorted by list (one contiguous buffer → coalesced gathers),
  (offsets, counts) list metadata for contiguous block slicing, centroids.

The coarse quantizer index object (``quantizer``) mirrors FAISS's graph shape
(it answers ``quantiser.``-scoped params and holds the centroids for
save/load); assignment itself runs as one fused distance tile, not through
the quantizer's own search path.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import errors
from ..metrics import Metric
from ..ops.flat_search import SIMILARITY_METRICS
from ..ops.kmeans import (DEFAULT_NITER, DEFAULT_SEED, kmeans_fit,
                          subsample_for_training)
from ..ops.sq import FLOAT_CODECS as _FLOAT_SQ
from ..ops.sq import float_codec_dtype as _sq_float_dtype
from ..utils.config import config
from .base import Index, as_matrix


class IVFIndex(Index):
    def __init__(self, d: int, metric: Metric, metric_arg: float,
                 nlist: int, quantizer: Index, encoding: str = "Flat"):
        super().__init__(d, metric, metric_arg)
        self.pq_m = self.pq_nbits = None
        self.pq_codec = "pq"              # "pq" | "rq" (additive residual)
        self.sq_type: str | None = None   # "sq8"|"sq4"|"sq6"|"fp16"
        if encoding != "Flat":
            import re

            m = re.match(r"^PQ(\d+)(?:x(\d+))?$", encoding)
            mrq = re.match(r"^RQ(\d+)x(\d+)$", encoding)
            if m:
                self.pq_m = int(m.group(1))
                self.pq_nbits = int(m.group(2)) if m.group(2) else 8
                if d % self.pq_m != 0:
                    raise errors.InvalidInputError(
                        f"The dimension of the vector ({d}) must be a "
                        f"multiple of the number of subquantizers "
                        f"({self.pq_m})")
            elif mrq:
                # faiss IndexIVFResidualQuantizer: additive full-dim stage
                # codebooks on the residuals (same storage shape as IVFPQ,
                # different decoder — ops/rq.py).
                self.pq_m = int(mrq.group(1))
                self.pq_nbits = int(mrq.group(2))
                self.pq_codec = "rq"
                if not 1 <= self.pq_nbits <= 8:
                    # uint8 code storage; >8 bits would wrap mod 256.
                    raise errors.InvalidInputError(
                        f"RQ supports 1-8 bits per stage (uint8 code "
                        f"storage), got {self.pq_nbits}")
            elif encoding in ("SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16"):
                # faiss IndexIVFScalarQuantizer (by_residual=false, the
                # index_factory default): raw rows SQ-encoded per list.
                self.sq_type = (encoding[2:]
                                if encoding in ("SQfp16", "SQbf16")
                                else encoding.lower())
            else:
                raise errors.InvalidInputError(
                    f"IVF encoding {encoding} is not supported (use Flat, "
                    f"PQm, RQMxb, SQ8, SQ4, SQ6, SQfp16 or SQbf16)")
            if metric.name not in ("L2", "INNER_PRODUCT"):
                raise errors.InvalidInputError(
                    f"{encoding} indexes support only L2 and INNER_PRODUCT "
                    f"metrics, got {metric.name}")
        self._pq_codebooks: np.ndarray | None = None  # (m, ksub, dsub)
        self._sq_vmin: np.ndarray | None = None
        self._sq_scale: np.ndarray | None = None
        if self.pq_m:
            self._codes = np.empty((0, self.pq_m), dtype=np.uint8)
        elif self.sq_type in _FLOAT_SQ:
            self._codes = np.empty((0, d), dtype=_sq_float_dtype(self.sq_type))
        elif self.sq_type:
            from ..ops.sq import sq_code_width

            self._codes = np.empty((0, sq_code_width(d, self.sq_type)),
                                   dtype=np.uint8)
        else:
            self._codes = None
        self.nlist = int(nlist)
        self.quantizer = quantizer
        self.encoding = encoding
        self.nprobe_default = 1  # faiss::IndexIVF::nprobe default
        self.train_seed = DEFAULT_SEED
        self.train_niter = DEFAULT_NITER
        self.train_balance = 0.0
        self.assign_topk = 0     # capped device-ingest assignment (0 = off)
        self._centroids: np.ndarray | None = None
        #: SOAR bookkeeping (None when SOAR is off): storage row → logical
        #: datapoint, and logical position → original storage row.
        self._srcrow: np.ndarray | None = None
        self._logical_rows: np.ndarray | None = None
        self._xb = np.empty((0, d), dtype=np.float32)
        self._ids = np.empty((0,), dtype=np.int64)
        self._assign = np.empty((0,), dtype=np.int32)
        self._version = 0
        self._dr = None          # device-resident state (models/ivf_device)
        self._device = None      # (xb_sorted, lmax, centroids, order)
        self._device_padded = None   # device-resident serving tuple
        self._ids_sorted = None      # (order, ids[order]) — see _sorted_ids
        self._mask_cache: dict = {}

    # --- lifecycle -------------------------------------------------------
    @property
    def ntotal(self) -> int:
        """Logical datapoint count (user view).  With SOAR every datapoint
        occupies two storage rows (_nstored == 2 * ntotal)."""
        n = self._ids.shape[0]
        return n // 2 if getattr(self, "soar_lambda", 0.0) > 0.0 else n

    @property
    def _nstored(self) -> int:
        """Storage rows (inverted-list entries); kernels/masks/layouts use
        this, the public count is ``ntotal``."""
        return self._ids.shape[0]

    @property
    def is_trained(self) -> bool:
        if self._centroids is None:
            return False
        if self.pq_m is not None:
            return self._pq_codebooks is not None
        if self.sq_type is not None and self.sq_type not in _FLOAT_SQ:
            return self._sq_vmin is not None
        return True

    @property
    def requires_training(self) -> bool:
        return True

    def train(self, x) -> None:
        if self.is_trained:
            return  # FAISS skips retraining a trained quantizer
        x = as_matrix(x, self.d)
        self._centroids, x = self._train_coarse(x)
        self._populate_quantizer()
        if self.pq_m is not None:
            # Residual PQ (faiss IndexIVFPQ by_residual): codebooks trained
            # on x − centroid[assign(x)].
            from ..ops.pq import codec_train

            ksub = 1 << self.pq_nbits
            if x.shape[0] < ksub:
                self._centroids = None
                raise errors.TrainingTooSmallError(x.shape[0], ksub)
            assign = self._assign_lists(x)
            resid = x - self._centroids[assign]
            eta = getattr(self, "aniso_eta", 1.0)
            if eta > 1.0:
                from ..ops.pq import pq_train_anisotropic

                cb = pq_train_anisotropic(resid, self.pq_m, ksub, eta,
                                          seed=self.train_seed,
                                          precision=config.precision,
                                          dirs=x)
            else:
                cb = codec_train(resid, self.pq_m, ksub, self.pq_codec,
                                 seed=self.train_seed,
                                 precision=config.precision)
            self._pq_codebooks = np.asarray(cb, dtype=np.float32)
        if self.sq_type is not None and self.sq_type not in _FLOAT_SQ:
            from ..ops.sq import SQ_LEVELS, sq_train

            vmin, scale = sq_train(x, SQ_LEVELS[self.sq_type])
            self._sq_vmin = np.asarray(vmin)
            self._sq_scale = np.asarray(scale)
        self._invalidate()

    #: IMIIndex sets this False — its mirror quantizer is never consulted
    #: and copying the materialized cell table into it would double memory.
    _mirror_quantizer = True

    def _populate_quantizer(self) -> None:
        """Mirror the centroid table into the quantizer index object
        (faiss graph shape; used again after load_state rebuilds the
        quantizer untrained).  A quantizer that itself needs training
        (nested IVF, e.g. ``IVF1024(IVF32,Flat)``) is trained on the
        centroid table first, mirroring faiss Level1Quantizer::train_q1."""
        if not self._mirror_quantizer or self.quantizer.ntotal != 0:
            return
        if not self.quantizer.is_trained:
            self.quantizer.train(self._centroids)
        self.quantizer.add(self._centroids)

    def _subsample_train(self, x, k: int):
        """Too-few-points check + FAISS's seeded per-centroid subsample,
        for a coarse stage with ``k`` centroids."""
        n = x.shape[0]
        if n < k:
            raise errors.TrainingTooSmallError(n, k)
        nsub = subsample_for_training(n, k)
        if nsub < n:
            rng = np.random.default_rng(self.train_seed)
            sel = rng.choice(n, size=nsub, replace=False)
            x = x[np.sort(sel)]
        return x

    def _train_coarse(self, x):
        """Fit the coarse quantizer; returns (centroid table (nlist, d),
        training subsample for the encoding stages).  IMIIndex overrides
        this with the product (multi-index) quantizer."""
        x = self._subsample_train(x, self.nlist)
        # Training and assignment always run at full precision: with many
        # lists the distance differences between competing centroids fall
        # below bf16 resolution and assignment collapses into a few giant
        # lists (observed at nlist=16k on 96-d data — the padded layout then
        # explodes).  Search-time coarse probing keeps config precision.
        import jax as _jax

        centroids, _ = kmeans_fit(
            x, self.nlist, niter=self.train_niter, seed=self.train_seed,
            precision=_jax.lax.Precision.HIGHEST,
            balance=getattr(self, "train_balance", 0.0),
            # faiss parity: Level1Quantizer::train_q1 trains the coarse
            # quantizer spherically for METRIC_INNER_PRODUCT — IP probe
            # selection against unnormalised centroids is norm-biased.
            spherical=self.metric.name == "INNER_PRODUCT")
        return np.asarray(centroids, dtype=np.float32), x

    def _require_trained(self):
        if not self.is_trained:
            raise errors.InvalidInputError(
                "Index is not trained; call train (or faiss_manual_train) "
                "before adding or searching")

    # --- ingest ----------------------------------------------------------
    def add(self, x) -> None:
        x = as_matrix(x, self.d)
        start = self.ntotal
        self.add_with_ids(
            x, np.arange(start, start + x.shape[0], dtype=np.int64))

    def add_with_ids(self, x, ids) -> None:
        self._require_trained()
        if self._dr is not None:
            raise errors.InvalidInputError(
                "host-path adds cannot be mixed with device-resident "
                "ingest on the same index (use add_device)")
        x = as_matrix(x, self.d)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.shape[0] != x.shape[0]:
            raise errors.add_error(
                f"number of ids ({ids.shape[0]}) does not match number of "
                f"vectors ({x.shape[0]})")
        if x.shape[0] == 0:
            return
        assign = self._assign_lists(x)
        if getattr(self, "soar_lambda", 0.0) > 0.0:
            # SOAR (Sun et al., 2023): every vector also joins a SECOND
            # list chosen so its residual there is near-orthogonal to the
            # primary residual — when the primary list is mis-ranked by
            # query-residual alignment, the spilled copy is likely probed.
            # Materialized as duplicated rows, so every layout / shard /
            # spill / codec path works unchanged; search fetches 2k and
            # dedups by SOURCE row (see search_dispatch).  Bookkeeping:
            # _srcrow maps every storage row to its logical datapoint,
            # _logical_rows maps logical position -> original storage row.
            assign2 = self._assign_soar(x, assign)
            nb = x.shape[0]
            start_store = self._nstored
            start_logical = self.ntotal
            logical = np.arange(start_logical, start_logical + nb,
                                dtype=np.int64)
            if self._srcrow is None:
                self._srcrow = np.empty((0,), np.int64)
                self._logical_rows = np.empty((0,), np.int64)
            self._srcrow = np.concatenate(
                [self._srcrow, logical, logical])
            self._logical_rows = np.concatenate(
                [self._logical_rows,
                 np.arange(start_store, start_store + nb, dtype=np.int64)])
            x = np.concatenate([x, x], axis=0)
            ids = np.concatenate([ids, ids])
            assign = np.concatenate([assign, assign2])
        if self.pq_m is not None:
            # Store byte codes only (FAISS IVFPQ memory profile).
            from ..ops.pq import codec_encode

            resid = x - self._centroids[assign]
            eta = getattr(self, "aniso_eta", 1.0)
            if eta > 1.0:
                from ..ops.pq import pq_encode_anisotropic

                codes = np.asarray(pq_encode_anisotropic(
                    jnp.asarray(resid), jnp.asarray(self._pq_codebooks),
                    jnp.float32(eta), precision=config.precision,
                    dirs=jnp.asarray(x)))
            else:
                codes = np.asarray(codec_encode(
                    jnp.asarray(resid), jnp.asarray(self._pq_codebooks),
                    self.pq_codec, precision=config.precision,
                    beam=getattr(self, "rq_beam", None)))
            self._codes = np.concatenate([self._codes, codes], axis=0)
        elif self.sq_type is not None:
            self._codes = np.concatenate(
                [self._codes, self._sq_encode(x)], axis=0)
        else:
            self._xb = np.concatenate([self._xb, x], axis=0)
        self._ids = np.concatenate([self._ids, ids])
        self._assign = np.concatenate([self._assign, assign])
        self._invalidate()

    def reconstruct(self, key: int) -> np.ndarray:
        """Stored vector by position (decodes PQ/SQ storage; feeds IDMap2
        reconstruct-by-label through the composite graph)."""
        key = int(key)
        if key < 0 or key >= self.ntotal:
            raise errors.InvalidInputError(
                f"Position {key} is out of range (ntotal={self.ntotal})")
        if self._dr is not None:
            return self._dr_reconstruct(key)
        if self._logical_rows is not None:
            # SOAR: logical positions indirect to the original storage row.
            key = int(self._logical_rows[key])
        if self.pq_m is not None:
            from ..ops.pq import codec_decode

            resid = np.asarray(codec_decode(
                jnp.asarray(self._codes[key:key + 1]),
                jnp.asarray(self._pq_codebooks), self.pq_codec))[0]
            return resid + self._centroids[self._assign[key]]
        if self.sq_type is not None:
            from ..ops.sq import sq_decode

            vmin, scale = self._sq_ranges()
            return np.asarray(sq_decode(
                jnp.asarray(self._codes[key:key + 1]), vmin, scale,
                self.sq_type))[0]
        return self._xb[key]

    def _sq_encode(self, x: np.ndarray) -> np.ndarray:
        from ..ops.sq import SQ_LEVELS, sq4_pack, sq6_pack, sq_quantize

        if self.sq_type in _FLOAT_SQ:
            return x.astype(_sq_float_dtype(self.sq_type))
        q = np.asarray(sq_quantize(jnp.asarray(x),
                                   jnp.asarray(self._sq_vmin),
                                   jnp.asarray(self._sq_scale),
                                   levels=SQ_LEVELS[self.sq_type]))
        if self.sq_type == "sq4":
            return sq4_pack(q)
        if self.sq_type == "sq6":
            return sq6_pack(q)
        return q

    def _sq_ranges(self):
        if self.sq_type in _FLOAT_SQ or self._sq_vmin is None:
            z = np.zeros((self.d,), np.float32)
            return jnp.asarray(z), jnp.asarray(z)
        return jnp.asarray(self._sq_vmin), jnp.asarray(self._sq_scale)

    def _assign_lists(self, x: np.ndarray) -> np.ndarray:
        """Coarse assignment of new vectors (best list by the index metric).

        All chunk dispatches are issued asynchronously and fetched with ONE
        host transfer at the end — per-chunk fetches serialize on the host
        round-trip and made 10M-row ingest latency-bound."""
        from ..ops.distance import pairwise_tile

        sim = self.metric.name in SIMILARITY_METRICS
        cents = jnp.asarray(self._centroids)
        # Bound the transient (chunk × nlist) score tile to ~512 MB.
        chunk = max(1024, min(65536, (1 << 27) // max(self.nlist, 1)))
        parts = []
        import jax as _jax

        for i in range(0, x.shape[0], chunk):
            # Full precision: assignment consistency with training matters
            # more than ingest speed (see train()).
            tile = pairwise_tile(jnp.asarray(x[i:i + chunk]), cents,
                                 self.metric.name, self.metric_arg,
                                 _jax.lax.Precision.HIGHEST)
            best = jnp.argmax(tile, 1) if sim else jnp.argmin(tile, 1)
            parts.append(best.astype(jnp.int32))
        if not parts:
            return np.empty((0,), dtype=np.int32)
        return np.asarray(jnp.concatenate(parts), dtype=np.int32)

    def _assign_soar(self, x: np.ndarray, assign: np.ndarray) -> np.ndarray:
        """Secondary SOAR assignment: argmin over lists l != primary of
        ||x - c_l||^2 + lambda * ((x - c_l) · r1_hat)^2, where r1 is the
        primary residual — spills each point toward a list whose residual
        is orthogonal to the primary one.  L2 geometry (SOAR's derivation);
        one extra matmul per chunk on top of the plain assignment tile."""
        import jax as _jax

        lam = jnp.float32(self.soar_lambda)
        cents = jnp.asarray(self._centroids)
        hp = _jax.lax.Precision.HIGHEST
        chunk = max(1024, min(65536, (1 << 27) // max(self.nlist, 1)))
        parts = []
        for i in range(0, x.shape[0], chunk):
            xc = jnp.asarray(x[i:i + chunk])
            a1 = jnp.asarray(assign[i:i + chunk])
            r1 = xc - cents[a1]
            r1h = r1 / jnp.sqrt(jnp.maximum(
                jnp.sum(r1 * r1, 1, keepdims=True), 1e-20))
            xn = jnp.sum(xc * xc, 1, keepdims=True)
            cn = jnp.sum(cents * cents, 1)[None, :]
            xdc = jnp.dot(xc, cents.T, precision=hp,
                          preferred_element_type=jnp.float32)
            sqdist = xn - 2.0 * xdc + cn
            # (x - c_l)·r1_hat = x·r1_hat − c_l·r1_hat
            proj = (jnp.sum(xc * r1h, 1, keepdims=True)
                    - jnp.dot(r1h, cents.T, precision=hp,
                              preferred_element_type=jnp.float32))
            cost = sqdist + lam * proj * proj
            # Exclude the primary list.
            rows = jnp.arange(a1.shape[0])
            cost = cost.at[rows, a1].set(jnp.inf)
            parts.append(jnp.argmin(cost, 1).astype(jnp.int32))
        if not parts:
            return np.empty((0,), dtype=np.int32)
        return np.asarray(jnp.concatenate(parts), dtype=np.int32)

    def _invalidate(self):
        self._version += 1
        self._device = None
        self._device_padded = None
        self._device_spill = None
        self._ids_sorted = None
        self._srcrow_sorted = None
        self._sq_dev_cache = None
        self._int8_cache = None
        self._mask_cache.clear()

    # --- create params (efConstruction recursion hits the quantizer) ------
    def apply_create_params(self, params) -> None:
        # Engine extensions beyond the reference's surface: training knobs
        # (seed/niter for reproducibility, kmeans_balance for skew-aware
        # list sizing — SURVEY.md §2.3 skew handling).
        self.train_seed = params.get_int("train_seed", self.train_seed)
        self.train_niter = params.get_int("train_niter", self.train_niter)
        self.train_balance = params.get_float("kmeans_balance", 0.0)
        # Capped assignment (ScaNN-style balanced partitioning) for the
        # device-resident ingest: each row goes to the nearest of its top-T
        # candidate lists with free capacity; rows fitting nowhere stay
        # exact in the spill.  0/1 = plain nearest assignment.
        self.assign_topk = params.get_int("assign_topk", 0)
        beam = params.get_int("beam")
        if beam is not None:
            # RQ-storage encode beam (models/rq.DEFAULT_BEAM otherwise).
            if self.pq_codec != "rq":
                raise errors.InvalidInputError(
                    "beam applies to RQ storage (IVFn,RQMxb)")
            self.rq_beam = max(1, beam)
        lam = params.get_float("soar_lambda")
        if lam is not None:
            # SOAR dual assignment (see add_with_ids); lambda weights the
            # orthogonality-amplified term, ~1.0 is the paper's sweet spot.
            if lam < 0.0:
                raise errors.InvalidInputError(
                    f"soar_lambda must be >= 0, got {lam}")
            if self.nlist < 2 and lam > 0.0:
                raise errors.InvalidInputError(
                    "SOAR needs at least 2 inverted lists")
            self.soar_lambda = lam
        eta = params.get_float("anisotropic_eta")
        if eta is not None:
            # ScaNN-style score-aware residual quantization (PQ storage
            # only); anisotropy axis = the ORIGINAL datapoint direction.
            if eta < 1.0:
                raise errors.InvalidInputError(
                    f"anisotropic_eta must be >= 1.0, got {eta}")
            if self.pq_m is None or self.pq_codec != "pq":
                raise errors.InvalidInputError(
                    "anisotropic_eta applies to PQ storage (IVFn,PQm)")
            self.aniso_eta = eta
        self.quantizer.apply_create_params(params.scoped("ivf."))

    # --- serialization ----------------------------------------------------
    def state_dict(self) -> dict:
        if self._dr is not None:
            # Materialize the device layout back into the host format so
            # save/load round-trips into a normal host-path index (one
            # bulk payload fetch; save at scale is an explicit, rare op).
            rows = self._dr_materialize_codes()
            state = {"xb": (rows if self.sq_type is None
                            else np.empty((0, self.d), np.float32)),
                     "ids": self._ids, "assign": self._assign}
            if self._centroids is not None:
                state["centroids"] = self._centroids
            if self.sq_type is not None:
                state["codes"] = rows
                if self._sq_vmin is not None:
                    state["sq_vmin"] = self._sq_vmin
                    state["sq_scale"] = self._sq_scale
            return state
        state = {
            "xb": self._xb,
            "ids": self._ids,
            "assign": self._assign,
        }
        if getattr(self, "soar_lambda", 0.0) > 0.0:
            # Needed after load: search must keep fetching 2k + deduping.
            state["soar_lambda"] = np.float32(self.soar_lambda)
            if self._srcrow is not None:
                state["soar_srcrow"] = self._srcrow
                state["soar_rows"] = self._logical_rows
        if getattr(self, "aniso_eta", 1.0) > 1.0:
            state["aniso_eta"] = np.float32(self.aniso_eta)
        if getattr(self, "rq_beam", None) is not None:
            state["rq_beam"] = np.int64(self.rq_beam)
        if self._centroids is not None:
            state["centroids"] = self._centroids
        if self.pq_m is not None:
            state["codes"] = self._codes
            if self._pq_codebooks is not None:
                state["pq_codebooks"] = self._pq_codebooks
        if self.sq_type is not None:
            state["codes"] = (self._codes.view(np.uint8)
                              if self.sq_type in _FLOAT_SQ
                              else self._codes)
            if self._sq_vmin is not None:
                state["sq_vmin"] = self._sq_vmin
                state["sq_scale"] = self._sq_scale
        return state

    def load_state(self, state: dict) -> None:
        lam = state.pop("soar_lambda", None)
        if lam is not None:
            self.soar_lambda = float(lam)
        srcrow = state.pop("soar_srcrow", None)
        if srcrow is not None:
            self._srcrow = np.asarray(srcrow, np.int64).reshape(-1)
            self._logical_rows = np.asarray(
                state.pop("soar_rows"), np.int64).reshape(-1)
        eta = state.pop("aniso_eta", None)
        if eta is not None:
            self.aniso_eta = float(eta)
        beam = state.pop("rq_beam", None)
        if beam is not None:
            self.rq_beam = int(beam)
        self._xb = np.asarray(state["xb"], np.float32).reshape(-1, self.d)
        self._ids = np.asarray(state["ids"], np.int64).reshape(-1)
        self._assign = np.asarray(state["assign"], np.int32).reshape(-1)
        cents = state.get("centroids")
        self._centroids = (np.asarray(cents, np.float32)
                           if cents is not None else None)
        if self.pq_m is not None:
            self._codes = np.asarray(state["codes"],
                                     np.uint8).reshape(-1, self.pq_m)
            cb = state.get("pq_codebooks")
            self._pq_codebooks = (np.asarray(cb, np.float32)
                                  if cb is not None else None)
        if self.sq_type is not None:
            from ..ops.sq import sq_code_width

            codes = np.asarray(state["codes"])
            if self.sq_type in _FLOAT_SQ:
                self._codes = codes.view(
                    _sq_float_dtype(self.sq_type)).reshape(-1, self.d)
            else:
                self._codes = codes.astype(np.uint8).reshape(
                    -1, sq_code_width(self.d, self.sq_type))
            vmin = state.get("sq_vmin")
            if vmin is not None:
                self._sq_vmin = np.asarray(vmin, np.float32)
                self._sq_scale = np.asarray(state["sq_scale"], np.float32)
        if self._centroids is not None:
            # Rebuilt-by-factory quantizer is untrained; _populate_quantizer
            # retrains it on the centroid table when needed (a bare .add
            # crashed loading IVFn(IVFm,...) composites).
            self._populate_quantizer()
        self._invalidate()



# --------------------------------------------------------------------------
# The IVF implementation is split across sibling modules that attach their
# methods here (same pattern as the sharded tier always used):
#   ivf_layout  — padded/spill/sorted layouts, device builds, masks
#   ivf_serve   — search dispatch, range search, coarse probing
#   ivf_sharded — faiss_to_device placement over a mesh
#   imi         — the product-coarse-quantizer subclass
#   ivf_device  — device-resident ingest (add_device / train_device)
# Imports at the very bottom so the partially-imported module already holds
# the finished class.
from . import ivf_layout  # noqa: E402,F401
from . import ivf_serve   # noqa: E402,F401
from .ivf_serve import _coarse_topk  # noqa: E402,F401  (re-export)
from . import ivf_sharded  # noqa: E402,F401
from .imi import IMIIndex  # noqa: E402  (re-export)

IMIIndex._supports_device_ingest = False   # factored assignment + train

from . import ivf_device  # noqa: E402,F401
