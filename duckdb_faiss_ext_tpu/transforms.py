"""Vector transforms: PCA / OPQ / L2norm (faiss::VectorTransform family).

Reachable in the reference through factory prefixes (``PCA64,...``,
``OPQ16,...``, ``L2norm,...`` — faiss::index_factory grammar,
src/faiss_extension.cpp:154-155).  Each transform maps (n, d_in) →
(n, d_out) before the wrapped index sees the data (models/pretransform.py).

Device design: transforms are single matmuls applied inside the ingest
and query paths; training is eigendecomposition (PCA) or the alternating
rotation/PQ procrustes loop (OPQ) — both via jnp.linalg on device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import errors
from .ops.kmeans import DEFAULT_SEED


class VectorTransform:
    """Linear-ish map y = f(x); trained transforms hold device arrays."""

    def __init__(self, d_in: int, d_out: int):
        self.d_in = int(d_in)
        self.d_out = int(d_out)

    @property
    def is_trained(self) -> bool:
        return True

    def train(self, x: np.ndarray) -> None:  # noqa: B027
        pass

    def apply(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reverse(self, y: np.ndarray) -> np.ndarray:
        raise errors.InvalidInputError(
            f"{type(self).__name__} has no reverse transform")

    # serialization
    def state_dict(self) -> dict:
        return {}

    def load_state(self, state: dict) -> None:  # noqa: B027
        pass


class L2NormTransform(VectorTransform):
    """faiss::NormalizationTransform(norm=2): row-normalize."""

    def __init__(self, d: int):
        super().__init__(d, d)

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(n, 1e-20)


class LinearTransform(VectorTransform):
    """y = (x - mean) @ A with orthonormal-ish A (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out)
        self.A: np.ndarray | None = None       # (d_in, d_out)
        self.mean: np.ndarray | None = None    # (d_in,)
        self._Ainv: np.ndarray | None = None   # lazy pseudo-inverse

    @property
    def is_trained(self) -> bool:
        return self.A is not None

    def apply(self, x: np.ndarray) -> np.ndarray:
        if self.A is None:
            raise errors.InvalidInputError(
                f"{type(self).__name__} is not trained")
        x = np.asarray(x, np.float32)
        return np.asarray(
            jnp.dot(jnp.asarray(x - self.mean[None, :]), jnp.asarray(self.A),
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32))

    def reverse(self, y: np.ndarray) -> np.ndarray:
        # Pseudo-inverse, not transpose: whitened PCA columns are scaled by
        # 1/sqrt(eigenvalue) and are no longer orthonormal (A.T would
        # silently mis-scale every component).
        if self._Ainv is None:
            self._Ainv = np.linalg.pinv(self.A).astype(np.float32)
        y = np.asarray(y, np.float32)
        return y @ self._Ainv + self.mean[None, :]

    def state_dict(self) -> dict:
        state = {}
        if self.A is not None:
            state["A"] = self.A
            state["mean"] = self.mean
        return state

    def load_state(self, state: dict) -> None:
        if "A" in state:
            self.A = np.asarray(state["A"], np.float32)
            self.mean = np.asarray(state["mean"], np.float32)
            self._Ainv = None


class PCAMatrix(LinearTransform):
    """faiss::PCAMatrix: top-d_out principal components; ``random_rotation``
    (PCAR) composes a random orthogonal rotation after projection; ``whiten``
    (PCAW) scales components by 1/sqrt(eigenvalue)."""

    def __init__(self, d_in: int, d_out: int, *, random_rotation=False,
                 whiten=False, seed: int = DEFAULT_SEED):
        if d_out > d_in:
            raise errors.InvalidInputError(
                f"PCA output dimension {d_out} exceeds input {d_in}")
        super().__init__(d_in, d_out)
        self.random_rotation = bool(random_rotation)
        self.whiten = bool(whiten)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        if self.is_trained:
            return
        x = np.asarray(x, np.float32)
        if x.shape[0] < self.d_out:
            raise errors.InvalidInputError(
                f"PCA training needs at least d_out={self.d_out} points, "
                f"got {x.shape[0]}")
        xd = jnp.asarray(x)
        mean = jnp.mean(xd, axis=0)
        xc = xd - mean[None, :]
        cov = jnp.dot(xc.T, xc, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32) / x.shape[0]
        eigval, eigvec = jnp.linalg.eigh(cov)        # ascending
        order = jnp.argsort(-eigval)[: self.d_out]
        A = eigvec[:, order]                          # (d_in, d_out)
        if self.whiten:
            ev = jnp.maximum(eigval[order], 1e-10)
            A = A / jnp.sqrt(ev)[None, :]
        if self.random_rotation:
            rng = np.random.default_rng(self.seed)
            q, _ = np.linalg.qr(rng.standard_normal(
                (self.d_out, self.d_out)).astype(np.float32))
            A = jnp.dot(A, jnp.asarray(q),
                        precision=jax.lax.Precision.HIGHEST)
        self.A = np.asarray(A, np.float32)
        self.mean = np.asarray(mean, np.float32)


class PadTransform(VectorTransform):
    """faiss::RemapDimensionsTransform as the factory exposes it
    (``Pad{n}`` prefix): pad vectors with zero dimensions up to d_out
    (e.g. to reach a multiple of a PQ sub-quantizer count).  Distances are
    preserved exactly; reverse truncates the padding."""

    def __init__(self, d_in: int, d_out: int):
        if d_out < d_in:
            raise errors.InvalidInputError(
                f"Pad output dimension {d_out} is below input {d_in}")
        super().__init__(d_in, d_out)

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = np.zeros((x.shape[0], self.d_out), np.float32)
        out[:, : self.d_in] = x
        return out

    def reverse(self, y: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(y, np.float32)
                                    [:, : self.d_in])


class RandomRotationMatrix(LinearTransform):
    """faiss::RandomRotationMatrix (``RR[n]`` factory prefix): a fixed
    seeded random orthogonal map.  d_out <= d_in takes the leading columns
    of a (d_in, d_in) rotation; d_out > d_in embeds into the leading rows
    of a (d_out, d_out) rotation (norms preserved either way because rows
    stay orthonormal)."""

    def __init__(self, d_in: int, d_out: int | None = None, *,
                 seed: int = DEFAULT_SEED):
        d_out = d_in if d_out is None else int(d_out)
        super().__init__(d_in, d_out)
        self.seed = int(seed)
        dim = max(self.d_in, self.d_out)
        rng = np.random.default_rng(self.seed)
        q, _ = np.linalg.qr(
            rng.standard_normal((dim, dim)).astype(np.float64))
        self.A = np.ascontiguousarray(
            q[: self.d_in, : self.d_out], dtype=np.float32)
        self.mean = np.zeros((self.d_in,), np.float32)


class ITQTransform(LinearTransform):
    """faiss::ITQTransform (``ITQ[n]`` factory prefix): centering, optional
    PCA to d_out, then the ITQ rotation (Gong & Lazebnik) that minimizes
    binarization error — alternate B = sign(V R) with the procrustes update
    R ← U Wᵀ from svd(Vᵀ B).  Output is the rotated real-valued projection;
    a downstream LSH index does the sign binarization (``ITQ64,LSH``)."""

    def __init__(self, d_in: int, d_out: int | None = None,
                 do_pca: bool | None = None, *, niter: int = 50,
                 seed: int = DEFAULT_SEED):
        d_out = d_in if d_out is None else int(d_out)
        if d_out > d_in:
            raise errors.InvalidInputError(
                f"ITQ output dimension {d_out} exceeds input {d_in}")
        super().__init__(d_in, d_out)
        # index_factory passes do_pca = (d_out != d) for ITQTransform.
        self.do_pca = (d_out != d_in) if do_pca is None else bool(do_pca)
        self.niter = int(niter)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        if self.is_trained:
            return
        x = np.asarray(x, np.float32)
        if x.shape[0] < self.d_out:
            raise errors.InvalidInputError(
                f"ITQ training needs at least d_out={self.d_out} points, "
                f"got {x.shape[0]}")
        hp = jax.lax.Precision.HIGHEST
        xd = jnp.asarray(x)
        mean = jnp.mean(xd, axis=0)
        xc = xd - mean[None, :]
        if self.do_pca:
            pca = PCAMatrix(self.d_in, self.d_out, seed=self.seed)
            pca.train(x)
            A0 = jnp.asarray(pca.A)
            v = jnp.dot(xc, A0, precision=hp,
                        preferred_element_type=jnp.float32)
        else:
            A0 = jnp.eye(self.d_in, self.d_out, dtype=jnp.float32)
            v = xc
        rng = np.random.default_rng(self.seed)
        q, _ = np.linalg.qr(rng.standard_normal(
            (self.d_out, self.d_out)).astype(np.float32))
        R = jnp.asarray(q)
        for _ in range(self.niter):
            b = jnp.sign(jnp.dot(v, R, precision=hp,
                                 preferred_element_type=jnp.float32))
            mm = jnp.dot(v.T, b, precision=hp,
                         preferred_element_type=jnp.float32)
            u, _, wt = jnp.linalg.svd(mm, full_matrices=False)
            R = jnp.dot(u, wt, precision=hp)
        self.A = np.asarray(jnp.dot(A0, R, precision=hp), np.float32)
        self.mean = np.asarray(mean, np.float32)


class OPQMatrix(LinearTransform):
    """faiss::OPQMatrix: rotation minimizing PQ reconstruction error
    (OPQ-NP: alternate PQ fit on rotated data with the procrustes rotation
    update R ← U Vᵀ from svd(Xᵀ X̂))."""

    def __init__(self, d_in: int, m: int, d_out: int | None = None, *,
                 niter: int = 10, niter_pq: int = 4,
                 seed: int = DEFAULT_SEED):
        d_out = d_in if d_out is None else int(d_out)
        if d_out > d_in:
            raise errors.InvalidInputError(
                f"OPQ output dimension {d_out} exceeds input {d_in}")
        if d_out % m:
            raise errors.InvalidInputError(
                f"OPQ output dimension {d_out} must be a multiple of the "
                f"number of subquantizers ({m})")
        super().__init__(d_in, d_out)
        self.m = int(m)
        self.niter = int(niter)
        self.niter_pq = int(niter_pq)
        self.seed = int(seed)

    def train(self, x: np.ndarray) -> None:
        if self.is_trained:
            return
        from .ops.pq import pq_decode, pq_encode, pq_train

        x = np.asarray(x, np.float32)
        n = x.shape[0]
        ksub = min(256, max(2, n // 4))
        # Subsample large training sets: OPQ converges on ~100k points and
        # the iteration holds the full (n, d) matrix on device.
        if n > 100_000:
            rng = np.random.default_rng(self.seed)
            x = x[np.sort(rng.choice(n, 100_000, replace=False))]
        xd = jnp.asarray(x)
        mean = jnp.mean(xd, axis=0)
        xc = xd - mean[None, :]
        rng = np.random.default_rng(self.seed)
        q, _ = np.linalg.qr(rng.standard_normal(
            (self.d_in, self.d_in)).astype(np.float32))
        R = jnp.asarray(q[:, : self.d_out])
        hp = jax.lax.Precision.HIGHEST
        for _ in range(self.niter):
            xr = jnp.dot(xc, R, precision=hp,
                         preferred_element_type=jnp.float32)
            cb = pq_train(xr, self.m, ksub, niter=self.niter_pq,
                          seed=self.seed)
            codes = pq_encode(xr, cb, precision=hp)
            xrec = pq_decode(codes, cb)
            mm = jnp.dot(xc.T, xrec, precision=hp,
                         preferred_element_type=jnp.float32)
            u, _, vt = jnp.linalg.svd(mm, full_matrices=False)
            R = jnp.dot(u, vt, precision=hp)
        self.A = np.asarray(R, np.float32)
        self.mean = np.asarray(mean, np.float32)
