"""Product-quantization kernels: codebook training, encoding, fused search.

Equivalent of faiss::IndexPQ as reachable through the reference's factory
strings (``PQm[xb]``, SearchParametersPQ defaults at
src/faiss_extension.cpp:704-708).

Design choice: FAISS computes asymmetric distances through a
(M × ksub) lookup table walked per code byte — a scalar-gather pattern.
Here each corpus chunk is *decoded* instead (codes → centroids via one
gather) and the decoded chunk goes through the same matmul distance tile
as Flat search.  For L2/IP this is mathematically identical to LUT-ADC
(‖q − dec(c)‖² = Σ_m ‖q_m − centroid_m‖²) while reading only the 8-bit
codes from device memory — the compression still pays as
bandwidth/capacity, and the FLOPs ride the matrix units.

Training: per-subspace k-means, vmapped over the M subspaces (one batched
kernel instead of M sequential fits).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .distance import pairwise_tile
from .flat_search import _NEG_INF, SIMILARITY_METRICS, exact_topk
from .kmeans import DEFAULT_SEED, _kmeans_fit


@functools.partial(jax.jit, static_argnames=("m", "ksub", "niter",
                                             "precision"))
def _pq_train(xsub, valid, seed, *, m, ksub, niter, precision):
    # xsub: (m, n, dsub) — one k-means per subspace, batched with vmap.
    seeds = seed + jnp.arange(m, dtype=jnp.int32)
    fit = jax.vmap(
        lambda xs, s: _kmeans_fit(xs, valid, s, k=ksub, niter=niter,
                                  precision=precision))
    codebooks, _ = fit(xsub, seeds)
    return codebooks  # (m, ksub, dsub)


def pq_train(x, m: int, ksub: int, niter: int = 25, seed: int = DEFAULT_SEED,
             precision=lax.Precision.DEFAULT):
    """Train PQ codebooks on (n, d) data; d must be divisible by m.
    Returns (m, ksub, dsub) fp32."""
    x = jnp.asarray(x, jnp.float32)
    n, d = x.shape
    dsub = d // m
    xsub = x.reshape(n, m, dsub).transpose(1, 0, 2)
    valid = jnp.ones((n,), bool)
    return _pq_train(xsub, valid, jnp.int32(seed), m=m, ksub=ksub,
                     niter=niter, precision=precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def pq_encode(x, codebooks, *, precision=lax.Precision.DEFAULT):
    """Encode (n, d) → (n, m) uint8 codes (nearest sub-centroid)."""
    n, d = x.shape
    m, ksub, dsub = codebooks.shape
    xsub = x.reshape(n, m, dsub).transpose(1, 0, 2)       # (m, n, dsub)

    def sub_assign(xs, cb):
        xn = jnp.sum(xs * xs, 1, keepdims=True)
        cn = jnp.sum(cb * cb, 1)[None, :]
        xc = jnp.dot(xs, cb.T, precision=precision,
                     preferred_element_type=jnp.float32)
        return jnp.argmin(xn - 2 * xc + cn, axis=1)

    codes = jax.vmap(sub_assign)(xsub, codebooks)          # (m, n)
    return codes.T.astype(jnp.uint8)


def pq_decode(codes, codebooks):
    """Decode (c, m) uint8 codes → (c, d) fp32 reconstruction by gathering
    each subspace's codeword (on an H100 the gather beats a one-hot
    matmul decode by 30×; PERF.md)."""
    m, ksub, dsub = codebooks.shape
    c = codes.shape[0]
    gathered = jnp.take_along_axis(
        codebooks[None, :, :, :],                           # (1, m, ksub, dsub)
        codes.astype(jnp.int32)[:, :, None, None],          # (c, m, 1, 1)
        axis=2,
    )                                                       # (c, m, 1, dsub)
    return gathered.reshape(c, m * dsub)


def codec_decode(codes, codebooks, codec: str = "pq"):
    """Decode byte codes with the named codec: "pq" (subspace concat,
    pq_decode) or "rq" (additive sum, ops/rq.rq_decode).  The shared switch
    for every scan that stores quantized payloads."""
    if codec == "rq":
        from .rq import rq_decode

        return rq_decode(codes, codebooks)
    return pq_decode(codes, codebooks)


def codec_encode(x, codebooks, codec: str = "pq", *,
                 precision=lax.Precision.DEFAULT, beam=None):
    """``beam`` applies to the RQ encoder only (None → its default)."""
    if codec == "rq":
        from .rq import rq_encode

        kw = {} if beam is None else {"beam": beam}
        return rq_encode(x, codebooks, precision=precision, **kw)
    return pq_encode(x, codebooks, precision=precision)


def codec_train(x, m: int, ksub: int, codec: str = "pq", *, niter: int = 25,
                seed: int = DEFAULT_SEED, precision=lax.Precision.DEFAULT):
    if codec == "rq":
        from .rq import rq_train

        return rq_train(x, m, ksub, niter=niter, seed=seed,
                        precision=precision)
    return pq_train(x, m, ksub, niter=niter, seed=seed, precision=precision)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "chunk", "precision", "codec"))
def pq_search(codes, nvalid, codebooks, xq, mask, metric_arg, *, k, metric,
              chunk, precision, codec="pq"):
    """Fused decode+distance+top-k scan over quantized codes.

    codes: (cap, m) uint8 (cap multiple of chunk); returns (distances,
    positions) with the same conventions as flat_search.  ``codec`` picks
    the decoder: "pq" (subspace concat) or "rq" (additive sum,
    ops/rq.rq_decode)."""
    cap, m = codes.shape
    nq = xq.shape[0]
    sim = metric in SIMILARITY_METRICS
    if codec == "rq":
        from .rq import rq_decode as decode
    else:
        decode = pq_decode

    def body(i, carry):
        best_s, best_p = carry
        start = i * chunk
        cchunk = lax.dynamic_slice(codes, (start, 0), (chunk, m))
        xc = decode(cchunk, codebooks)
        dist = pairwise_tile(xq, xc, metric, metric_arg, precision)
        rowid = start + lax.broadcasted_iota(jnp.int32, (1, chunk), 1)
        valid = rowid < nvalid
        if mask is not None:
            mc = lax.dynamic_slice(mask, (start,), (chunk,))
            valid = jnp.logical_and(valid, mc[None, :])
        score = dist if sim else -dist
        score = jnp.where(valid, score, _NEG_INF)
        local_s, local_i = exact_topk(score, min(k, chunk))
        cat_s = jnp.concatenate([best_s, local_s], axis=1)
        cat_p = jnp.concatenate([best_p, start + local_i], axis=1)
        new_s, sel = lax.top_k(cat_s, k)
        return new_s, jnp.take_along_axis(cat_p, sel, axis=1)

    init = (jnp.full((nq, k), _NEG_INF, jnp.float32),
            jnp.full((nq, k), -1, jnp.int32))
    return lax.fori_loop(0, cap // chunk, body, init)


# --- anisotropic (score-aware) PQ training ---------------------------------
#
# ScaNN-style quantization loss (Guo et al., "Accelerating Large-Scale
# Inference with Anisotropic Vector Quantization", ICML 2020): for MIPS the
# residual component PARALLEL to the datapoint changes the inner-product
# score, the orthogonal component mostly doesn't — so weight them
# differently:  L(x, c) = eta * ||r_par||^2 + ||r_orth||^2,  r = x - c.
# Assignment expands to ||r||^2 + (eta-1) * (r.x)^2 / ||x||^2 — one extra
# rank-1 term on top of the standard distance tile.  The update step has a
# closed form per centroid:  [n_j I + (eta-1) * sum x_hat x_hat^T] c_j =
# eta * sum x  (because x_hat x_hat^T x = x), a (dsub, dsub) solve vmapped
# over the ksub clusters — all matmul work.  eta > 1 biases codebooks toward
# score accuracy; eta = 1 reduces exactly to k-means.

def _unit(v):
    return v / jnp.sqrt(jnp.maximum(
        jnp.sum(v * v, 1, keepdims=True), 1e-20))


def _aniso_cost(xs, xhat, centroids, eta, precision):
    """(n, ksub) score-aware cost ||x-c||^2 + (eta-1)((x-c)·x̂)^2."""
    xn = jnp.sum(xs * xs, 1, keepdims=True)
    cn = jnp.sum(centroids * centroids, 1)[None, :]
    xc = jnp.dot(xs, centroids.T, precision=precision,
                 preferred_element_type=jnp.float32)
    sqdist = xn - 2.0 * xc + cn
    proj_x = jnp.sum(xs * xhat, 1, keepdims=True)           # xs·x̂
    proj_c = jnp.dot(xhat, centroids.T, precision=precision,
                     preferred_element_type=jnp.float32)     # x̂·c
    rpar = proj_x - proj_c
    return sqdist + (eta - 1.0) * rpar * rpar


def _aniso_step(xs, xhat, centroids, eta, precision):
    n, dsub = xs.shape
    ksub = centroids.shape[0]
    hp = lax.Precision.HIGHEST
    cost = _aniso_cost(xs, xhat, centroids, eta, precision)
    labels = jnp.argmin(cost, axis=1).astype(jnp.int32)
    onehot = (labels[:, None] ==
              jnp.arange(ksub, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    counts = jnp.sum(onehot, axis=0)                         # (ksub,)
    sum_x = jnp.dot(onehot.T, xs, precision=hp,
                    preferred_element_type=jnp.float32)      # (ksub, dsub)
    # b = Σ x + (eta-1) Σ x̂ (x̂·x)  (reduces to eta·Σx when x̂ ∥ x).
    proj_x = jnp.sum(xs * xhat, 1, keepdims=True)
    sum_xw = jnp.dot(onehot.T, xhat * proj_x, precision=hp,
                     preferred_element_type=jnp.float32)
    # sum of outer products x_hat x_hat^T per cluster: einsum over members.
    outer = jnp.einsum("nk,nd,ne->kde", onehot, xhat, xhat,
                       precision=hp, preferred_element_type=jnp.float32)
    eye = jnp.eye(dsub, dtype=jnp.float32)
    A = counts[:, None, None] * eye[None] + (eta - 1.0) * outer
    b = sum_x + (eta - 1.0) * sum_xw
    # Guard empty clusters: identity system keeps the old centroid.
    empty = counts < 0.5
    A = jnp.where(empty[:, None, None], eye[None], A)
    b = jnp.where(empty[:, None], centroids, b)
    return jax.vmap(jnp.linalg.solve)(A, b[:, :, None])[:, :, 0]


@functools.partial(jax.jit, static_argnames=("m", "ksub", "niter",
                                             "precision"))
def _pq_train_aniso(xsub, dirsub, seed, eta, *, m, ksub, niter, precision):
    def fit_sub(xs, ds, s):
        n, dsub = xs.shape
        xhat = _unit(ds)
        # Seeded init on distinct points (same scheme as _kmeans_fit).
        key = jax.random.PRNGKey(s)
        _, init_idx = lax.top_k(jax.random.gumbel(key, (n,)), ksub)
        cents = xs[init_idx]

        def body(c, _):
            return _aniso_step(xs, xhat, c, eta, precision), None

        cents, _ = lax.scan(body, cents, None, length=niter)
        return cents

    seeds = seed + jnp.arange(m, dtype=jnp.int32)
    return jax.vmap(fit_sub)(xsub, dirsub, seeds)


def _subspace(x, m):
    n, d = x.shape
    return x.reshape(n, m, d // m).transpose(1, 0, 2)


def pq_train_anisotropic(x, m: int, ksub: int, eta: float, niter: int = 25,
                         seed: int = DEFAULT_SEED,
                         precision=lax.Precision.DEFAULT, dirs=None):
    """Anisotropic PQ codebooks: k-means under the score-aware loss
    eta*||r_par||^2 + ||r_orth||^2 (eta=1 == plain k-means).  Use with
    INNER_PRODUCT search: parallel residual error shifts scores, so
    penalising it more yields higher recall at the same code budget.

    ``dirs`` (n, d) sets the anisotropy axis per point — defaults to the
    points themselves; for IVF by_residual storage pass the ORIGINAL
    datapoints (the score error lives along x, not the residual)."""
    x = jnp.asarray(x, jnp.float32)
    dirs = x if dirs is None else jnp.asarray(dirs, jnp.float32)
    return _pq_train_aniso(_subspace(x, m), _subspace(dirs, m),
                           jnp.int32(seed), jnp.float32(eta), m=m,
                           ksub=ksub, niter=niter, precision=precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def _pq_encode_aniso(xsub, dirsub, codebooks, eta, *, precision):
    def sub_assign(xs, ds, cb):
        return jnp.argmin(
            _aniso_cost(xs, _unit(ds), cb, eta, precision), axis=1)

    codes = jax.vmap(sub_assign)(xsub, dirsub, codebooks)
    return codes.T.astype(jnp.uint8)


def pq_encode_anisotropic(x, codebooks, eta, *,
                          precision=lax.Precision.DEFAULT, dirs=None):
    """Score-aware encoding matching pq_train_anisotropic's loss: pick the
    sub-codeword minimizing ||x-c||^2 + (eta-1)((x-c)·x̂)^2 instead of the
    plain nearest (measured +2pp recall@10 on top of aniso training)."""
    x = jnp.asarray(x, jnp.float32)
    m = int(codebooks.shape[0])
    dirs = x if dirs is None else jnp.asarray(dirs, jnp.float32)
    return _pq_encode_aniso(_subspace(x, m), _subspace(dirs, m),
                            jnp.asarray(codebooks), jnp.float32(eta),
                            precision=precision)
