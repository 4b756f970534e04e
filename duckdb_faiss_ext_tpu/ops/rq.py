"""Residual-quantizer codec: additive multi-stage codebooks (faiss RQ).

Equivalent of faiss::IndexResidualQuantizer as reachable through
``index_factory`` (``RQ{M}x{b}`` — the reference forwards factory strings
verbatim, src/faiss_extension.cpp:154-155).  Unlike PQ's disjoint
subspaces, every stage holds full-dimension codewords and the
reconstruction is their SUM: dec(c) = Σ_m cb[m][c_m].

The design mirrors ops/pq.py: no lookup tables — corpus chunks are
decoded on the fly (one-hot × codebook contractions on the matmul, summed
over stages) and pushed through the shared pairwise distance tile, so the
8-bit codes are all that crosses HBM.  Encoding is a batched beam search
(beam=1 ⇒ greedy): each stage scores every candidate residual against the
stage codebook with one matmul and keeps the best ``beam`` expansions.

Training is the standard sequential residual k-means: stage m fits
codewords to the residuals left by stages < m (stages are dependent, so
unlike PQ they cannot be vmapped)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .kmeans import DEFAULT_SEED, _kmeans_fit


def rq_train(x, m: int, ksub: int, niter: int = 25, seed: int = DEFAULT_SEED,
             precision=lax.Precision.DEFAULT):
    """Train additive codebooks on (n, d) data → (m, ksub, d) fp32."""
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    valid = jnp.ones((n,), bool)
    resid = x
    books = []
    for stage in range(m):
        cb, labels = _kmeans_fit(resid, valid, jnp.int32(seed + stage),
                                 k=ksub, niter=niter, precision=precision)
        books.append(cb)
        resid = resid - cb[labels]
    return jnp.stack(books)


def _onehot_decode_stage(codes_m, cb):
    """codes_m (c,) int32, cb (ksub, d) → (c, d) selected codewords via a
    one-hot matmul (exact at HIGHEST precision)."""
    ksub = cb.shape[0]
    onehot = (codes_m[:, None] ==
              jnp.arange(ksub, dtype=jnp.int32)[None, :]).astype(jnp.float32)
    return jnp.dot(onehot, cb, precision=lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)


def rq_decode(codes, codebooks):
    """Decode (c, m) uint8 codes → (c, d) fp32: sum of stage codewords,
    each gathered from its stage codebook."""
    m, ksub, d = codebooks.shape
    idx = codes.astype(jnp.int32)                         # (c, m)
    gathered = jnp.take_along_axis(
        codebooks[None, :, :, :],                         # (1, m, ksub, d)
        idx[:, :, None, None], axis=2)                    # (c, m, 1, d)
    return gathered.reshape(codes.shape[0], m, d).sum(axis=1)


@functools.partial(jax.jit, static_argnames=("m", "beam", "precision"))
def _rq_encode(x, codebooks, *, m, beam, precision):
    n, d = x.shape
    ksub = codebooks.shape[1]
    hp = lax.Precision.HIGHEST

    # Beam state: residuals (n, B, d), codes (n, B, m), errors (n, B).
    # Stage 0 seeds the beam with the best `beam` codewords.
    cb0 = codebooks[0]
    xn = jnp.sum(x * x, 1, keepdims=True)
    cn0 = jnp.sum(cb0 * cb0, 1)[None, :]
    d0 = xn - 2.0 * jnp.dot(x, cb0.T, precision=precision,
                            preferred_element_type=jnp.float32) + cn0
    _, pick = lax.top_k(-d0, beam)                         # (n, B)
    resid = x[:, None, :] - _onehot_decode_stage(
        pick.reshape(-1), cb0).reshape(n, beam, d)
    codes = pick[:, :, None].astype(jnp.int32)             # (n, B, 1)

    for stage in range(1, m):
        cb = codebooks[stage]
        rn = jnp.sum(resid * resid, 2, keepdims=True)      # (n, B, 1)
        cn = jnp.sum(cb * cb, 1)[None, None, :]
        rc = jnp.einsum("nbd,kd->nbk", resid, cb, precision=precision,
                        preferred_element_type=jnp.float32)
        dist = (rn - 2.0 * rc + cn).reshape(n, beam * ksub)
        _, flat = lax.top_k(-dist, beam)                   # (n, B)
        parent = flat // ksub
        code = (flat % ksub).astype(jnp.int32)
        resid = jnp.take_along_axis(resid, parent[:, :, None], axis=1)
        resid = resid - _onehot_decode_stage(
            code.reshape(-1), cb).reshape(n, beam, d)
        codes = jnp.take_along_axis(codes, parent[:, :, None], axis=1)
        codes = jnp.concatenate([codes, code[:, :, None]], axis=2)

    # Best beam entry = smallest remaining residual norm.
    errs = jnp.sum(resid * resid, 2)                       # (n, B)
    best = jnp.argmin(errs, axis=1)
    out = jnp.take_along_axis(codes, best[:, None, None], axis=1)[:, 0, :]
    return out.astype(jnp.uint8)


def rq_encode(x, codebooks, *, beam: int = 4,
              precision=lax.Precision.DEFAULT):
    """Encode (n, d) → (n, m) uint8 codes with batched beam search
    (beam=1 ⇒ greedy).  Every stage is one matmul over the whole beam."""
    x = jnp.asarray(x, jnp.float32)
    m = int(codebooks.shape[0])
    beam = max(1, min(int(beam), int(codebooks.shape[1])))
    return _rq_encode(x, jnp.asarray(codebooks), m=m, beam=beam,
                      precision=precision)
