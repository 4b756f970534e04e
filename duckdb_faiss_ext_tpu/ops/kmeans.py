"""Lloyd's k-means in JAX — the training kernel behind IVF/PQ indexes.

Device replacement for faiss::Clustering as driven by ``Index::train``
(src/faiss_extension.cpp:396,583): assignment is a matmul distance matmul +
argmin; the centroid update is a segment-sum — both batched, static-shaped,
and shardable (assignment is embarrassingly parallel over points; the update
reduces with ``psum`` across data shards, see parallel/sharded.py).

Determinism: initial centroids are a seeded sample without replacement
(default seed 1234, FAISS's Clustering default); iterations are fixed-count
``lax.scan``.  Empty clusters keep their previous centroid (documented
deviation from FAISS's split-largest heuristic; deterministic and
shard-order-independent).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

DEFAULT_NITER = 25       # faiss::ClusteringParameters::niter
DEFAULT_SEED = 1234      # faiss::ClusteringParameters::seed
MAX_POINTS_PER_CENTROID = 256  # faiss subsamples beyond this


def assign_labels(x, centroids, precision=lax.Precision.DEFAULT):
    """Nearest-centroid assignment: (n,) int32 via L2 matmul + argmin."""
    xn = jnp.sum(x * x, axis=1, keepdims=True)
    cn = jnp.sum(centroids * centroids, axis=1)[None, :]
    xc = jnp.dot(x, centroids.T, precision=precision,
                 preferred_element_type=jnp.float32)
    d = xn - 2.0 * xc + cn
    return jnp.argmin(d, axis=1).astype(jnp.int32)


def centroid_update(x, labels, k, weights=None):
    """Per-cluster (sums (k, d), counts (k,)) — segment-sum formulated as a
    one-hot matmul so it rides the matmul and shards cleanly."""
    onehot = jax.nn.one_hot(labels, k, dtype=x.dtype)  # (n, k)
    if weights is not None:
        onehot = onehot * weights[:, None]
    sums = jnp.dot(onehot.T, x, preferred_element_type=jnp.float32)
    counts = jnp.sum(onehot, axis=0)
    return sums, counts


@functools.partial(jax.jit,
                   static_argnames=("k", "niter", "precision", "balance",
                                    "spherical"))
def _kmeans_fit(x, valid, seed, *, k, niter, precision, balance=0.0,
                spherical=False):
    n, d = x.shape
    key = jax.random.PRNGKey(seed)
    # Seeded init: sample k distinct valid points.  Invalid (padding) rows get
    # -inf priority so they are never picked while n_valid >= k.
    gumbel = jax.random.gumbel(key, (n,))
    priority = jnp.where(valid, gumbel, -jnp.inf)
    _, init_idx = lax.top_k(priority, k)
    centroids = x[init_idx]

    navg = jnp.maximum(jnp.sum(valid.astype(jnp.float32)) / k, 1.0)

    def step(carry, _):
        centroids, counts = carry
        if balance > 0.0:
            # Skew-aware assignment: penalise over-full clusters so hot
            # lists shrink (keeps the padded IVF list_table tight; the
            # skew-handling called for by BASELINE.json's north star).
            # The penalty must live on the scale of *differences* between
            # competing centroid distances, not the absolute norm — for
            # high-dim data mean ‖x‖² dwarfs those differences and an
            # over-scaled penalty collapses the clustering entirely
            # (observed at nlist=16k).  Use the mean assigned distance and
            # clamp the overfullness factor.
            d2 = _assignment_distances(x, centroids, precision)
            scale = jnp.mean(jnp.min(d2, axis=1)) * 0.5
            over = jnp.clip(counts / navg - 1.0, 0.0, 2.0)
            penalty = balance * scale * over[None, :]
            labels = jnp.argmin(d2 + penalty, axis=1).astype(jnp.int32)
        else:
            labels = assign_labels(x, centroids, precision)
        # Padding rows must not pull centroids: zero their weight.
        w = valid.astype(x.dtype)
        sums, new_counts = centroid_update(x, labels, k, weights=w)
        new = sums / jnp.maximum(new_counts, 1.0)[:, None]
        if spherical:
            # Spherical k-means: renormalise centroids every iteration
            # (faiss Level1Quantizer::train_q1 sets cp.spherical for
            # METRIC_INNER_PRODUCT indexes) — IP probe selection against
            # unnormalised centroids is biased toward large-norm lists.
            new = new / jnp.maximum(
                jnp.linalg.norm(new, axis=1, keepdims=True), 1e-20)
        new = jnp.where((new_counts > 0)[:, None], new, centroids)
        return (new, new_counts), None

    init_counts = jnp.full((k,), navg, jnp.float32)
    (centroids, _), _ = lax.scan(step, (centroids, init_counts), None,
                                 length=niter)
    final_labels = assign_labels(x, centroids, precision)
    return centroids, final_labels


def _assignment_distances(x, centroids, precision=lax.Precision.DEFAULT):
    """Squared-L2 distance matrix used by (penalized) assignment."""
    xn = jnp.sum(x * x, axis=1, keepdims=True)
    cn = jnp.sum(centroids * centroids, axis=1)[None, :]
    xc = jnp.dot(x, centroids.T, precision=precision,
                 preferred_element_type=jnp.float32)
    return xn - 2.0 * xc + cn


def kmeans_fit(x, k, niter=DEFAULT_NITER, seed=DEFAULT_SEED,
               valid=None, precision=lax.Precision.DEFAULT,
               balance=0.0, spherical=False):
    """Fit k centroids on (n, d) fp32 data (rows where ``valid`` is False are
    padding).  ``balance`` > 0 penalises over-full clusters (skew control);
    ``spherical`` renormalises centroids per iteration (IP metric).
    Returns (centroids (k, d), labels (n,) int32)."""
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    if valid is None:
        valid = jnp.ones((n,), bool)
    return _kmeans_fit(x, valid, jnp.int32(seed), k=int(k), niter=int(niter),
                       precision=precision, balance=float(balance),
                       spherical=bool(spherical))


def subsample_for_training(n: int, k: int) -> int:
    """FAISS trains on at most k*max_points_per_centroid points."""
    return min(n, k * MAX_POINTS_PER_CENTROID)
