"""Fused Flat distance + top-k kernel for the GPU (Pallas, Triton route).

The reference's hot path is ``Index::search`` (src/faiss_extension.cpp:
629-638); FAISS's GPU brute force computes distances tile by tile as a
GEMM and selects k on each tile in registers and shared memory, so the
full query × corpus distance matrix is never stored.  This kernel follows
that design: the XLA path (ops/flat_search.py) writes the whole (Q, N)
score tile to device memory and reads it back for the top-k; here only
the corpus is read.

Grid: (query tiles of BQ rows, corpus splits).  Each program keeps a
running candidate set of KP ≥ k slots per query in registers and loops
over its split's corpus tiles of BN rows:

* scores come from one ``pl.dot`` per tile on the TF32 tensor cores
  (fast mode; parity mode stays on the XLA scan), with ``nvalid`` and the
  selector mask applied in the block;
* selection is rounds of max-and-replace: while some query's best
  remaining tile score beats its current k-th best, that score replaces
  the worst live slot and leaves the tile.  At most k rounds per tile,
  and usually none once the set has filled.

Exactness: a slot is only ever replaced by a strictly larger score, and
the KP - k padding slots start at +inf so they are never the worst slot,
so the k live slots end as the split's exact top-k.  Each program writes
its k live candidates; XLA sorts the (Q, splits·KP) candidates by (score,
position) and keeps k.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .flat_search import finalize_scores

_NEG_INF = float("-inf")

#: queries per block: the tensor cores' 64-row tile
BQ = 64
#: largest k the kernel serves (the candidate set lives in registers)
K_MAX = 64
#: programs to aim for: a few per SM of an H100 (132 SMs)
TARGET_PROGRAMS = 512


def use_fused_kernel(platform: str, metric: str, k: int, d: int,
                     storage: str, n_devices: int, precision) -> bool:
    """Whether Flat search takes this kernel: a single GPU, fast precision
    (TF32 tensor cores), L2 or inner product, fp32 storage, 1 ≤ k ≤ K_MAX,
    and a power-of-two dimension the block tiles hold (16..256).  At
    HIGHEST the kernel's fp32 products run outside the tensor cores and
    lose to XLA's scan, so parity mode stays on XLA."""
    return (platform == "gpu" and n_devices == 1 and storage == "f32"
            and precision != lax.Precision.HIGHEST
            and metric in ("L2", "INNER_PRODUCT") and 1 <= k <= K_MAX
            and 16 <= d <= 256 and d & (d - 1) == 0)


def choose_tiles(nq_pad: int, cap: int, d: int, k: int):
    """(bn, kp, splits): corpus rows per tile, candidate slots per query,
    and corpus splits — enough programs to fill the card, each split a
    whole number of tiles."""
    bn = 128 if d <= 128 else 64
    kp = max(16, 1 << (k - 1).bit_length())
    n_tiles = cap // bn
    q_tiles = -(-nq_pad // BQ)
    splits = 1
    while splits * 2 <= n_tiles and splits * q_tiles < TARGET_PROGRAMS \
            and n_tiles % (splits * 2) == 0:
        splits *= 2
    return bn, kp, splits


def _kernel(nvalid_ref, xq_ref, xb_ref, *rest, k, kp, bn, metric,
            precision, has_mask):
    if has_mask:
        mask_ref, out_s_ref, out_i_ref = rest
    else:
        out_s_ref, out_i_ref = rest
    split_rows = xb_ref.shape[0]
    base = pl.program_id(1) * split_rows
    q = xq_ref[...]                                          # (BQ, d)
    qn = jnp.sum(q * q, axis=1)
    nvalid = nvalid_ref[...]
    lane = lax.broadcasted_iota(jnp.int32, (BQ, bn), 1)
    klane = lax.broadcasted_iota(jnp.int32, (BQ, kp), 1)

    def improves(s, bs):
        return jnp.max((jnp.max(s, axis=1) > jnp.min(bs, axis=1))
                       .astype(jnp.int32)) > 0

    def insert(carry):
        s, bs, bi, r0 = carry
        m = jnp.max(s, axis=1)
        a = jnp.argmax(s, axis=1).astype(jnp.int32)
        worst = jnp.min(bs, axis=1)
        slot = jnp.argmin(bs, axis=1).astype(jnp.int32)
        take = jnp.logical_and(klane == slot[:, None], (m > worst)[:, None])
        bs = jnp.where(take, m[:, None], bs)
        bi = jnp.where(take, r0 + a[:, None], bi)
        s = jnp.where(lane == a[:, None], _NEG_INF, s)
        return s, bs, bi, r0

    def tile(t, carry):
        bs, bi = carry
        r = pl.multiple_of(t * bn, bn)
        xb = xb_ref[pl.ds(r, bn), :]                         # (bn, d)
        xy = pl.dot(q, xb, trans_b=True, precision=precision)
        if metric == "INNER_PRODUCT":
            s = xy
        else:
            xn = jnp.sum(xb * xb, axis=1)
            s = -jnp.maximum(qn[:, None] - 2.0 * xy + xn[None, :], 0.0)
        valid = base + r + lane < nvalid
        if has_mask:
            valid = jnp.logical_and(
                valid, (mask_ref[pl.ds(r, bn)] != 0)[None, :])
        s = jnp.where(valid, s, _NEG_INF)
        _, bs, bi, _ = lax.while_loop(
            lambda c: improves(c[0], c[1]), insert, (s, bs, bi, base + r))
        return bs, bi

    init = (jnp.where(klane < k, _NEG_INF, jnp.inf).astype(jnp.float32),
            jnp.full((BQ, kp), -1, jnp.int32))
    bs, bi = lax.fori_loop(0, split_rows // bn, tile, init)
    out_s_ref[...] = jnp.where(bi < 0, _NEG_INF, bs)
    out_i_ref[...] = bi


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "precision", "interpret"))
def fused_flat_search(xb_pad, nvalid, xq_pad, mask, *, k: int, metric: str,
                      precision, interpret: bool = False):
    """Same contract as ops.flat_search.flat_search for L2/INNER_PRODUCT:
    (distances (nq_pad, k) with FAISS sentinels, positions (nq_pad, k),
    -1 where fewer than k candidates)."""
    cap, d = xb_pad.shape
    nq = xq_pad.shape[0]
    bn, kp, splits = choose_tiles(nq, cap, d, k)
    nq_k = -(-nq // BQ) * BQ
    xq = jnp.pad(xq_pad, ((0, nq_k - nq), (0, 0)))
    split_rows = cap // splits
    has_mask = mask is not None
    in_specs = [
        pl.BlockSpec((), lambda i, j: ()),
        pl.BlockSpec((BQ, d), lambda i, j: (i, 0)),
        pl.BlockSpec((split_rows, d), lambda i, j: (j, 0)),
    ]
    args = [jnp.asarray(nvalid, jnp.int32), xq, xb_pad]
    if has_mask:
        in_specs.append(pl.BlockSpec((split_rows,), lambda i, j: (j,)))
        args.append(mask.astype(jnp.int8))
    kernel = functools.partial(_kernel, k=k, kp=kp, bn=bn, metric=metric,
                               precision=precision, has_mask=has_mask)
    out_s, out_i = pl.pallas_call(
        kernel,
        grid=(nq_k // BQ, splits),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((BQ, kp), lambda i, j: (i, j)),
                   pl.BlockSpec((BQ, kp), lambda i, j: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((nq_k, splits * kp), jnp.float32),
                   jax.ShapeDtypeStruct((nq_k, splits * kp), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="flat_topk",
    )(*args)
    # Merge the splits: score descending, then position ascending, so
    # ties resolve to the lower row as in the XLA path.
    order_key = jnp.where(out_i < 0, jnp.iinfo(jnp.int32).max, out_i)
    neg, _, pos = lax.sort((-out_s, order_key, out_i), num_keys=2)
    return finalize_scores((-neg)[:nq, :k], pos[:nq, :k], metric)
