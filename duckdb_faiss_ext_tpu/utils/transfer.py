"""Device→host result transfer helpers.

Fetching two arrays costs two device-to-host syncs; a search result is tiny
(nq × k), so latency dominates.  ``fetch_results`` packs (distances f32,
positions i32) into one (nq, 2k) **int32** buffer on device and performs a
single host transfer, then unpacks with numpy views.

The packing direction matters: the float distances are bitcast into the
int32 buffer, NOT the other way around.  Positions bitcast to float32 are
denormals/NaN payloads, and float transports may canonicalize NaNs or flush
denormals to zero.  Integer buffers transfer bit-exactly.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def fetch_results(dist, pos):
    """(nq, k) f32 distances + (nq, k) i32 positions → numpy, one transfer."""
    k = dist.shape[1]
    if k == 0:
        return (np.asarray(dist), np.asarray(pos, dtype=np.int32))
    packed = jnp.concatenate(
        [jax.lax.bitcast_convert_type(dist, jnp.int32),
         pos.astype(jnp.int32)], axis=1)
    host = np.ascontiguousarray(np.asarray(packed))
    d = np.ascontiguousarray(host[:, :k]).view(np.float32)
    p = host[:, k:].copy()
    return d, p


def upload_queries(xq_np, lossy_ok: bool = False):
    """Host→device query upload with a halved wire format in fast mode.

    In fast precision mode queries larger than 1 MB go over the wire as
    fp16 (or 1-byte sq8 when the index storage is itself coarsely
    quantized) and are cast back to f32 on device: unit-norm embedding
    values lose ~6e-4 relative, orders of magnitude below SQ/PQ storage
    quantization noise.  Parity mode and small uploads keep full f32.
    config.query_wire forces "f32"/"f16".  Whether the smaller wire pays
    on a given host link is an open question (ROADMAP)."""
    from jax import lax

    from .config import config

    xq_np = np.ascontiguousarray(xq_np, dtype=np.float32)
    wire = config.query_wire
    if wire == "auto":
        if (config.precision == lax.Precision.HIGHEST
                or xq_np.nbytes <= (1 << 20)):
            wire = "f32"
        else:
            # ``lossy_ok``: the caller's STORAGE is coarsely quantized
            # (sq8/sq4/sq6/PQ), so sq8 query noise (~range/510 per dim)
            # sits far below the codec's own.  Near-exact storages keep
            # fp16.
            wire = "sq8" if lossy_ok else "f16"
    if wire == "f16":
        return jnp.asarray(xq_np.astype(np.float16)).astype(jnp.float32)
    if wire == "sq8":
        # 1 byte/dim: per-dim affine quantization with batch-local
        # ranges (the 2·d fp32 range rows are noise next to nq rows).
        vmin = xq_np.min(axis=0)
        scale = (xq_np.max(axis=0) - vmin) / 255.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.round((xq_np - vmin[None, :]) / scale[None, :])
        q = np.clip(q, 0, 255).astype(np.uint8)
        return (jnp.asarray(q).astype(jnp.float32)
                * jnp.asarray(scale)[None, :]
                + jnp.asarray(vmin)[None, :])
    return jnp.asarray(xq_np)
