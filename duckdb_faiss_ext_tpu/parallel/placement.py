"""Index placement: the faiss_to_gpu analogue.

The reference clones a CPU index wholesale onto one GPU
(faiss::gpu::index_cpu_to_gpu, src/gpu/gpu.cpp:44-48).  The device-native
equivalent of "move to the accelerator" is re-sharding the index's device
arrays over a mesh: rows of the corpus partitioned across devices with a
NamedSharding, so subsequent searches run as sharded computations with a
distributed top-k merge (parallel/sharded.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..catalog import IndexEntry
from ..errors import InvalidInputError
from ..models.flat import FlatIndex
from ..models.idmap import IDMapIndex
from ..utils.config import pad_rows


def default_mesh(devices=None) -> Mesh:
    """2-axis (shard × batch=1) mesh: every sharded search path (flat and
    IVF) expects both axis names to exist.  ``devices`` may be None (all
    local devices), an int device index (the reference's
    ``faiss_to_gpu(name, device)`` form, src/gpu/gpu.cpp:34-63), a
    jax.Device, or an iterable of either."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    elif isinstance(devices, int) or hasattr(devices, "platform"):
        devices = [devices]
    local = jax.devices()
    resolved = []
    for dev in devices:
        if isinstance(dev, int):
            if not 0 <= dev < len(local):
                # Bad-device error mirroring "Invalid GPU index"
                # (src/gpu/gpu.cpp:57).
                raise InvalidInputError(
                    f"Invalid device index: {dev} "
                    f"({len(local)} devices available)")
            dev = local[dev]
        resolved.append(dev)
    return Mesh(np.array(resolved).reshape(len(resolved), 1),
                ("shard", "batch"))


def shard_entry(entry: IndexEntry, devices=None) -> None:
    """Reshard an index's storage over a device mesh (rows over 'shard')."""
    mesh = devices if isinstance(devices, Mesh) else default_mesh(devices)
    index = entry.index
    # Unwrap composition wrappers down to the storage-owning index:
    # IDMap/PreTransform delegate wholly; RefineFlat shards BOTH parts —
    # the compressed base (candidate generation) and the raw fp32 refine
    # store, which otherwise dominates per-device memory (its per-query
    # gathers of k_factor·k rows partition fine under GSPMD).
    inner = index
    while True:
        if isinstance(inner, IDMapIndex):
            inner = inner.inner
        elif type(inner).__name__ == "PreTransformIndex":
            inner = inner.inner
        elif type(inner).__name__ == "RefineFlatIndex":
            _shard_flat(inner.refine, mesh)
            inner = inner.base
        else:
            break
    if isinstance(inner, FlatIndex):
        _shard_flat(inner, mesh)
        return
    shard = getattr(inner, "shard_over", None)
    if shard is not None:
        shard(mesh)
        return
    # Mirrors the reference's friendly unsupported-type error
    # (src/gpu/gpu.cpp:52-58).
    raise InvalidInputError(
        f"Index of type {type(inner).__name__} cannot be sharded over devices")


def _shard_flat(index: FlatIndex, mesh: Mesh) -> None:
    # Sticky: the index re-materialises with this sharding after future
    # adds (capacity rounding for the device count happens inside).
    index.set_placement(NamedSharding(mesh, P("shard", None)))
    index.device_vectors()
