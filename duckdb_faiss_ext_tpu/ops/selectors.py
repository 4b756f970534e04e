"""Selection-vector selectors for filtered search.

Device equivalents of ``faiss::IDSelectorBitmap`` / ``IDSelectorBatch``
(src/faiss_extension.cpp:959,1008).  FAISS consults the selector per candidate
inside its scan loops; here a selector resolves to a boolean row mask that the
search kernel fuses into the distance scan (masked lanes → sentinel score), so
filtering costs zero extra memory traffic.

* ``BitmapSelector`` — dense bitmap over the id space, O(n) to build; id ``i``
  passes iff bit ``i`` is set.  Built by ops.bitmap (with the sequential-id
  fast path mirroring ProcessSelectionvector, src/faiss_extension.cpp:729-804).
* ``SetSelector`` — explicit id set, O(m); membership via sorted search.

Masks are resolved against an index's ``row_labels()`` (custom labels for
IDMap, positions otherwise) and cached per (selector, index version).
"""

from __future__ import annotations

import itertools

import numpy as np

# Process-unique selector ids: mask caches key on these.  (id(self) is NOT
# usable — CPython reuses addresses after GC, which would silently serve a
# stale mask built for a dead selector with a different predicate.)
_SELECTOR_IDS = itertools.count()


class Selector:
    def __init__(self):
        self._uid = next(_SELECTOR_IDS)

    def contains(self, labels: np.ndarray) -> np.ndarray:
        """Vectorised membership: bool mask over int64 labels."""
        raise NotImplementedError

    def cache_key(self):
        """Hashable identity for per-index mask caching (unique per
        selector instance for the process lifetime)."""
        return self._uid


class BitmapSelector(Selector):
    """Dense bitmap: label l passes iff bitmap[l >> 3] >> (l & 7) & 1.

    Same layout as faiss::IDSelectorBitmap (LSB-first within each byte),
    which is what the reference's native bitmap builder produces
    (src/faiss_extension.cpp:789-796)."""

    def __init__(self, nbits: int, bitmap: np.ndarray):
        super().__init__()
        self.nbits = int(nbits)
        self.bitmap = np.asarray(bitmap, dtype=np.uint8)
        if self.bitmap.size < (self.nbits + 7) // 8:
            raise ValueError("bitmap too small for nbits")

    @classmethod
    def from_bool(cls, flags: np.ndarray) -> "BitmapSelector":
        flags = np.asarray(flags, dtype=bool)
        return cls(flags.size, np.packbits(flags, bitorder="little"))

    def contains(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.int64)
        in_range = (labels >= 0) & (labels < self.nbits)
        safe = np.where(in_range, labels, 0)
        bits = (self.bitmap[safe >> 3] >> (safe & 7)) & 1
        return (bits.astype(bool)) & in_range


class SetSelector(Selector):
    """Explicit id set (faiss::IDSelectorBatch analogue)."""

    def __init__(self, ids: np.ndarray):
        super().__init__()
        self.ids = np.unique(np.asarray(ids, dtype=np.int64))

    def contains(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.int64)
        if self.ids.size == 0:
            return np.zeros(labels.shape, dtype=bool)
        pos = np.searchsorted(self.ids, labels)
        pos = np.clip(pos, 0, self.ids.size - 1)
        return self.ids[pos] == labels


# --- device-side mask construction ----------------------------------------
# The host path unpacks the bitmap over every stored label (O(n)),
# scatters into the (nlist, lmax) layout (O(nlist*lmax)) and uploads
# ~10 MB of int8 mask at 8.8M rows, per call.  The device
# path uploads only the PACKED bitmap (n/8 bytes, ~1 MB) or sorted id
# set once per selector and computes the per-(list, slot) mask with a
# jitted gather+bit-test over the already-device-resident row_pos —
# per-call host work drops to O(1) after the first use (the reference's
# own path is O(n) per call, src/faiss_extension.cpp:927-972).

def _device_bitmap_mask(bits, rp, labels, nbits):
    import jax.numpy as jnp

    safe_rp = jnp.maximum(rp, 0)
    lab = labels[safe_rp] if labels is not None else safe_rp
    in_range = jnp.logical_and(lab >= 0, lab < nbits)
    safe = jnp.where(in_range, lab, 0).astype(jnp.int32)
    bit = (bits[safe >> 3] >> (safe & 7).astype(jnp.uint8)) & 1
    ok = jnp.logical_and(in_range, rp >= 0)
    return jnp.where(ok, bit, 0).astype(jnp.int8)


def _device_set_mask(ids_sorted, rp, labels):
    import jax.numpy as jnp

    safe_rp = jnp.maximum(rp, 0)
    lab = (labels[safe_rp] if labels is not None
           else safe_rp.astype(jnp.int64))
    pos = jnp.searchsorted(ids_sorted, lab)
    pos = jnp.clip(pos, 0, ids_sorted.shape[0] - 1)
    hit = jnp.logical_and(ids_sorted[pos] == lab, rp >= 0)
    return hit.astype(jnp.int8)


_MASK_JITS: dict = {}


def _mask_jit(kind: str):
    """Module-level jit wrappers (a fresh jax.jit per call would retrace
    and recompile every time)."""
    fn = _MASK_JITS.get(kind)
    if fn is None:
        import jax

        fn = _MASK_JITS[kind] = (
            jax.jit(_device_bitmap_mask, static_argnames=("nbits",))
            if kind == "bitmap" else jax.jit(_device_set_mask))
    return fn


def labels_for_device_mask(ids_host):
    """Resolve an index's label table for the device mask path: None =
    identity (positions ARE labels — no upload), False = host fallback
    required (labels beyond the int32 bit-index range), else the device
    label array.  CALLERS CACHE the result per index version — uploading
    ~70 MB of int64 labels per filtered call would undo the win."""
    import jax.numpy as jnp

    if ids_host is None or not getattr(ids_host, "size", 0):
        return None
    n = ids_host.shape[0]
    if (ids_host[0] == 0 and ids_host[-1] == n - 1
            and np.array_equal(ids_host,
                               np.arange(n, dtype=ids_host.dtype))):
        return None              # identity labels, skip the gather
    if ids_host.max(initial=0) >= (1 << 31):
        return False             # bit-index would overflow int32 gather
    return jnp.asarray(np.ascontiguousarray(ids_host))


def device_row_mask(selector, rp_dev, labels_dev):
    """Per-row int8 pass mask computed ON DEVICE from ``rp_dev`` (any
    shape of int32 storage positions, -1 invalid) and the resolved label
    table (``labels_for_device_mask`` output: None = identity, False =
    unsupported, or a device array).  Returns None when the selector
    shape needs the host fallback."""
    import jax.numpy as jnp

    if labels_dev is False:
        return None
    if isinstance(selector, BitmapSelector):
        if selector.nbits >= (1 << 31):
            return None
        bits = getattr(selector, "_dev_bits", None)
        if bits is None:
            bits = selector._dev_bits = jnp.asarray(selector.bitmap)
        return _mask_jit("bitmap")(bits, rp_dev, labels_dev,
                                   nbits=int(selector.nbits))
    if isinstance(selector, SetSelector):
        if selector.ids.size == 0:
            return None          # empty set: host path returns all-zero
        dev_ids = getattr(selector, "_dev_ids", None)
        if dev_ids is None:
            dev_ids = selector._dev_ids = jnp.asarray(selector.ids)
        return _mask_jit("set")(dev_ids, rp_dev, labels_dev)
    return None
