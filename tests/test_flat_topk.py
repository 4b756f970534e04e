"""The fused Flat top-k kernel (ops/flat_topk.py): results in Pallas
interpret mode against a float64 reference and the XLA scan, the rule that
chooses it, and its lowering to Triton for the GPU."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

from duckdb_faiss_ext_tpu.ops.flat_search import flat_search
from duckdb_faiss_ext_tpu.ops.flat_topk import (BQ, K_MAX, choose_tiles,
                                                fused_flat_search,
                                                use_fused_kernel)

RNG = np.random.default_rng(21)


def _reference(xb, n, xq, k, metric, mask):
    """float64 brute force over the first n rows (and the mask)."""
    x = xb[:n].astype(np.float64)
    q = xq.astype(np.float64)
    if metric == "L2":
        score = -((q[:, None, :] - x[None]) ** 2).sum(-1)
    else:
        score = q @ x.T
    if mask is not None:
        score[:, ~mask[:n]] = -np.inf
    if n < k:
        score = np.pad(score, ((0, 0), (0, k - n)),
                       constant_values=-np.inf)
    order = np.argsort(-score, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(score, order, axis=1)
    order = np.where(np.isneginf(top), -1, order)
    dist = -top if metric == "L2" else top
    return dist, order


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("nq,cap,n,k", [
    (8, 512, 400, 10),      # one padded query tile, nvalid < cap
    (16, 1024, 1024, 3),    # full corpus
    (128, 256, 200, 64),    # two query tiles, k = K_MAX
    (8, 256, 4, 10),        # fewer valid rows than k
])
def test_kernel_matches_reference(nq, cap, n, k, metric, masked):
    d = 32
    xb = np.zeros((cap, d), np.float32)
    xb[:n] = RNG.standard_normal((n, d)).astype(np.float32)
    xq = RNG.standard_normal((nq, d)).astype(np.float32)
    mask = (RNG.random(cap) < 0.5) if masked else None
    mdev = jnp.asarray(mask) if masked else None

    dist, pos = fused_flat_search(
        jnp.asarray(xb), n, jnp.asarray(xq), mdev, k=k, metric=metric,
        precision=lax.Precision.HIGHEST, interpret=True)
    ref_d, ref_p = _reference(xb, n, xq, k, metric, mask)
    dist, pos = np.asarray(dist), np.asarray(pos)
    assert dist.shape == pos.shape == (nq, k)
    np.testing.assert_array_equal(pos, ref_p)
    live = ref_p >= 0
    np.testing.assert_allclose(dist[live], ref_d[live], rtol=1e-4,
                               atol=1e-4)
    sentinel = np.inf if metric == "L2" else -np.inf
    assert (dist[~live] == sentinel).all()
    if masked:
        assert mask[pos[live]].all()
    xla_d, xla_p = flat_search(jnp.asarray(xb), n, jnp.asarray(xq), k,
                               metric, mask=mdev)
    np.testing.assert_array_equal(pos, np.asarray(xla_p))


@pytest.mark.parametrize("case,expected", [
    (dict(), True),
    (dict(platform="cpu"), False),
    (dict(precision=lax.Precision.HIGHEST), False),
    (dict(metric="L1"), False),
    (dict(k=K_MAX + 1), False),
    (dict(d=96), False),
    (dict(d=512), False),
    (dict(storage="pm1_i8"), False),
    (dict(n_devices=4), False),
])
def test_kernel_choice_rule(case, expected):
    args = dict(platform="gpu", metric="L2", k=10, d=128, storage="f32",
                n_devices=1, precision=lax.Precision.DEFAULT)
    args.update(case)
    assert use_fused_kernel(**args) is expected


@pytest.mark.parametrize("nq,cap,d,k,want", [
    (64, 1 << 20, 128, 10, (128, 16, 512)),    # b48: the corpus splits
    (1024, 1 << 20, 128, 10, (128, 16, 32)),   # b1024: query tiles fill
    (8, 256, 256, 40, (64, 64, 4)),            # small corpus, wide rows
])
def test_tile_choice(nq, cap, d, k, want):
    bn, kp, splits = choose_tiles(nq, cap, d, k)
    assert (bn, kp, splits) == want
    assert cap % (bn * splits) == 0 and kp >= k
    assert splits * -(-nq // BQ) <= 512 or splits == 1


@pytest.mark.parametrize("metric", ["L2", "INNER_PRODUCT"])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_lowers_to_triton_for_cuda(metric, masked):
    """The kernel lowers to a Triton custom call for the GPU at the 1M x
    128 benchmark width (compiling it needs the card)."""
    fn = jax.jit(functools.partial(fused_flat_search, k=10, metric=metric,
                                   precision=lax.Precision.DEFAULT))
    args = (jax.ShapeDtypeStruct((1 << 20, 128), jnp.float32),
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((64, 128), jnp.float32),
            jax.ShapeDtypeStruct((1 << 20,), jnp.bool_) if masked else None)
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text


def test_flat_index_reports_its_scan_path(catalog):
    import duckdb_faiss_ext_tpu as dfx

    xb = RNG.standard_normal((300, 16)).astype(np.float32)
    dfx.faiss_create("fp", 16, "Flat", catalog=catalog)
    dfx.faiss_add(xb, "fp", catalog=catalog)
    dfx.faiss_search("fp", 3, xb[:4], catalog=catalog)
    stats = dfx.faiss_stats("fp", catalog=catalog)
    assert stats["indexes"]["fp"]["last_scan_path"] == "xla-scan"
