"""Result-transfer packing: bit-exact roundtrip of distances + positions.

Regression for a silent-corruption bug: positions bitcast into a float
buffer are denormals, and a float transport may flush them to zero
(every label collapsed to row 0).  The pack direction must keep the wire
buffer integer-typed."""

import numpy as np
import jax.numpy as jnp

from duckdb_faiss_ext_tpu.utils.transfer import fetch_results


def test_roundtrip_exact():
    d = jnp.asarray(np.array([[1.5, np.inf, -np.inf],
                              [0.0, 160.25, 3.4e38]], np.float32))
    p = jnp.asarray(np.array([[2908, 0, -1],
                              [7, 123456, 2 ** 30]], np.int32))
    dd, pp = fetch_results(d, p)
    np.testing.assert_array_equal(pp, np.asarray(p))
    np.testing.assert_array_equal(dd, np.asarray(d))


def test_small_int_positions_not_flushed():
    # 1..1000 bitcast to f32 are denormals — the historical failure mode.
    k = 1000
    d = jnp.zeros((1, k), jnp.float32)
    p = jnp.asarray(np.arange(1, k + 1, dtype=np.int32)[None, :])
    _, pp = fetch_results(d, p)
    np.testing.assert_array_equal(pp[0], np.arange(1, k + 1))


def test_k_zero():
    d = jnp.zeros((3, 0), jnp.float32)
    p = jnp.zeros((3, 0), jnp.int32)
    dd, pp = fetch_results(d, p)
    assert dd.shape == (3, 0) and pp.shape == (3, 0)


def test_upload_queries_wire_formats():
    """fp16/sq8 wire formats reconstruct queries to within their design
    error; f32 is exact; auto respects precision mode and size gate."""
    import numpy as np

    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.utils.config import config
    from duckdb_faiss_ext_tpu.utils.transfer import upload_queries

    rng = np.random.default_rng(5)
    xq = rng.standard_normal((512, 1536)).astype(np.float32)
    xq /= np.linalg.norm(xq, axis=1, keepdims=True)
    try:
        config.query_wire = "f32"
        np.testing.assert_array_equal(np.asarray(upload_queries(xq)), xq)
        config.query_wire = "f16"
        got = np.asarray(upload_queries(xq))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, xq, atol=2e-4)
        config.query_wire = "sq8"
        got = np.asarray(upload_queries(xq))
        span = xq.max(0) - xq.min(0)
        assert np.abs(got - xq).max() <= (span / 255.0).max() * 0.51 + 1e-7
        # auto: parity mode keeps f32 exactly
        config.query_wire = "auto"
        dfx.set_precision("parity")
        np.testing.assert_array_equal(np.asarray(upload_queries(xq)), xq)
    finally:
        config.query_wire = "auto"
        dfx.set_precision("parity")
