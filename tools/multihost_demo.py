#!/usr/bin/env python
"""Two-process jax.distributed demo/validation of the multi-host search path.

CPU only: each process pins the CPU backend with 2 virtual devices → a
4-device global mesh across 2 "hosts".  Launch from the repo root:

    python tools/multihost_demo.py            # spawns both workers

Each worker initialises the distributed runtime (parallel/multihost.py),
owns the corpus rows hash-partitioned to it, builds the globally-sharded
corpus buffer, and runs the sharded flat search with the cross-host
all-gather merge.  Worker 0 checks the result against a local brute-force
oracle.  This exercises the same code the driver's multichip dry run
compiles, but across real process boundaries.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REPO = __file__.rsplit("/", 2)[0]
sys.path.insert(0, REPO)

PORT = int(os.environ.get("DFX_DEMO_PORT", "12357"))
NPROC = int(os.environ.get("DFX_DEMO_NPROC", "2"))
DEV_PER_PROC = int(os.environ.get("DFX_DEMO_DEV_PER_PROC", "2"))


def worker(pid: int) -> int:
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEV_PER_PROC}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from duckdb_faiss_ext_tpu.parallel.multihost import init_multihost

    init_multihost(f"127.0.0.1:{PORT}", num_processes=NPROC, process_id=pid)
    assert jax.process_count() == NPROC
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from duckdb_faiss_ext_tpu.ops.flat_search import flat_search
    from duckdb_faiss_ext_tpu.parallel.sharded import sharded_flat_search_fn

    n_dev = NPROC * DEV_PER_PROC
    d, cap, n, nq, k = 16, 256, 250, 8, 5
    if cap % n_dev:
        raise SystemExit(
            f"NPROC×DEV_PER_PROC = {n_dev} must divide the demo corpus "
            f"capacity ({cap}) so every device gets an equal row shard — "
            f"use 1, 2, 4, 8, ... total devices")
    rng = np.random.default_rng(0)  # same seed everywhere → shared "corpus"
    xb = np.zeros((cap, d), np.float32)
    xb[:n] = rng.standard_normal((n, d)).astype(np.float32)
    xq = rng.standard_normal((nq, d)).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()).reshape(n_dev, 1),
                ("shard", "batch"))
    sharding = NamedSharding(mesh, P("shard", None))
    # Each process contributes its local slice of the row-sharded corpus.
    rows_per_dev = cap // n_dev
    local_rows = xb[pid * DEV_PER_PROC * rows_per_dev:
                    (pid + 1) * DEV_PER_PROC * rows_per_dev]
    xb_global = jax.make_array_from_process_local_data(sharding, local_rows,
                                                       (cap, d))
    xq_global = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, None)), xq, (nq, d))

    from jax.experimental import multihost_utils

    fn = sharded_flat_search_fn(mesh, k=k, metric="L2", chunk=rows_per_dev)
    dist, pos = fn(xb_global, jnp.int32(n), xq_global, jnp.float32(0.0))
    dist_local = np.asarray(
        multihost_utils.process_allgather(dist, tiled=True))

    if pid == 0:
        ref_d, ref_p = flat_search(jnp.asarray(xb), n, jnp.asarray(xq), k,
                                   "L2")
        np.testing.assert_allclose(dist_local.reshape(nq, k),
                                   np.asarray(ref_d), rtol=1e-5, atol=1e-6)
        print(f"MULTIHOST OK: {NPROC} processes × {DEV_PER_PROC} devices, "
              f"sharded search matches the single-process oracle")

    # --- sharded IVFPQ with a selector mask across the processes ----------
    from duckdb_faiss_ext_tpu.ops.pq import pq_decode, pq_encode, pq_train
    from duckdb_faiss_ext_tpu.parallel.sharded import sharded_ivf_search_fn

    nlist, lmax, m, npb = n_dev * 2, 16, 4, 3
    cents = rng.standard_normal((nlist, d)).astype(np.float32) * 3
    raw = (cents[:, None, :] + 0.3 * rng.standard_normal(
        (nlist, lmax, d)).astype(np.float32))
    resid = raw.reshape(-1, d) - np.repeat(cents, lmax, axis=0)
    codebooks = np.asarray(pq_train(resid, m, 16, seed=0), np.float32)
    codes = np.asarray(pq_encode(jnp.asarray(resid),
                                 jnp.asarray(codebooks))
                       ).reshape(nlist, lmax, m)
    counts = np.full((nlist,), lmax, np.int32)
    row_pos = np.arange(nlist * lmax, dtype=np.int32).reshape(nlist, lmax)
    sel_mask = (row_pos % 3 == 0).astype(np.int8)

    def put(arr, spec):
        sh = NamedSharding(mesh, spec)
        rows = arr.shape[0] // NPROC
        return jax.make_array_from_process_local_data(
            sh, arr[pid * rows:(pid + 1) * rows], arr.shape)

    ivf_fn = sharded_ivf_search_fn(mesh, k=k, nprobe=npb, metric="L2",
                                   pq=True, has_mask=True)
    di, pi = ivf_fn(
        put(codes, P("shard", None, None)), put(counts, P("shard")),
        put(row_pos, P("shard", None)), jnp.asarray(cents),
        xq_global, jnp.float32(0.0), jnp.asarray(codebooks),
        put(sel_mask, P("shard", None)))
    di_all = np.asarray(multihost_utils.process_allgather(di, tiled=True))
    pi_all = np.asarray(multihost_utils.process_allgather(pi, tiled=True))

    if pid == 0:
        dec = (np.asarray(pq_decode(jnp.asarray(codes.reshape(-1, m)),
                                    jnp.asarray(codebooks)))
               + np.repeat(cents, lmax, axis=0))
        cd = ((xq[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        probes = np.argsort(cd, axis=1)[:, :npb]
        for q in range(nq):
            ok_lists = set(probes[q].tolist())
            dall = ((xq[q][None, :] - dec) ** 2).sum(-1)
            allowed = np.array(
                [(r // lmax) in ok_lists and r % 3 == 0
                 for r in range(nlist * lmax)])
            expect = np.sort(dall[allowed])[:k]
            np.testing.assert_allclose(np.sort(di_all.reshape(nq, k)[q]),
                                       expect, rtol=1e-3, atol=1e-3)
            got_rows = pi_all.reshape(nq, k)[q]
            assert np.all(got_rows % 3 == 0)
            assert all((r // lmax) in ok_lists for r in got_rows)
        print("MULTIHOST OK: sharded IVFPQ + selector mask matches the "
              "local decode oracle across processes")

    # --- sharded graph walk (per-shard CAGRA subgraphs + bf16 packs) ------
    from duckdb_faiss_ext_tpu.ops.graph import build_graph
    from duckdb_faiss_ext_tpu.parallel.sharded import (sharded_graph_search_fn,
                                                       sharded_pack_fn)

    deg = 8
    gblocks, nvalid = [], []
    for s in range(n_dev):
        lo, hi = s * rows_per_dev, min(n, (s + 1) * rows_per_dev)
        adj = (build_graph(xb[lo:hi], deg, "L2") if hi > lo
               else np.empty((0, deg), np.int32))
        pad = np.full((rows_per_dev - adj.shape[0], deg), -1, np.int32)
        gblocks.append(np.concatenate([adj, pad]) if pad.shape[0] else adj)
        nvalid.append(max(0, hi - lo))
    g_global = put(np.concatenate(gblocks), P("shard", None))
    nv_global = put(np.asarray(nvalid, np.int32), P("shard"))
    pack = sharded_pack_fn(mesh, "bf16")(xb_global, g_global)
    wfn = sharded_graph_search_fn(mesh, k=k, pool=64, width=4, iters=4,
                                  metric="L2", pack_kind="bf16")
    dg, pg = wfn(xb_global, g_global, nv_global, xq_global,
                 jnp.float32(0.0), pack)
    dg_all = np.asarray(multihost_utils.process_allgather(dg, tiled=True))
    if pid == 0:
        # pool (64) covers every shard's rows (≤ rows_per_dev·DEV), so the
        # per-shard walks are exhaustive and the merged result must equal
        # the exact oracle (fp32 rerank restores exact distances).
        np.testing.assert_allclose(dg_all.reshape(nq, k),
                                   np.asarray(ref_d), rtol=1e-5, atol=1e-6)
        print("MULTIHOST OK: sharded graph walk (per-shard subgraphs, bf16 "
              "packs) matches the exact oracle across processes")
    return 0


def main() -> int:
    if "DFX_DEMO_PID" in os.environ:
        return worker(int(os.environ["DFX_DEMO_PID"]))
    procs = []
    for pid in range(NPROC):
        env = dict(os.environ, DFX_DEMO_PID=str(pid),
                   PYTHONPATH=REPO + ":" + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, __file__], env=env))
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=300)
    return rc


if __name__ == "__main__":
    sys.exit(main())
