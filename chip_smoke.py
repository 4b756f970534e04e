"""Drive the engine's main path once on one GPU, at real sizes, and check it.

Runs in one process, needs no network, and makes all data from seeds.  It
prints one line naming the card, then one JSON line per phase (shapes,
wall seconds, tolerance, measured error or recall, and the scan path that
served it), and ends with one JSON line:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases (each compared with a plain reference written here, in numpy or
bare jax.numpy, not with the package):

  flat        1,000,000 x 128 fp32 L2, k=10, batches 48 and 1024, parity
              and fast precision, vs a float64 brute force.
  filter      IDMap,Flat over the same rows, id % 2 == 0, bitmap and
              id-set selectors, vs the float64 brute force over even ids.
  ivf         IVF4096,{Flat,SQ8,PQ16} on the same corpus, nprobe 64,
              recall@10 vs exact, and IVF4096,Flat vs a numpy scan of the
              probed lists.
  device_ivf  unit-norm inner product at d=1536, 1,048,576 rows made on the
              device, faiss_train_device / faiss_add_device into
              IVF4096,{SQ8,SQ6} with and without capped assignment, nprobe
              16, batch 1024, recall@10 vs an exact jnp top-k.
  families    every factory family at 20,000 x 64 (sequential vs batched),
              HNSW32 at 300,000 x 128 on its graph walk, save/load, and
              the reference's error probes.

``--four`` runs only the multi-card phase: faiss_to_device over four cards
for Flat, IVF4096,Flat and IVF4096,SQ8 on the 1M x 128 corpus, each
compared with the same index searched on one card.

Usage:
    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs of one host

It exits non-zero, before printing any result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

N, D, K = 1_000_000, 128, 10
B_SMALL, B_LARGE = 48, 1024
TIE_RTOL = 1e-6
DIST_RTOL = 1e-5
FP32_UNIT = 2.0 ** -24
EXPANSION_ULPS = 8
FAST_RECALL_FLOOR = 0.99
TOLERANCE = {"dist_rtol": DIST_RTOL, "plus_fp32_ulps_of_norms":
             EXPANSION_ULPS, "tie_rtol": TIE_RTOL}
#: recall@10 floors vs exact at nprobe 64 on the clustered 1M x 128 corpus:
#: Flat loses only to unprobed lists; SQ8 adds 8-bit codes; PQ16 stores
#: 16 bytes per 512-byte row, so its floor is the codec's, not the scan's
#: (0.29-0.32 measured on an H100; the scan itself is checked exactly by
#: the probed-list comparison and the CPU tests).
IVF_RECALL_FLOORS = {"IVF4096,Flat": 0.95, "IVF4096,SQ8": 0.90,
                     "IVF4096,PQ16": 0.25}
#: device_ivf: 1536-d unit-norm IP at nprobe 16; SQ6 keeps 6 bits per dim.
DEVICE_RECALL_FLOORS = {"IVF4096,SQ8": 0.80, "IVF4096,SQ6": 0.70}
DEVICE_N, DEVICE_D = 1 << 20, 1536
#: HNSW32 rows: above its 200k ann_threshold, so the graph walk serves it
HNSW_N = 300_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require_gpu():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"no GPU: JAX's default backend is {devs[0].platform}")
        sys.exit(2)
    return devs


def card_line(devs) -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return f"{out[0]} | jax device_kind: {devs[0].device_kind}"


# --------------------------------------------------------------------------
# plain references
# --------------------------------------------------------------------------

def exact_l2(xb: np.ndarray, xq: np.ndarray, k: int, keep=None):
    """float64 brute-force L2: (distances (nq, k+1), ids (nq, k+1)),
    optionally restricted to rows where ``keep`` is True."""
    xb64 = xb.astype(np.float64)
    bn = np.einsum("ij,ij->i", xb64, xb64)
    ds, ids = [], []
    for q0 in range(0, xq.shape[0], 16):
        q = xq[q0:q0 + 16].astype(np.float64)
        d = (np.einsum("ij,ij->i", q, q)[:, None] - 2.0 * (q @ xb64.T)
             + bn[None, :])
        if keep is not None:
            d[:, ~keep] = np.inf
        part = np.argpartition(d, k + 1, axis=1)[:, :k + 1]
        pd = np.take_along_axis(d, part, axis=1)
        o = np.argsort(pd, axis=1, kind="stable")
        ds.append(np.take_along_axis(pd, o, axis=1))
        ids.append(np.take_along_axis(part, o, axis=1))
    return np.concatenate(ds), np.concatenate(ids)


def parity_errors(labels, dists, ref_d, ref_i, k, xb, xq):
    """(id mismatches not explained by reference ties, max relative
    distance error, max error over its allowance).

    A slot may differ only where the reference's distance there ties a
    neighbouring slot (k+1-th included) within TIE_RTOL.  A distance may
    differ by DIST_RTOL relative plus the cancellation of the fp32 form
    ‖q‖² − 2q·x + ‖x‖² that FAISS and this engine both compute:
    EXPANSION_ULPS units of fp32 rounding of ‖q‖² + ‖x‖²."""
    bad = 0
    for q in range(labels.shape[0]):
        r = ref_d[q]
        for j in range(k):
            if labels[q, j] == ref_i[q, j]:
                continue
            lo = j > 0 and abs(r[j] - r[j - 1]) <= TIE_RTOL * abs(r[j])
            hi = abs(r[j + 1] - r[j]) <= TIE_RTOL * abs(r[j])
            if not (lo or hi):
                bad += 1
    ref = ref_d[:, :k]
    err = np.abs(dists - ref)
    qn = np.einsum("ij,ij->i", xq.astype(np.float64), xq.astype(np.float64))
    rows = xb[ref_i[:, :k]].astype(np.float64)
    xn = np.einsum("qkd,qkd->qk", rows, rows)
    allow = (DIST_RTOL * np.abs(ref)
             + EXPANSION_ULPS * FP32_UNIT * (qn[:, None] + xn))
    rel = err / np.maximum(np.abs(ref), 1e-30)
    return bad, float(rel.max()), float((err / allow).max())


def recall(labels, ref_ids, k=K) -> float:
    return float(np.mean([len(set(labels[q, :k]) & set(ref_ids[q, :k])) / k
                          for q in range(labels.shape[0])]))


def timed(fn):
    fn()                                         # compile / warm up
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def scan_path(cat, name):
    idx = cat.get(name).index
    while not hasattr(idx, "_last_scan_path") and hasattr(idx, "inner"):
        idx = idx.inner
    return getattr(idx, "_last_scan_path", None)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_flat(dfx, cat, xb, xq48, xq1024, ref48, ref64):
    dfx.faiss_create("flat", D, "Flat", metric_type="L2", catalog=cat)
    dfx.faiss_add(xb, "flat", catalog=cat)
    for mode in ("parity", "fast"):
        dfx.set_precision(mode)
        for q, ref, nref in ((xq48, ref48, B_SMALL), (xq1024, ref64, 64)):
            res, secs = timed(lambda: dfx.faiss_search("flat", K, q,
                                                       catalog=cat))
            lab, dist = res["label"][:nref], res["distance"][:nref]
            fields = dict(mode=mode, shape=[N, D], batch=q.shape[0], k=K,
                          seconds=secs, scan_path=scan_path(cat, "flat"))
            if mode == "parity":
                bad, rel, over = parity_errors(lab, dist, ref[0], ref[1], K,
                                               xb, q[:nref])
                ok = bad == 0 and over <= 1.0
                emit("flat", **fields, tolerance=TOLERANCE,
                     id_mismatches=bad, max_rel_dist_err=rel,
                     max_err_over_allowance=over, ok=ok)
            else:
                r = recall(lab, ref[1])
                ok = r >= FAST_RECALL_FLOOR
                emit("flat", **fields, tolerance={"recall_floor":
                     FAST_RECALL_FLOOR}, recall=r, ok=ok)
            if not ok:
                raise AssertionError(f"flat {mode} b{q.shape[0]} failed")
    dfx.set_precision("parity")
    dfx.faiss_destroy("flat", catalog=cat)


def phase_filter(dfx, cat, xb, xq48):
    ids = np.arange(N, dtype=np.int64)
    dfx.faiss_create("idf", D, "IDMap,Flat", metric_type="L2", catalog=cat)
    dfx.faiss_add((ids, xb), "idf", catalog=cat)
    dfx.register_table("t", {"id": ids})
    ref_d, ref_i = exact_l2(xb, xq48, K, keep=(ids % 2 == 0))
    for fn in (dfx.faiss_search_filter, dfx.faiss_search_filter_set):
        res, secs = timed(lambda: fn("idf", K, xq48, "id % 2 == 0", "id",
                                     "t", catalog=cat))
        lab, dist = res["label"], res["distance"]
        bad, rel, over = parity_errors(lab, dist, ref_d, ref_i, K, xb, xq48)
        all_even = bool((lab % 2 == 0).all())
        ok = all_even and bad == 0 and over <= 1.0
        emit("filter", selector=fn.__name__, shape=[N, D], batch=B_SMALL,
             k=K, seconds=secs, tolerance=TOLERANCE,
             all_labels_pass=all_even, id_mismatches=bad,
             max_rel_dist_err=rel, max_err_over_allowance=over,
             scan_path=scan_path(cat, "idf"), ok=ok)
        if not ok:
            raise AssertionError(f"filter {fn.__name__} failed")
    dfx.faiss_destroy("idf", catalog=cat)


def probed_list_scan(idx, xq, nprobe, k):
    """numpy float64 scan of exactly the lists an IVF index probes:
    coarse top-nprobe from its centroids, members from its assignment."""
    cents = idx._centroids.astype(np.float64)
    q64 = xq.astype(np.float64)
    cd = ((q64[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    probes = np.argsort(cd, axis=1, kind="stable")[:, :nprobe]
    xb = idx._xb.astype(np.float64)
    out_d, out_i = [], []
    for q in range(xq.shape[0]):
        rows = np.nonzero(np.isin(idx._assign, probes[q]))[0]
        d = ((xb[rows] - q64[q]) ** 2).sum(-1)
        o = np.argsort(d, kind="stable")[:k + 1]
        out_d.append(d[o])
        out_i.append(idx._ids[rows[o]])
    return np.stack(out_d), np.stack(out_i)


def phase_ivf(dfx, cat, xb, xq48, xq1024, ref48, ref64):
    params = {"nprobe": "64"}
    for desc, floor in IVF_RECALL_FLOORS.items():
        t0 = time.perf_counter()
        dfx.faiss_create("ivf", D, desc, metric_type="L2", catalog=cat)
        dfx.faiss_manual_train(xb[:262_144], "ivf", catalog=cat)
        dfx.faiss_add(xb, "ivf", catalog=cat)
        build = time.perf_counter() - t0
        dfx.set_precision("fast")
        for q, ref, nref in ((xq48, ref48, B_SMALL), (xq1024, ref64, 64)):
            res, secs = timed(lambda: dfx.faiss_search("ivf", K, q, params,
                                                       catalog=cat))
            r = recall(res["label"][:nref], ref[1])
            ok = r >= floor
            emit("ivf", index=desc, shape=[N, D], train_rows=262_144,
                 nprobe=64, batch=q.shape[0], k=K, mode="fast",
                 build_seconds=build, seconds=secs,
                 tolerance={"recall_floor": floor}, recall=r,
                 scan_path=scan_path(cat, "ivf"), ok=ok)
            if not ok:
                raise AssertionError(f"{desc} b{q.shape[0]} recall {r}")
        if desc == "IVF4096,Flat":
            dfx.set_precision("parity")
            sub = xq48[:16]
            res = dfx.faiss_search("ivf", K, sub, params, catalog=cat)
            idx = cat.get("ivf").index
            ref_d, ref_i = probed_list_scan(idx, sub, 64, K)
            bad, rel, over = parity_errors(res["label"], res["distance"],
                                           ref_d, ref_i, K, xb, sub)
            ok = bad == 0 and over <= 1.0
            emit("ivf", index=desc, check="probed-lists", batch=16,
                 nprobe=64, mode="parity", tolerance=TOLERANCE,
                 id_mismatches=bad, max_rel_dist_err=rel,
                 max_err_over_allowance=over,
                 scan_path=scan_path(cat, "ivf"), ok=ok)
            if not ok:
                raise AssertionError("IVF4096,Flat probed-list scan differs")
        dfx.set_precision("parity")
        dfx.faiss_destroy("ivf", catalog=cat)


def device_corpus(n, d, nq, seed):
    """Clustered unit-norm rows and queries generated on the device."""
    import jax
    import jax.numpy as jnp

    kc, kx, kq, ka, kb = jax.random.split(jax.random.PRNGKey(seed), 5)
    centers = jax.random.normal(kc, (1024, d), jnp.float32)

    @jax.jit
    def rows(key, assign):
        x = centers[assign] + jax.random.normal(key, (assign.shape[0], d))
        return x / jnp.linalg.norm(x, axis=1, keepdims=True)

    xb = rows(kx, jax.random.randint(ka, (n,), 0, 1024))
    xq = rows(kq, jax.random.randint(kb, (nq,), 0, 1024))
    return xb, xq


def exact_ip_topk(xb, xq, k):
    """Exact inner-product top-k with jnp at HIGHEST, chunked over rows."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def chunk(xc, q, off):
        s = jnp.dot(q, xc.T, precision=lax.Precision.HIGHEST)
        v, i = lax.top_k(s, k)
        return v, i + off

    vs, ids = [], []
    step = 1 << 17
    for off in range(0, xb.shape[0], step):
        v, i = chunk(xb[off:off + step], xq, off)
        vs.append(v)
        ids.append(i)
    v = jnp.concatenate(vs, axis=1)
    i = jnp.concatenate(ids, axis=1)
    top_v, sel = lax.top_k(v, k)
    return np.asarray(jnp.take_along_axis(i, sel, axis=1))


def phase_device_ivf(dfx, cat):
    import jax

    t0 = time.perf_counter()
    xb, xq = device_corpus(DEVICE_N, DEVICE_D, B_LARGE, seed=7)
    jax.block_until_ready(xb)
    gen = time.perf_counter() - t0
    ref = exact_ip_topk(xb, xq, K)
    params = {"nprobe": "16"}
    for desc, floor in DEVICE_RECALL_FLOORS.items():
        for assign_topk in (0, 8):
            t0 = time.perf_counter()
            dfx.faiss_create_params(
                "dev", DEVICE_D, desc, {"assign_topk": str(assign_topk)},
                catalog=cat, metric_type="INNER_PRODUCT")
            dfx.faiss_train_device(xb, "dev", catalog=cat)
            dfx.faiss_add_device(xb, "dev", expected_total=DEVICE_N,
                                 catalog=cat)
            build = time.perf_counter() - t0
            idx = cat.get("dev").index
            dfx.set_precision("fast")
            res, secs = timed(lambda: dfx.faiss_search("dev", K, xq, params,
                                                       catalog=cat))
            r = recall(res["label"], ref)
            ok = r >= floor
            emit("device_ivf", index=desc, shape=[DEVICE_N, DEVICE_D],
                 metric="INNER_PRODUCT", assign_topk=assign_topk,
                 lmax=idx._dr.lmax, spill_rows=int(idx._dr.spill_n),
                 nprobe=16, batch=B_LARGE, k=K, mode="fast",
                 generate_seconds=gen, build_seconds=build, seconds=secs,
                 tolerance={"recall_floor": floor}, recall=r,
                 scan_path=scan_path(cat, "dev"), ok=ok)
            dfx.set_precision("parity")
            dfx.faiss_destroy("dev", catalog=cat)
            if not ok:
                raise AssertionError(f"{desc} assign_topk={assign_topk} "
                                     f"recall {r}")


FAMILIES = ["Flat", "IVF8,Flat", "IVF8,PQ4", "IVF8,SQ8", "PQ4", "SQ8",
            "SQ4", "SQfp16", "LSH", "LSHrt", "PCA8,Flat", "L2norm,SQ8",
            "HNSW16", "PQ4,RFlat", "IDMap,Flat", "IDMap,IVF8,Flat",
            "IDMap2,PQ4", "IVF8(IVF4,Flat)", "SQbf16", "IVF8,SQbf16",
            "RR,Flat", "ITQ,LSH16", "NSG16", "IMI2x2,Flat", "RQ2x4",
            "IVF8,RQ2x4", "IMI2x2,PQ4"]


def phase_families(dfx, cat):
    from duckdb_faiss_ext_tpu import errors
    from duckdb_faiss_ext_tpu.harness.datasets import synthetic_dataset

    n, d = 20_000, 64
    xb, xq = synthetic_dataset(n, d, nq=6, seed=3)
    ids = np.arange(1000, 1000 + n, dtype=np.int64)
    t0 = time.perf_counter()
    for desc in FAMILIES:
        dfx.faiss_create("f", d, desc, metric_type="L2", catalog=cat)
        dfx.faiss_add((ids, xb) if desc.startswith("IDMap") else xb, "f",
                      catalog=cat)
        a = dfx.faiss_search("f", 4, xq, {"nprobe": "8"}, catalog=cat)
        b = dfx.faiss_search_batched("f", 4, xq, {"nprobe": "8"},
                                     batch_size=2, catalog=cat)
        np.testing.assert_array_equal(a["label"], b["label"], err_msg=desc)
        np.testing.assert_allclose(a["distance"], b["distance"], rtol=1e-5,
                                   atol=1e-6, err_msg=desc)
        dfx.faiss_destroy("f", catalog=cat)
    emit("families", shape=[n, d], families=len(FAMILIES),
         seconds=time.perf_counter() - t0,
         tolerance={"batched_vs_sequential": "labels equal, rtol 1e-5"},
         ok=True)

    # HNSW32 above its 200k ann_threshold: the normal graph-walk regime.
    hn = HNSW_N
    hxb, hxq = synthetic_dataset(hn, D, nq=B_SMALL, seed=11)
    t0 = time.perf_counter()
    dfx.faiss_create("hnsw", D, "HNSW32", metric_type="L2", catalog=cat)
    dfx.faiss_add(hxb, "hnsw", catalog=cat)
    hidx = cat.get("hnsw").index
    res, secs = timed(lambda: dfx.faiss_search("hnsw", K, hxq,
                                               {"efSearch": "64"},
                                               catalog=cat))
    build = time.perf_counter() - t0 - 2 * secs
    mode = hidx._effective_mode()
    r = recall(res["label"], exact_l2(hxb, hxq, K)[1])
    ok = mode == "graph" and hidx._graph is not None
    emit("families", index="HNSW32", shape=[hn, D], batch=B_SMALL, k=K,
         efSearch=64, regime=mode, build_seconds=build, seconds=secs,
         recall=r, ok=ok)
    dfx.faiss_destroy("hnsw", catalog=cat)
    if not ok:
        raise AssertionError(f"HNSW32 served by {mode}, not the graph walk")

    # save/load, loaded => immutable, and the reference's error probes.
    dfx.faiss_create("p", d, "SQ8", metric_type="L2", catalog=cat)
    dfx.faiss_add(xb, "p", catalog=cat)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.dfx")
        dfx.faiss_save("p", path, catalog=cat)
        dfx.faiss_load("p2", path, catalog=cat)
    np.testing.assert_array_equal(
        dfx.faiss_search("p", 3, xq, catalog=cat)["label"],
        dfx.faiss_search("p2", 3, xq, catalog=cat)["label"])
    probes = [
        lambda: dfx.faiss_add(xb, "p2", catalog=cat),
        lambda: dfx.faiss_create("p", d, "Flat", catalog=cat),
        lambda: dfx.faiss_search("missing", 3, xq, catalog=cat),
        lambda: dfx.faiss_create("bad", d, "NOPE?", catalog=cat),
    ]
    for probe in probes:
        try:
            probe()
        except errors.InvalidInputError:
            continue
        raise AssertionError("an error probe did not raise")
    dfx.faiss_destroy("p", catalog=cat)
    dfx.faiss_destroy("p2", catalog=cat)
    emit("families", check="save/load + immutable + error probes",
         probes=len(probes), ok=True)


def collectives(fn, *args, **kw) -> list[str]:
    """Collective ops in the compiled program (NCCL on the GPU)."""
    text = fn.lower(*args, **kw).compile().as_text()
    return sorted({op for op in ("all-gather", "all-reduce", "all-to-all",
                                 "collective-permute", "reduce-scatter")
                   if op in text})


def phase_four(dfx, cat, xb, xq48, devs):
    """Each index twice — on one card and over all cards — same queries."""
    import jax
    import jax.numpy as jnp

    from duckdb_faiss_ext_tpu.ops.flat_search import (_flat_search,
                                                      choose_blocks)

    for desc, params, mode in (("Flat", None, "parity"),
                               ("IVF4096,Flat", {"nprobe": "64"}, "parity"),
                               ("IVF4096,SQ8", {"nprobe": "64"}, "parity")):
        dfx.set_precision(mode)
        for name in ("one", "four"):
            dfx.faiss_create(name, D, desc, metric_type="L2", catalog=cat)
            if desc != "Flat":
                dfx.faiss_manual_train(xb[:262_144], name, catalog=cat)
            dfx.faiss_add(xb, name, catalog=cat)
        dfx.faiss_to_device("four", catalog=cat)
        one, t_one = timed(lambda: dfx.faiss_search("one", K, xq48, params,
                                                    catalog=cat))
        four, t_four = timed(lambda: dfx.faiss_search("four", K, xq48,
                                                      params, catalog=cat))
        idx = cat.get("four").index
        if desc == "Flat":
            arr = idx.device_vectors()
            n_dev = len(arr.sharding.device_set)
            qb, cb = choose_blocks(arr.shape[0], 64, D, "L2", K)
            colls = collectives(
                _flat_search, arr, jnp.int32(N), jnp.zeros((64, D)), None,
                jnp.float32(0), k=K, metric="L2", q_block=qb, c_block=cb,
                precision=jax.lax.Precision.HIGHEST)
        else:
            arrays = idx._build_sharded()
            n_dev = len(arrays[0].sharding.device_set)
            fn = next(iter(idx._sharded_fn_cache.values()))
            colls = collectives(fn, *arrays[:4], jnp.zeros((64, D)),
                                jnp.float32(0), *arrays[4:])
        same_ids = bool(np.array_equal(one["label"], four["label"]))
        rel = float(np.max(np.abs(one["distance"] - four["distance"])
                           / np.maximum(np.abs(one["distance"]), 1e-30)))
        ok = (same_ids and n_dev == len(devs) and bool(colls)
              and (desc != "Flat" or rel <= DIST_RTOL))
        emit("four", index=desc, shape=[N, D], batch=B_SMALL, k=K,
             mode=mode, devices=n_dev, collectives=colls,
             seconds_one=t_one, seconds_four=t_four, ids_identical=same_ids,
             max_rel_dist_diff=rel, tolerance={"dist_rtol": DIST_RTOL},
             scan_path=scan_path(cat, "four"), ok=ok)
        dfx.faiss_destroy("one", catalog=cat)
        dfx.faiss_destroy("four", catalog=cat)
        if not ok:
            raise AssertionError(f"four-card {desc} differs from one card")
    dfx.set_precision("parity")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()

    devs = require_gpu()
    if args.four and len(devs) < 4:
        log(f"--four needs four GPUs, JAX sees {len(devs)}")
        return 2
    import duckdb_faiss_ext_tpu as dfx
    from duckdb_faiss_ext_tpu.catalog import Catalog
    from duckdb_faiss_ext_tpu.harness.datasets import synthetic_dataset

    print(card_line(devs), flush=True)
    t_all = time.perf_counter()
    xb, xq_all = synthetic_dataset(N, D, nq=B_SMALL + B_LARGE, seed=42)
    xq48, xq1024 = xq_all[:B_SMALL], xq_all[B_SMALL:]
    if args.four:
        phases = [("four", lambda c: phase_four(dfx, c, xb, xq48, devs))]
    else:
        ref = exact_l2(xb, np.concatenate([xq48, xq1024[:64]]), K)
        ref48 = (ref[0][:B_SMALL], ref[1][:B_SMALL])
        ref64 = (ref[0][B_SMALL:], ref[1][B_SMALL:])
        phases = [
            ("flat", lambda c: phase_flat(dfx, c, xb, xq48, xq1024, ref48,
                                          ref64)),
            ("filter", lambda c: phase_filter(dfx, c, xb, xq48)),
            ("ivf", lambda c: phase_ivf(dfx, c, xb, xq48, xq1024, ref48,
                                        ref64)),
            ("device_ivf", lambda c: phase_device_ivf(dfx, c)),
            ("families", lambda c: phase_families(dfx, c)),
        ]
    # Every phase runs, each on a fresh catalog, so one run reports them
    # all; any failure fails the run and suppresses the result line.
    failed = []
    for name, run in phases:
        try:
            run(Catalog())
        except Exception:                       # noqa: BLE001 — re-raised
            traceback.print_exc()               # as the exit code below
            failed.append(name)
        dfx.set_precision("parity")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
