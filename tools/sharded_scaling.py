"""Sharded-search scaling on a virtual CPU mesh (CPU only).

Measures the *sharded code path's* strong scaling on virtual CPU devices
(it never touches an accelerator; the four-GPU check of the same path is
``chip_smoke.py --four``) with a fair core budget: each shard count S runs
in its own process pinned to S cores (``taskset``) with S virtual XLA host
devices — one core per device, like one card per shard.  The interesting
quantities are

  * wall-clock per batch vs S (strong scaling over a fixed corpus),
  * efficiency  t(1) / (S * t(S)),
  * merge overhead: sharded time vs the same device scanning only its
    N/S-row slice locally (no all_gather / global top-k) — the gap is the
    collective + k-of-kS merge cost.

Caveats: XLA CPU matmul throughput per core says nothing of a GPU's, and S
beyond the host's cores oversubscribes it (reported for completeness, not
efficiency).

Usage:  python tools/sharded_scaling.py [--n 524288] [--d 96] [--b 128]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys, time
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.environ["DFX_REPO"])
from duckdb_faiss_ext_tpu.parallel.sharded import (
    make_mesh, sharded_flat_search_fn, sharded_ivf_search_fn, choose_chunk)
from duckdb_faiss_ext_tpu.ops.flat_search import _flat_search

S = int(sys.argv[1]); N = int(sys.argv[2]); D = int(sys.argv[3])
B = int(sys.argv[4]); K = 10
assert len(jax.devices()) == S

rng = np.random.default_rng(0)
xb = rng.standard_normal((N, D)).astype(np.float32)
xq = rng.standard_normal((B, D)).astype(np.float32)

mesh = make_mesh(S, batch_axis=1)
xb_s = jax.device_put(xb, NamedSharding(mesh, P("shard", None)))
xq_r = jax.device_put(xq, NamedSharding(mesh, P(None, None)))
# NOTE: queries replicated (batch axis 1) — corpus sharding is the axis
# under test.

def best_of(fn, reps=3):
    fn()                                   # warm/compile
    best = float("inf")
    for _ in range(reps):
        t = time.time(); fn(); best = min(best, time.time() - t)
    return best

chunk = choose_chunk(N // S, B, D, "L2")
search = sharded_flat_search_fn(mesh, k=K, metric="L2", chunk=chunk)
t_flat = best_of(lambda: jax.block_until_ready(
    search(xb_s, jnp.int32(N), xq_r, jnp.float32(0.0))))

# local-only scan of one shard's slice (no merge): the ideal per-device time
local = xb[: N // S]
t_local = best_of(lambda: jax.block_until_ready(
    _flat_search(jnp.asarray(local), jnp.int32(N // S), jnp.asarray(xq),
                 None, jnp.float32(0.0), k=K, metric="L2", q_block=min(B, 64),
                 c_block=chunk, precision=jax.lax.Precision.DEFAULT)))

# sharded IVF over the same corpus: nlist lists padded to lmax
nlist, nprobe = 64 * S, 16
perm = rng.permutation(N)
lmax = -(-N // nlist)
lmax = -(-lmax // 8) * 8
pay = np.zeros((nlist, lmax, D), np.float32)
counts = np.zeros((nlist,), np.int32)
row_pos = np.full((nlist, lmax), -1, np.int32)
for li in range(nlist):
    rows = perm[li * (N // nlist):(li + 1) * (N // nlist)]
    pay[li, : len(rows)] = xb[rows]
    row_pos[li, : len(rows)] = rows
    counts[li] = len(rows)
cents = pay[:, 0, :].copy()
ivf = sharded_ivf_search_fn(mesh, k=K, nprobe=nprobe, metric="L2",
                            q_chunk=min(B, 16))
args_ivf = (
    jax.device_put(pay, NamedSharding(mesh, P("shard", None, None))),
    jax.device_put(counts, NamedSharding(mesh, P("shard"))),
    jax.device_put(row_pos, NamedSharding(mesh, P("shard", None))),
    jnp.asarray(cents),
    jax.device_put(xq, NamedSharding(mesh, P(None, None))),
    jnp.float32(0.0))
t_ivf = best_of(lambda: jax.block_until_ready(ivf(*args_ivf)))

print(json.dumps({"S": S, "flat_s": t_flat, "local_s": t_local,
                  "ivf_s": t_ivf}))
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=524288)
    ap.add_argument("--d", type=int, default=96)
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--shards", default="1,2,4,8")
    args = ap.parse_args()

    rows = []
    for s in [int(x) for x in args.shards.split(",")]:
        cores = ",".join(str(c) for c in range(min(s, os.cpu_count())))
        env = dict(os.environ)
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={s}"
        env.pop("PYTHONPATH", None)
        env["DFX_REPO"] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        out = subprocess.run(
            ["taskset", "-c", cores, sys.executable, "-c", CHILD,
             str(s), str(args.n), str(args.d), str(args.b)],
            capture_output=True, text=True, env=env, timeout=1800)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"S={s} child failed")
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"S={s}: {rows[-1]}", flush=True)

    t1 = rows[0]["flat_s"]
    t1_ivf = rows[0]["ivf_s"]
    ncores = os.cpu_count()
    print(f"\ncorpus {args.n}x{args.d} fp32, b{args.b}, k=10, L2, "
          f"{ncores}-core host (1 core/device; S>{ncores} oversubscribed)")
    print("S  flat ms/b  speedup  eff    merge+collective overhead  "
          "ivf ms/b  ivf eff")
    for r in rows:
        s = r["S"]
        spd = t1 / r["flat_s"]
        eff = spd / s
        ovh = (r["flat_s"] - r["local_s"]) / r["flat_s"]
        ivf_eff = t1_ivf / r["ivf_s"] / s
        print(f"{s}  {r['flat_s'] * 1e3:8.1f}  {spd:6.2f}x  {eff:5.2f}  "
              f"{100 * ovh:5.1f}% of batch ({(r['flat_s'] - r['local_s']) * 1e3:6.1f} ms)"
              f"  {r['ivf_s'] * 1e3:8.1f}  {ivf_eff:5.2f}")


if __name__ == "__main__":
    main()
