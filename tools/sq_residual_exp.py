"""Measured negative result: residual/OPQ encoding for IVF,SQ* on the
synthetic marco-like corpus (the "try OPQ->SQ4" lead).

faiss's IndexIVFScalarQuantizer defaults by_residual=true, and OPQ
rotation is the classic fix for low-bit SQ on real embeddings.  Neither
helps THIS corpus family (unit-norm clustered gaussian, the stand-in for
MS MARCO ada2 used by every marco tool here):

* rotation: the per-dim variances are already balanced by construction
  (isotropic gaussian mixture, unit-norm) — an orthonormal rotation is a
  distribution no-op by symmetry, so trained per-dim [vmin, vmax] ranges
  are unchanged;
* residual: quantization-conditional recall@10 (exact scoring on the
  SAME probe sets as GT, isolating code error from coverage) measured
  residual encoding WORSE at 4 bits — residuals have relatively wider
  per-dim outlier ranges on unit-norm data:

      SQ4: raw 0.781   residual 0.719
      SQ6: raw 0.942   residual 0.927
      SQ8: raw 0.982   residual 0.982
      (100k x 256, nlist 256, nprobe 16, IP; this script, CPU, seed 42)

So the marco recall/qps Pareto hole is filled by the SQ6 tier (payload
~10 GiB, kernel chip-validated), not by residual/OPQ plumbing.  On real
ada2-like embeddings (strong per-dim spectrum skew) both techniques are
expected to flip sign — revisit if real data ever reaches this
environment.

Usage: python tools/sq_residual_exp.py  (CPU, ~2 min)
"""

from __future__ import annotations

import numpy as np


def main() -> None:
    rng = np.random.default_rng(42)
    n, d, nq, nlist, k, nprobe = 100_000, 256, 128, 256, 10, 16
    nclu = 512
    cen = rng.standard_normal((nclu, d)).astype(np.float32)
    cen /= np.linalg.norm(cen, axis=1, keepdims=True)
    xb = cen[rng.integers(0, nclu, n)] + \
        0.3 * rng.standard_normal((n, d)).astype(np.float32)
    xb /= np.linalg.norm(xb, axis=1, keepdims=True)
    xq = cen[rng.integers(0, nclu, nq)] + \
        0.3 * rng.standard_normal((nq, d)).astype(np.float32)
    xq /= np.linalg.norm(xq, axis=1, keepdims=True)

    c = xb[rng.choice(n, nlist, replace=False)].copy()
    for _ in range(8):
        a = np.argmax(xb @ c.T, axis=1)
        for j in range(nlist):
            m = a == j
            if m.any():
                c[j] = xb[m].mean(0)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
    assign = np.argmax(xb @ c.T, axis=1)

    def sq_dec(x, bits):
        vmin, vmax = x.min(0), x.max(0)
        scale = (vmax - vmin) / (2 ** bits - 1)
        scale[scale == 0] = 1
        code = np.clip(np.round((x - vmin) / scale), 0, 2 ** bits - 1)
        return (vmin + scale * code).astype(np.float32)

    probe = np.argsort(-(xq @ c.T), axis=1)[:, :nprobe]

    def topk(xhat, i, cand):
        s = xq[i] @ xhat[cand].T
        return cand[np.argsort(-s)[:k]]

    for bits in (4, 6, 8):
        dec_raw = sq_dec(xb, bits)
        dec_res = sq_dec(xb - c[assign], bits) + c[assign]
        r_raw = r_res = 0
        for i in range(nq):
            cand = np.flatnonzero(np.isin(assign, probe[i]))
            exact = set(topk(xb, i, cand))
            r_raw += len(set(topk(dec_raw, i, cand)) & exact)
            r_res += len(set(topk(dec_res, i, cand)) & exact)
        print(f"SQ{bits}: quant-conditional recall@10  "
              f"raw {r_raw / (nq * k):.3f}   residual {r_res / (nq * k):.3f}")


if __name__ == "__main__":
    main()
