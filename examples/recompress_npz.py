"""Rank-cap a prepared DF factor cache by aux-space eigendecomposition.

The second-stage pivoted Cholesky (ops/cholesky.recompress_factors) is
a per-column GEMV loop — O(naux) passes over the 13 GB factor matrix,
~4 h on this single-core host at w14 size.  This script instead
eigendecomposes the aux-space Gram matrix G = M M^T (naux x naux — 235
MB at naux=5414, one GEMM + one LAPACK eig) and projects onto the top
max_naux eigenvectors: the OPTIMAL rank-k approximation of the ERI
supermatrix in the Frobenius norm, ~40 min at w14 size.

Why cap at all: at (56,504) naux=5414 the f32 factor blocks alone are
6.2 GB, which leaves a 16 GB device no room for t2 + r2 and any
formulation of the residual.  naux=4200 restores ~1 GB of
program headroom; the discarded eigenvalue tail is reported so the
capture can quote the factorization error honestly.

Usage: python examples/recompress_npz.py in.npz out.npz [max_naux]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from any cwd

import numpy as np


def main():
    src, dst = sys.argv[1], sys.argv[2]
    max_naux = int(sys.argv[3]) if len(sys.argv) > 3 else 4200
    z = dict(np.load(src))
    B = z["B"]
    naux, n, _ = B.shape
    M = B.reshape(naux, n * n)
    t0 = time.time()
    # Gram in f64 (accumulation accuracy) from the f32/f64 factors
    G = (M @ M.T).astype(np.float64)
    t_g = time.time() - t0
    print("gram (%d x %d): %.1f s" % (naux, naux, t_g), flush=True)
    t0 = time.time()
    w, U = np.linalg.eigh(G)
    t_e = time.time() - t0
    w = np.maximum(w, 0.0)
    order = np.argsort(w)[::-1]
    keep = order[:max_naux]
    tail = float(w[order[max_naux:]].sum()) if max_naux < naux else 0.0
    total = float(w.sum())
    print("eig: %.1f s; kept %d of %d; discarded eigenvalue mass "
          "%.3e of %.3e (frob^2 of the ERI supermatrix)"
          % (t_e, len(keep), naux, tail, total), flush=True)
    t0 = time.time()
    # B2 = U_k^T M  — rows are orthogonal combinations; sum_P B2 B2
    # equals the rank-k best approximation of sum_P B B
    B2 = (U[:, keep].T.astype(M.dtype) @ M).reshape(len(keep), n, n)
    print("projection: %.1f s" % (time.time() - t0), flush=True)
    z["B"] = B2
    np.savez(dst + ".tmp.npz", **z)
    import os
    os.replace(dst + ".tmp.npz", dst)
    print("saved %s: naux %d -> %d" % (dst, naux, len(keep)), flush=True)


if __name__ == "__main__":
    main()
