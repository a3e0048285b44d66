"""Pivoted-Cholesky factorization of the two-electron integrals.

The ERI supermatrix in chemists' ordering, V[(pr),(qs)] = (pr|qs), is
symmetric positive semidefinite, so a pivoted Cholesky decomposition
truncated at `tol` yields three-index factors

    (pr|qs) ~= sum_P  B[P, p, r] * B[P, q, s],        naux = O(few * nact)

i.e. in the repo's Dirac convention  ERI[p,q,r,s] = (pr|qs) ~=
einsum('Ppr,Pqs->pqrs', B, B).  This is the memory architecture that breaks
the nact^4 wall the reference hits at /root/reference/pycc/hamiltonian.py:36-39
(dense `mo_eri`): the CC solver works from B (naux * nact^2) and assembles
any four-index quantity it needs on the fly as matmuls
(models/dfccsd.py).

Two factorization routes exist:

* `cholesky_factor_eri` — greedy pivoted Cholesky of a DENSE MO ERI on the
  host.  It needs the nact^4 tensor as input, so it breaks the device-HBM
  wall only; host memory still bounds it.  Used by ccwfn(storage='df') when
  a dense Hamiltonian is already in hand (small/medium systems).
* `pycc_tpu.scf.df.cholesky_factor_ao` — INTEGRAL-DIRECT pivoted Cholesky
  in the AO basis (shell-pair column batches from the native MD engine; no
  four-index tensor anywhere), followed by `recompress_factors` below to
  shrink the AO-sized naux to active-space rank.  This is the at-scale
  route (ccwfn(storage='df', df_direct=True)).
"""

import numpy as np


def cholesky_factor_eri(ERI, tol=1e-8, max_naux=None):
    """Factor a Dirac-convention MO ERI: returns B (naux, n, n) with
    ERI[p,q,r,s] ~= einsum('Ppr,Pqs->pqrs', B, B) to accuracy `tol`
    (max abs error on the diagonal of the residual supermatrix).

    B rows are symmetric in (p, r) since (pr|qs) = (rp|qs) for real
    orbitals.
    """
    ERI = np.asarray(ERI, dtype=np.float64)
    n = ERI.shape[0]
    # chemist supermatrix rows/cols are the (p,r) / (q,s) pairs
    V = ERI.transpose(0, 2, 1, 3).reshape(n * n, n * n)
    B = _pivoted_cholesky(V, tol=tol, max_rank=max_naux)
    return B.reshape(-1, n, n)


def _pivoted_cholesky(V, tol, max_rank=None):
    """Greedy pivoted Cholesky of a dense symmetric PSD matrix.

    Returns L (rank, n) with V ~= L.T @ L and
    max|diag(V - L.T L)| <= tol.  O(n^2 * rank) using full columns of V.
    """
    n = V.shape[0]
    if max_rank is None:
        max_rank = n
    d = np.ascontiguousarray(np.diag(V).copy())
    rows = []
    order = []
    for _ in range(max_rank):
        p = int(np.argmax(d))
        if d[p] <= tol:
            break
        col = V[:, p].astype(np.float64, copy=True)
        for (q, row) in zip(order, rows):
            col -= row[p] * row
        piv = np.sqrt(d[p])
        row = col / piv
        # exact zeros on already-eliminated pivots keep d non-negative
        row[order] = 0.0
        row[p] = piv
        rows.append(row)
        order.append(p)
        d -= row * row
        d[p] = 0.0
        np.maximum(d, 0.0, out=d)
    if not rows:
        return np.zeros((0, n))
    return np.array(rows)


def recompress_factors(B, tol=1e-8, max_naux=None):
    """Second-stage pivoted Cholesky of V = M^T M with M = B.reshape(naux,
    n^2), WITHOUT forming the n^2 x n^2 supermatrix: each factor row is a
    single (naux x n^2) GEMV.  Shrinks AO-derived factors (naux ~ few*nao)
    to the rank the *active MO space* actually needs (naux ~ few*nact) —
    the per-iteration cost of every DF-CC contraction is linear in naux,
    so this directly buys back iteration time.

    Returns B2 (naux2, n, n) with sum_P B2[P,pq] B2[P,rs] equal to
    sum_P B[P,pq] B[P,rs] to `tol` on the residual diagonal.
    """
    naux, n, _ = B.shape
    M = np.ascontiguousarray(B.reshape(naux, n * n))
    d = np.einsum("Pq,Pq->q", M, M)
    if max_naux is None:
        max_naux = naux
    rows = np.empty((min(max_naux, naux), n * n))
    order = []
    k = 0
    while k < max_naux:
        q = int(d.argmax())
        if d[q] <= tol:
            break
        col = M.T @ M[:, q]
        if k:
            col -= rows[:k].T @ rows[:k, q]
        piv = np.sqrt(d[q])
        row = col / piv
        row[order] = 0.0
        row[q] = piv
        if k == rows.shape[0]:
            rows = np.concatenate([rows, np.empty((n, n * n))])
        rows[k] = row
        k += 1
        order.append(q)
        d -= row * row
        d[q] = 0.0
        np.maximum(d, 0.0, out=d)
    return rows[:k].reshape(k, n, n)
