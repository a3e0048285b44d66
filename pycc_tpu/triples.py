"""Connected-triples drivers: (T) corrections and T3 blocks for CC3.

Re-design of /root/reference/pycc/cctriples.py: the reference
loops Python triples (i,j,k) (or (a,b,c)) building one v^3 (or o^3) block
per iteration; here the T3 tensor is produced by batched einsums
(dot_general graphs) — full-tensor for small systems, occupied-batched
lax.scan for large ones — so the contractions are large matmuls.

Three (T) algorithms are kept (occupied-driven, virtual-driven, and the
Lee/Rendell restricted-triple form) as mutually-agreeing oracles, mirroring
the reference test strategy (test_005_ccsd_t_energy.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
from .ops.contract import contract


def _slices(no):
    return slice(0, no), slice(no, None)


def t3_denom(F, no):
    """D[ijkabc] = f_ii + f_jj + f_kk - f_aa - f_bb - f_cc."""
    o, v = _slices(no)
    eps = jnp.diagonal(F)
    Fo, Fv = eps[o], eps[v]
    return (Fo[:, None, None, None, None, None]
            + Fo[None, :, None, None, None, None]
            + Fo[None, None, :, None, None, None]
            - Fv[None, None, None, :, None, None]
            - Fv[None, None, None, None, :, None]
            - Fv[None, None, None, None, None, :])


def t3c_full(Wvvvo, Wovoo, t2, F=None, no=None, with_denom=True):
    """Connected T3 over all (i,j,k,a,b,c) at once.

    Equivalent to the per-triple generator t3c_ijk of the reference
    (cctriples.py:8-35) evaluated on the whole index space.
    """
    t3 = contract("baei,kjce->ijkabc", Wvvvo, t2)
    t3 += contract("caei,jkbe->ijkabc", Wvvvo, t2)
    t3 += contract("acek,jibe->ijkabc", Wvvvo, t2)
    t3 += contract("bcek,ijae->ijkabc", Wvvvo, t2)
    t3 += contract("cbej,ikae->ijkabc", Wvvvo, t2)
    t3 += contract("abej,kice->ijkabc", Wvvvo, t2)
    t3 -= contract("mcjk,imab->ijkabc", Wovoo, t2)
    t3 -= contract("mbkj,imac->ijkabc", Wovoo, t2)
    t3 -= contract("mbij,kmca->ijkabc", Wovoo, t2)
    t3 -= contract("maji,kmcb->ijkabc", Wovoo, t2)
    t3 -= contract("maki,jmbc->ijkabc", Wovoo, t2)
    t3 -= contract("mcik,jmba->ijkabc", Wovoo, t2)
    if with_denom:
        t3 = t3 / t3_denom(F, no)
    return t3


def t3d_full(t1, t2, Woovv, F, no, with_denom=True):
    """Disconnected T3 (cctriples.py:68-83) over the full index space."""
    o, v = _slices(no)
    Fov = F[o, v]
    t3 = contract("ijab,kc->ijkabc", Woovv, t1)
    t3 += contract("ikac,jb->ijkabc", Woovv, t1)
    t3 += contract("jkbc,ia->ijkabc", Woovv, t1)
    t3 += contract("ijab,kc->ijkabc", t2, Fov)
    t3 += contract("ikac,jb->ijkabc", t2, Fov)
    t3 += contract("jkbc,ia->ijkabc", t2, Fov)
    if with_denom:
        t3 = t3 / t3_denom(F, no)
    return t3


def _swap_ac(t3):
    return (t3).swapaxes(3, 5)


def _swap_bc(t3):
    return (t3).swapaxes(4, 5)


def _vikings_X(F, ERI, L, t2, t3, no):
    """X1/X2 contractions shared by the occupied- and virtual-driven (T)."""
    o, v = _slices(no)
    td = t3 - _swap_ac(t3)
    T = 2.0 * t3 - _swap_bc(t3) - _swap_ac(t3)
    X1 = contract("ijkabc,jkbc->ia", td, L[o, o, v, v])
    X2 = contract("ijkabc,kc->ijab", td, F[o, v])
    X2 += contract("ijkabc,dkbc->ijad", T, ERI[v, o, v, v])
    X2 -= contract("ijkabc,jklc->ilab", T, ERI[o, o, o, v])
    return X1, X2


def t_vikings(cc):
    """Occupied-driven (T) energy (cctriples.py:156-186), fully batched."""
    no = cc.no
    # jnp conversion up front: under storage='blocked' the dense
    # Hamiltonian tensors live host-side as numpy arrays
    F, ERI, L = (jnp.asarray(cc.H.F), jnp.asarray(cc.H.ERI),
                 jnp.asarray(cc.H.L))
    t1, t2 = cc.t1, cc.t2

    @jax.jit
    def compute(F, ERI, L, t1, t2):
        o, v = _slices(no)
        t3 = t3c_full(ERI[v, v, v, o], ERI[o, v, o, o], t2, F, no)
        X1, X2 = _vikings_X(F, ERI, L, t2, t3, no)
        ET = 2.0 * contract("ia,ia->", t1, X1)
        ET += contract("ijab,ijab->", 4.0 * t2 - 2.0 * t2.swapaxes(2, 3), X2)
        return ET

    return compute(F, ERI, L, t1, t2)


def t_vikings_inverted(cc):
    """Virtual-driven (T) (cctriples.py:190-217): same X tensors accumulated
    in a lax.scan over the virtual index — a genuinely different reduction
    order, used as a numerical cross-check."""
    no = cc.no
    # jnp conversion up front: under storage='blocked' the dense
    # Hamiltonian tensors live host-side as numpy arrays
    F, ERI, L = (jnp.asarray(cc.H.F), jnp.asarray(cc.H.ERI),
                 jnp.asarray(cc.H.L))
    t1, t2 = cc.t1, cc.t2

    @jax.jit
    def compute(F, ERI, L, t1, t2):
        o, v = _slices(no)
        t3 = t3c_full(ERI[v, v, v, o], ERI[o, v, o, o], t2, F, no)
        td = t3 - _swap_ac(t3)
        T = 2.0 * t3 - _swap_bc(t3) - _swap_ac(t3)
        t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)

        def eslab(a):
            # energy contribution of one virtual slab (fixed first virtual
            # index of T3/X2) — a different reduction order than t_vikings
            X1a = contract("ijkbc,jkbc->i", td[:, :, :, a], L[o, o, v, v])
            X2a = contract("ijkbc,kc->ijb", td[:, :, :, a], F[o, v])
            X2a += contract("ijkbc,dkbc->ijd", T[:, :, :, a], ERI[v, o, v, v])
            X2a -= contract("ijkbc,jklc->ilb", T[:, :, :, a], ERI[o, o, o, v])
            e = 2.0 * contract("i,i->", t1[:, a], X1a)
            e += contract("ijb,ijb->", t2w[:, :, a], X2a)
            return e

        es = jax.vmap(eslab)(jnp.arange(t3.shape[3]))
        return jnp.sum(es)

    return compute(F, ERI, L, t1, t2)


def t_tjl(cc):
    """Lee/Rendell restricted-triples (T) (cctriples.py:106-152), with the
    per-triple a,b,c loops replaced by masked whole-block arithmetic and the
    (i>=j>=k) loop by a vmap over the packed triangle."""
    no, nv = cc.no, cc.nv
    F, ERI = jnp.asarray(cc.H.F), jnp.asarray(cc.H.ERI)
    t1, t2 = cc.t1, cc.t2
    o, v = _slices(no)

    import numpy as np
    tri = np.array([(i, j, k) for i in range(no) for j in range(i + 1)
                    for k in range(j + 1)], dtype=np.int32)
    ii, jj, kk = jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]), jnp.asarray(tri[:, 2])

    a_ = jnp.arange(nv)
    dab = (a_[:, None, None] == a_[None, :, None]).astype(F.dtype)
    dac = (a_[:, None, None] == a_[None, None, :]).astype(F.dtype)
    dbc = (a_[None, :, None] == a_[None, None, :]).astype(F.dtype)
    Vdeg = 1.0 + dab + dac + dbc
    tri_abc = ((a_[:, None, None] >= a_[None, :, None])
               & (a_[None, :, None] >= a_[None, None, :]))

    Wvvvo = ERI[v, v, v, o]
    Wovoo = ERI[o, v, o, o]
    Woovv = ERI[o, o, v, v]
    Fov = F[o, v]
    eps = jnp.diagonal(F)
    Fv = eps[no:]

    @jax.jit
    def triple_energy(i, j, k):
        W3 = contract("bae,ce->abc", Wvvvo[:, :, :, i], t2[k, j])
        W3 += contract("cae,be->abc", Wvvvo[:, :, :, i], t2[j, k])
        W3 += contract("ace,be->abc", Wvvvo[:, :, :, k], t2[j, i])
        W3 += contract("bce,ae->abc", Wvvvo[:, :, :, k], t2[i, j])
        W3 += contract("cbe,ae->abc", Wvvvo[:, :, :, j], t2[i, k])
        W3 += contract("abe,ce->abc", Wvvvo[:, :, :, j], t2[k, i])
        W3 -= contract("mc,mab->abc", Wovoo[:, :, j, k], t2[i])
        W3 -= contract("mb,mac->abc", Wovoo[:, :, k, j], t2[i])
        W3 -= contract("mb,mca->abc", Wovoo[:, :, i, j], t2[k])
        W3 -= contract("ma,mcb->abc", Wovoo[:, :, j, i], t2[k])
        W3 -= contract("ma,mbc->abc", Wovoo[:, :, k, i], t2[j])
        W3 -= contract("mc,mba->abc", Wovoo[:, :, i, k], t2[j])

        V3 = W3
        V3 += contract("ab,c->abc", Woovv[i, j], t1[k])
        V3 += contract("ac,b->abc", Woovv[i, k], t1[j])
        V3 += contract("bc,a->abc", Woovv[j, k], t1[i])
        V3 += contract("ab,c->abc", t2[i, j], Fov[k])
        V3 += contract("ac,b->abc", t2[i, k], Fov[j])
        V3 += contract("bc,a->abc", t2[j, k], Fov[i])
        V3 = V3 / Vdeg

        def P(x, perm):
            return (x).transpose(*perm)

        X3 = (W3 * V3
              + P(W3, (0, 2, 1)) * P(V3, (0, 2, 1))
              + P(W3, (1, 0, 2)) * P(V3, (1, 0, 2))
              + P(W3, (1, 2, 0)) * P(V3, (1, 2, 0))
              + P(W3, (2, 0, 1)) * P(V3, (2, 0, 1))
              + P(W3, (2, 1, 0)) * P(V3, (2, 1, 0)))
        Y3 = V3 + P(V3, (1, 2, 0)) + P(V3, (2, 0, 1))
        Z3 = P(V3, (0, 2, 1)) + P(V3, (1, 0, 2)) + P(V3, (2, 1, 0))

        denom = (eps[i] + eps[j] + eps[k]
                 - Fv[:, None, None] - Fv[None, :, None] - Fv[None, None, :])
        w = 2.0 - ((i == j).astype(F.dtype) + (i == k).astype(F.dtype)
                   + (j == k).astype(F.dtype))
        term = ((Y3 - 2.0 * Z3) * (W3 + P(W3, (1, 2, 0)) + P(W3, (2, 0, 1)))
                + (Z3 - 2.0 * Y3) * (P(W3, (0, 2, 1)) + P(W3, (1, 0, 2))
                                     + P(W3, (2, 1, 0)))
                + 3.0 * X3)
        return jnp.sum(jnp.where(tri_abc, term / denom, 0.0)) * w

    es = jax.vmap(triple_energy)(ii, jj, kk)
    return jnp.sum(es)


# ---------------------------------------------------------------------------
# (T) contributions to Lambda residuals and one-/two-electron densities
# (ccwfn.t3_density, /root/reference/pycc/ccwfn.py:721-855, batched)
# ---------------------------------------------------------------------------

def _perm_v(t3, order):
    """Permute the three virtual axes (3,4,5) of the full T3 tensor."""
    axes = (0, 1, 2) + tuple(3 + "abc".index(c) for c in order)
    return (t3).transpose(*axes)


def _perm_o(t3, order):
    """Permute the three occupied axes (0,1,2)."""
    axes = tuple("ijk".index(c) for c in order) + (3, 4, 5)
    return (t3).transpose(*axes)


def _X3_v(M):
    return (8.0 * M - 4.0 * _perm_v(M, "bac") - 4.0 * _perm_v(M, "acb")
            - 4.0 * _perm_v(M, "cba") + 2.0 * _perm_v(M, "cab")
            + 2.0 * _perm_v(M, "bca"))


def _X3_o(M):
    return (8.0 * M - 4.0 * _perm_o(M, "jik") - 4.0 * _perm_o(M, "ikj")
            - 4.0 * _perm_o(M, "kji") + 2.0 * _perm_o(M, "kij")
            + 2.0 * _perm_o(M, "jki"))


def t3_density(cc):
    """(T) corrections: Lambda sources S1/S2, 1-pdm blocks Doo/Dvv/Dov,
    2-pdm blocks Goovv/Gooov/Gvvvo; returns the (T) energy.  Results are
    cached on the ccwfn object for ccdensity/cclambda."""
    no = cc.no
    # jnp conversion up front: under storage='blocked' the dense
    # Hamiltonian tensors live host-side as numpy arrays
    F, ERI, L = (jnp.asarray(cc.H.F), jnp.asarray(cc.H.ERI),
                 jnp.asarray(cc.H.L))
    t1, t2 = cc.t1, cc.t2

    @jax.jit
    def compute(F, ERI, L, t1, t2):
        o, v = _slices(no)
        M = t3c_full(ERI[v, v, v, o], ERI[o, v, o, o], t2, F, no)
        N = t3d_full(t1, t2, ERI[o, o, v, v], F, no)
        X3 = _X3_v(M)
        Y3 = _X3_v(N)
        W = 2.0 * X3 + Y3
        Md_ac = M - _swap_ac(M)
        T = 2.0 * M - _swap_bc(M) - _swap_ac(M)

        X2 = contract("ijkabc,kc->ijab", Md_ac, F[o, v])
        X2 += contract("ijkabc,dkbc->ijad", T, ERI[v, o, v, v])
        X2 -= contract("ijkabc,jklc->ilab", T, ERI[o, o, o, v])

        Dvv = 0.5 * contract("ijkacd,ijkbcd->ab", M, X3 + Y3)
        Dov = contract("ijkabc,jkbc->ia", Md_ac,
                       4.0 * t2 - 2.0 * t2.swapaxes(2, 3))
        Z3 = (2.0 * M - 2.0 * _swap_bc(M) - _perm_v(M, "bac")
              + _perm_v(M, "bca"))
        Goovv = 4.0 * contract("ijkabc,kc->ijab", Z3, t1)
        Gooov = -contract("ijkabc,lkbc->jila", W, t2)
        Gvvvo = contract("ijkabc,kicd->abdj", W, t2)

        S1 = 2.0 * contract("ijkabc,jkbc->ia", M - _perm_v(M, "bac"),
                            L[o, o, v, v])
        S2 = -contract("ijkabc,jklc->ilab", W, ERI[o, o, o, v])
        S2 += contract("ijkabc,kdcb->ijad", W, ERI[o, v, v, v])
        S2 = S2 + S2.transpose(1, 0, 3, 2)

        X3o = _X3_o(M)
        Y3o = _X3_o(N)
        Doo = -0.5 * contract("iklabc,jklabc->ij", M, X3o + Y3o)

        ET = contract("ia,ia->", t1, S1)
        ET += contract("ijab,ijab->", 4.0 * t2 - 2.0 * t2.swapaxes(2, 3), X2)
        return ET, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2

    ET, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2 = compute(F, ERI, L, t1, t2)
    cc.Doo_t3, cc.Dvv_t3, cc.Dov_t3 = Doo, Dvv, Dov
    cc.Goovv, cc.Gooov, cc.Gvvvo = Goovv, Gooov, Gvvvo
    cc.S1, cc.S2 = S1, S2
    return ET


def t3_density_energy(cc):
    # full T3 is no^3 nv^3; beyond ~2e8 elements switch to the per-(i,j)
    # slab scan (same threshold as the CC3 dispatch in ccwfn).  The ccwfn
    # kwarg t3_scan=True/False overrides the automatic choice.
    scan = getattr(cc, "t3_scan", None)
    if scan is None:
        scan = cc.no ** 3 * cc.nv ** 3 > 2e8
    if getattr(cc, "storage", "full") == "df":
        scan = True  # no dense ERI exists; the scan assembles from factors
    return t3_density_scan(cc) if scan else t3_density(cc)


def t3_lambda_sources(cc):
    """S1/S2 Lambda-residual sources for CCSD(T) (computes and caches the
    full (T) density set)."""
    if not hasattr(cc, "S1"):
        t3_density_energy(cc)
    return cc.S1, cc.S2


# ---------------------------------------------------------------------------
# Memory-scalable (T): per-(i,j) T3 slabs (lax.fori_loop)
# ---------------------------------------------------------------------------

def slab_layouts(Wvvvo, Wovoo):
    """Occupied-major layouts for the slab builders: (i,b,a,e) and (j,k,m,c).

    Dynamic-slicing the trailing axis of (v,v,v,o)/(o,v,o,o) tensors
    inside a fori_loop is a strided gather; one up-front transpose makes
    every per-(i,j) access a contiguous major-axis slice."""
    return (Wvvvo).transpose(3, 0, 1, 2), (Wovoo).transpose(2, 3, 0, 1)


def _t3c_slab(i, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i] slab (j,k,a,b,c) for a fixed first occupied index.

    Takes the occupied-major layouts from `slab_layouts`."""
    Wi = Wvvvo_o[i]
    t2i = t2[i]
    t2_i2 = t2[:, i]
    t3 = contract("bae,kjce->jkabc", Wi, t2)
    t3 += contract("cae,jkbe->jkabc", Wi, t2)
    t3 += contract("kace,jbe->jkabc", Wvvvo_o, t2_i2)
    t3 += contract("kbce,jae->jkabc", Wvvvo_o, t2i)
    t3 += contract("jcbe,kae->jkabc", Wvvvo_o, t2i)
    t3 += contract("jabe,kce->jkabc", Wvvvo_o, t2_i2)
    t3 -= contract("jkmc,mab->jkabc", Wovoo_t, t2i)
    t3 -= contract("kjmb,mac->jkabc", Wovoo_t, t2i)
    t3 -= contract("jmb,kmca->jkabc", Wovoo_t[i], t2)
    t3 -= contract("jma,kmcb->jkabc", Wovoo_t[:, i], t2)
    t3 -= contract("kma,jmbc->jkabc", Wovoo_t[:, i], t2)
    t3 -= contract("kmc,jmba->jkabc", Wovoo_t[i], t2)
    denom = (eps_o[i] + eps_o[:, None, None, None, None]
             + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None]
             - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    # barrier: materialize the slab once.  Without it XLA REMATERIALIZES
    # the whole assembly into every downstream consumer (each permuted
    # read re-runs the twelve dots) — the (T) scan ran 5.6x slower and
    # the j-chunked row compile-OOM'd at 44.9 GB.
    return jax.lax.optimization_barrier(t3 / denom)


def _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i, j] slab (k,a,b,c) for fixed first two occupied indices.

    Working set O(no v^3) — the production tiling for large systems.
    Takes the occupied-major layouts from `slab_layouts`."""
    Wi = Wvvvo_o[i]
    Wj = Wvvvo_o[j]
    t3 = contract("bae,kce->kabc", Wi, t2[:, j])
    t3 += contract("cae,kbe->kabc", Wi, t2[j])
    t3 += contract("kace,be->kabc", Wvvvo_o, t2[j, i])
    t3 += contract("kbce,ae->kabc", Wvvvo_o, t2[i, j])
    t3 += contract("cbe,kae->kabc", Wj, t2[i])
    t3 += contract("abe,kce->kabc", Wj, t2[:, i])
    t3 -= contract("kmc,mab->kabc", Wovoo_t[j], t2[i])
    t3 -= contract("kmb,mac->kabc", Wovoo_t[:, j], t2[i])
    t3 -= contract("mb,kmca->kabc", Wovoo_t[i, j], t2)
    t3 -= contract("ma,kmcb->kabc", Wovoo_t[j, i], t2)
    t3 -= contract("kma,mbc->kabc", Wovoo_t[:, i], t2[j])
    t3 -= contract("kmc,mba->kabc", Wovoo_t[i], t2[j])
    denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return jax.lax.optimization_barrier(t3 / denom)  # see _t3c_slab


@partial(jax.jit, static_argnames="no")
def t_scan_df_slices(F, Boo, Bov, Bvv, no):
    """The five integral slices (plus Fov, diag F) the (T) slab scan
    consumes, assembled from Cholesky/DF factors — module-level so the
    multichip dryrun can trace the full factor-fed (T) program for HLO
    collective accounting."""
    o, v = _slices(no)
    Wvvvo_o = contract("Pac,Pib->iabc", Bvv, Bov)
    Wovoo_t = contract("Pij,Pka->jkia", Boo, Bov)
    Evovv = contract("Pab,Pic->aibc", Bvv, Bov)
    Eooov = contract("Pik,Pja->ijka", Boo, Bov)
    Eoovv = contract("Pia,Pjb->ijab", Bov, Bov)
    Loovv = 2.0 * Eoovv - Eoovv.swapaxes(2, 3)
    return (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, F[o, v],
            jnp.diagonal(F))


def t_vikings_scan(cc, slab_dtype=None, jc=None):
    """Occupied-driven (T) with O(no v^3) working memory: one T3 slab per
    (i,j) pair, evaluated sequentially with lax.fori_loop.  Exact same
    energy as t_vikings.  The jitted graph consumes only the integral
    slices it needs (not the full nact^4 ERI/L), keeping HBM pressure to
    the slices + one slab.  slab_dtype/jc: see t_vikings_scan_core (the
    bandwidth-roofline knobs; the k-chunked at-scale DF path ignores
    them)."""
    no = cc.no
    t1, t2 = cc.t1, cc.t2
    o, v = _slices(no)

    if getattr(cc, "storage", "full") == "df":
        # (T) from Cholesky/DF factors: assemble exactly the five integral
        # slices the slab scan consumes — nothing nact^4 is ever formed,
        # so CCSD(T) runs at sizes whose dense ERI cannot exist (the
        # reference's (T) needs the full MO ERI,
        # /root/reference/pycc/cctriples.py:106-152 via hamiltonian.py:36).
        # Dirac <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s].  The largest
        # assembled stacks are the two no*nv^3 slabs (~1.8 GB f32 each at
        # (28,252)); the HBM wall moves from nact^4 to no*nv^3.  Past
        # ~1 GB of no*nv^3 the single-resident k-chunked path takes over.
        # 2^27 elements (512 MB f32): above this the row path's ~6-8
        # simultaneous no*v^3 slab temps (plus their layout copies)
        # compile-OOM — uracil/aug-cc-pVDZ (21,191) measured 27.7 GB
        if no * (t2.shape[-1] ** 3) > 2 ** 27:
            return t_vikings_scan_df_chunked(cc.dfb, cc.H.F, t1, t2, no)

        (Wvvvo, Wovoo, Evovv, Eooov,
         Loovv, Fov, eps) = t_scan_df_slices(jnp.asarray(cc.H.F),
                                             cc.dfb.Boo, cc.dfb.Bov,
                                             cc.dfb.Bvv, no=no)
    elif getattr(cc, "storage", "full") == "blocked":
        # source every slice from the six Dirac blocks: nothing nact^4
        # ever reaches the device
        from .models.blocked import blocked_views

        @jax.jit
        def prep_b(F, blocks):
            ERI, L = blocked_views(blocks, no)
            Wvvvo_o, Wovoo_t = slab_layouts(ERI[v, v, v, o],
                                            ERI[o, v, o, o])
            return (Wvvvo_o, Wovoo_t, ERI[v, o, v, v], ERI[o, o, o, v],
                    L[o, o, v, v], F[o, v], jnp.diagonal(F))

        (Wvvvo, Wovoo, Evovv, Eooov,
         Loovv, Fov, eps) = prep_b(jnp.asarray(cc.H.F), cc.blocks)
    else:
        @jax.jit
        def prep(F, ERI, L):
            Wvvvo_o, Wovoo_t = slab_layouts(ERI[v, v, v, o],
                                            ERI[o, v, o, o])
            return (Wvvvo_o, Wovoo_t, ERI[v, o, v, v],
                    ERI[o, o, o, v], L[o, o, v, v], F[o, v],
                    jnp.diagonal(F))

        (Wvvvo, Wovoo, Evovv, Eooov,
         Loovv, Fov, eps) = prep(cc.H.F, cc.H.ERI, cc.H.L)
    return t_vikings_scan_core(Wvvvo, Wovoo, Evovv, Eooov, Loovv, Fov, eps,
                               t1, t2, no, slab_dtype=slab_dtype, jc=jc)


def _slab_pair_energy(t3, i, j, Evovv, Eooov, Loovv, Fov, t1, t2w):
    """(T) energy contribution of one external pair (i, j) from its
    (k,a,b,c) connected-T3 slab."""
    td = t3 - (t3).swapaxes(1, 3)
    T = 2.0 * t3 - (t3).swapaxes(2, 3) - (t3).swapaxes(1, 3)
    X1 = contract("kabc,kbc->a", td, Loovv[j])
    X2 = contract("kabc,kc->ab", td, Fov)
    X2 += contract("kabc,dkbc->ad", T, Evovv)
    X2l = contract("kabc,klc->lab", T, Eooov[j])
    e = 2.0 * contract("a,a->", t1[i], X1)
    e += contract("ab,ab->", t2w[i, j], X2)
    e -= contract("lab,lab->", t2w[i], X2l)
    return e


@partial(jax.jit, static_argnames="no")
def _t_vikings_row(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps,
                   t1, t2, no):
    """One fixed-i row of the (T) energy: fori_loop over j."""
    eps_o, eps_v = eps[:no], eps[no:]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)

    def body(j, acc):
        t3 = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        return acc + _slab_pair_energy(t3, i, j, Evovv, Eooov, Loovv,
                                       Fov, t1, t2w)

    return jax.lax.fori_loop(0, no, body, jnp.asarray(0.0, Fov.dtype))


@partial(jax.jit, static_argnames="no")
def _t_vikings_row_sym(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps,
                       t1, t2, no):
    """Fixed-i (T) row exploiting pair-permutation symmetry: the connected
    T3 satisfies t3[j,i,k]^{abc} = t3[i,j,k]^{bac} (simultaneous swap of
    the first two occupied/virtual index pairs), so one slab built for
    j >= i serves BOTH the (i,j) and (j,i) energy contributions — the
    12-contraction slab build (the n^7 cost) runs once per unordered
    pair.  The reference evaluates every ordered pair independently
    (/root/reference/pycc/cctriples.py:106-152)."""
    eps_o, eps_v = eps[:no], eps[no:]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)

    def body(j, acc):
        t3 = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        e = _slab_pair_energy(t3, i, j, Evovv, Eooov, Loovv, Fov, t1, t2w)
        ep = _slab_pair_energy(t3.swapaxes(1, 2), j, i, Evovv, Eooov,
                               Loovv, Fov, t1, t2w)
        return acc + e + jnp.where(j > i, ep, 0.0)

    return jax.lax.fori_loop(i, no, body, jnp.asarray(0.0, Fov.dtype))


def _ax_slice(x, ax, j0, n):
    """Dynamic window [j0:j0+n) along axis ax."""
    starts = [0] * x.ndim
    starts[ax] = j0
    sizes = list(x.shape)
    sizes[ax] = n
    return jax.lax.dynamic_slice(x, tuple(starts), tuple(sizes))


def _t3c_slab_iJ(i, j0, jc, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v):
    """t3[i, j0:j0+jc] chunk (j,k,a,b,c): the j-batched production tiling.

    Identical arithmetic to jc stacked `_t3c_slab_ij` slabs, but each of
    the twelve contractions is ONE matmul with an N-dimension jc times
    larger — better matmul utilization and a fraction of the per-slab
    fusion/layout overhead."""
    Wi = Wvvvo_o[i]
    t2i = t2[i]
    t2_i2 = t2[:, i]
    WJ = _ax_slice(Wvvvo_o, 0, j0, jc)
    t2J = _ax_slice(t2, 0, j0, jc)
    t2_J2 = _ax_slice(t2, 1, j0, jc)
    t3 = contract("bae,kjce->jkabc", Wi, t2_J2)
    t3 += contract("cae,jkbe->jkabc", Wi, t2J)
    t3 += contract("kace,jbe->jkabc", Wvvvo_o, _ax_slice(t2_i2, 0, j0, jc))
    t3 += contract("kbce,jae->jkabc", Wvvvo_o, _ax_slice(t2i, 0, j0, jc))
    t3 += contract("jcbe,kae->jkabc", WJ, t2i)
    t3 += contract("jabe,kce->jkabc", WJ, t2_i2)
    t3 -= contract("jkmc,mab->jkabc", _ax_slice(Wovoo_t, 0, j0, jc), t2i)
    t3 -= contract("kjmb,mac->jkabc", _ax_slice(Wovoo_t, 1, j0, jc), t2i)
    t3 -= contract("jmb,kmca->jkabc", _ax_slice(Wovoo_t[i], 0, j0, jc), t2)
    t3 -= contract("jma,kmcb->jkabc", _ax_slice(Wovoo_t[:, i], 0, j0, jc),
                   t2)
    t3 -= contract("kma,jmbc->jkabc", Wovoo_t[:, i], t2J)
    t3 -= contract("kmc,jmba->jkabc", Wovoo_t[i], t2J)
    eJ = jax.lax.dynamic_slice(eps_o, (j0,), (jc,))
    denom = (eps_o[i] + eJ[:, None, None, None, None]
             + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None]
             - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    return jax.lax.optimization_barrier(t3 / denom)  # see _t3c_slab


def _chunk_pair_energies(t3, Lext, Eext, Fov, Evovv, t1e, t2we, t2wr):
    """Per-j (T) energies of a (j,k,a,b,c) chunk against one set of
    external operands.  Lext/Eext/t1e/t2we are either j-windows (for the
    (i,j) role, leading axis j) or the fixed-i row broadcast to the
    chunk.  Returns e[j]."""
    td = t3 - t3.swapaxes(2, 4)
    T = 2.0 * t3 - t3.swapaxes(3, 4) - t3.swapaxes(2, 4)
    X1 = contract("jkabc,jkbc->ja", td, Lext)
    X2 = contract("jkabc,kc->jab", td, Fov)
    X2 += contract("jkabc,dkbc->jad", T, Evovv)
    X2l = contract("jkabc,jklc->jlab", T, Eext)
    # the X intermediates are tiny (j-window x v^2); upcast the final
    # scalar contractions so a bf16 slab build still accumulates the
    # energies in f32
    up = (jnp.float32 if X1.dtype == jnp.bfloat16 else X1.dtype)
    u = lambda x: x.astype(up)
    e = 2.0 * contract("ja,ja->j", u(t1e), u(X1))
    e += contract("jab,jab->j", u(t2we), u(X2))
    e -= contract("jlab,jlab->j", u(t2wr), u(X2l))
    return e


@partial(jax.jit, static_argnames=("no", "jc"))
def _t_vikings_row_sym_jc(i, Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov,
                          eps, t1, t2, no, jc):
    """Fixed-i (T) row, j-chunked AND pair-symmetric: jc j-values per
    fori_loop trip (chunks tile [0,no); the triangle j>=i is enforced by
    per-j masks on the energies, so partial chunks cost nothing extra).
    Requires jc | no."""
    eps_o, eps_v = eps[:no], eps[no:]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)

    def body(c, acc):
        j0 = c * jc
        jj = j0 + jnp.arange(jc)
        t3 = _t3c_slab_iJ(i, j0, jc, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        # (i,j) role: external pair (i, j) for each j in the window
        e_ij = _chunk_pair_energies(
            t3, _ax_slice(Loovv, 0, j0, jc),
            _ax_slice(Eooov, 0, j0, jc), Fov, Evovv,
            jnp.broadcast_to(t1[i], (jc,) + t1[i].shape),
            _ax_slice(t2w[i], 0, j0, jc),
            jnp.broadcast_to(t2w[i], (jc,) + t2w[i].shape))
        # (j,i) role from the SAME chunk: t3[j,i,k]^{abc} = t3[i,j,k]^{bac}
        t3p = t3.swapaxes(2, 3)
        e_ji = _chunk_pair_energies(
            t3p, jnp.broadcast_to(Loovv[i], (jc,) + Loovv[i].shape),
            jnp.broadcast_to(Eooov[i], (jc,) + Eooov[i].shape), Fov,
            Evovv, _ax_slice(t1, 0, j0, jc),
            _ax_slice(t2w, 0, j0, jc)[:, i],
            _ax_slice(t2w, 0, j0, jc))
        e = jnp.sum(jnp.where(jj >= i, e_ij, 0.0))
        e += jnp.sum(jnp.where(jj > i, e_ji, 0.0))
        return acc + e

    acc_dt = jnp.float32 if Fov.dtype == jnp.bfloat16 else Fov.dtype
    return jax.lax.fori_loop(i // jc, no // jc, body,
                             jnp.asarray(0.0, acc_dt))


def t_scan_flops(no, nv, sym=True):
    """Analytic flop count of the slab-scan (T) energy.  Per (i,j) slab:
    six 2*no*nv^4 W-terms + six 2*no^2*nv^3 Wovoo terms + the no*nv^3
    denominator; per consumed external pair: the 2*no*nv^4 Evovv dot +
    td/T assembly + the small X contractions.  Used for roofline
    reporting (bench.py) — XLA's cost_analysis charges a fori_loop body
    once, so the analytic count is the honest sustained-rate basis."""
    pairs = no * (no + 1) // 2 if sym else no * no
    per_slab = (12.0 * no * nv ** 4 + 12.0 * no ** 2 * nv ** 3
                + no * nv ** 3)
    per_energy = (2.0 * no * nv ** 4 + 2.0 * no ** 2 * nv ** 3
                  + 10.0 * no * nv ** 3)
    n_energy = no * no  # every ordered pair is consumed exactly once
    return pairs * per_slab + n_energy * per_energy


def t_vikings_scan_core(Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps,
                        t1, t2, no, sym=True, slab_dtype=None, jc=None):
    """Slice-fed (T) energy core: callable directly when the full ERI/L are
    never materialized (sliced-H storage, probes).

    One jitted device program per occupied row i (inner fori_loop over j):
    the host-side i loop keeps each dispatch short, with the arithmetic
    of one no^2-trip program.  Do NOT wrap this function in jax.jit (that would unroll
    the host loop back into one long program).

    sym=True (default) builds each T3 slab once per unordered pair
    (_t_vikings_row_sym_jc) — ~1.7x fewer flops, identical energy — and
    chunks jc j-values per trip behind an optimization_barrier.  The
    barrier is the decisive piece: without it XLA REMATERIALIZES the
    twelve-dot slab assembly into every energy consumer, and the scan
    runs ~5.6x slower (60.9 s vs 10.8 s at (32,128) f32).

    slab_dtype=jnp.bfloat16 builds/consumes the T3 slabs in bf16 (each
    dot still accumulates in f32; the per-pair energies and the running
    sum are upcast to f32 before the scalar contractions).  Where the
    scan is bound by slab traffic, halving the slab bytes cuts its wall
    at the cost of ~bf16-level (T)-correction noise — the right trade
    where (T) already rides an SP amplitude floor.  jc overrides the
    j-chunk width (default 2; larger chunks amortize the two full-Wvvvo
    reads per chunk and widen each matmul at slab_bytes * jc of device
    memory)."""
    if slab_dtype is not None:
        cast = lambda x: jnp.asarray(x).astype(slab_dtype)
        (Wvvvo_o, Wovoo_t, Evovv, Eooov, Loovv, Fov, eps, t1, t2) = (
            cast(Wvvvo_o), cast(Wovoo_t), cast(Evovv), cast(Eooov),
            cast(Loovv), cast(Fov), cast(eps), cast(t1), cast(t2))
    if sym:
        if jc is None:
            jc = 2 if no % 2 == 0 else 1
        if no % jc:
            raise ValueError("jc=%d must divide no=%d" % (jc, no))
        row = partial(_t_vikings_row_sym_jc, jc=jc)
    else:
        row = _t_vikings_row
    acc_dt = jnp.float32 if Fov.dtype == jnp.bfloat16 else Fov.dtype
    e = jnp.asarray(0.0, acc_dt)
    for i in range(no):
        e = e + row(jnp.asarray(i), Wvvvo_o, Wovoo_t, Evovv,
                    Eooov, Loovv, Fov, eps, t1, t2, no=no)
    return e


# ---------------------------------------------------------------------------
# Integral-direct k-chunked (T): CCSD(T) at the DF scale
# ---------------------------------------------------------------------------

def _dslice(x, k0, kc):
    """Leading-axis window [k0:k0+kc] of an arbitrary-rank operand."""
    return jax.lax.dynamic_slice(x, (k0,) + (0,) * (x.ndim - 1),
                                 (kc,) + x.shape[1:])


def _t3c_chunk_ij(i, j, k0, kc, W, Wovoo_t, t2, eps_o, eps_v):
    """_t3c_slab_ij restricted to a k-window (K,a,b,c).

    W is Wvvvo in the occupied-major kace assembly (== slab_layouts'
    Wvvvo_o): W[i] has exactly the (a,b,c) layout the Wi/Wj terms use,
    and the full-k terms take a dynamic k-window."""
    nv = eps_v.shape[0]
    Wi, Wj = W[i], W[j]
    WK = jax.lax.dynamic_slice(W, (k0, 0, 0, 0), (kc, nv, nv, nv))
    t3 = contract("bae,kce->kabc", Wi, _dslice(t2[:, j], k0, kc))
    t3 += contract("cae,kbe->kabc", Wi, _dslice(t2[j], k0, kc))
    t3 += contract("kace,be->kabc", WK, t2[j, i])
    t3 += contract("kbce,ae->kabc", WK, t2[i, j])
    t3 += contract("cbe,kae->kabc", Wj, _dslice(t2[i], k0, kc))
    t3 += contract("abe,kce->kabc", Wj, _dslice(t2[:, i], k0, kc))
    t3 -= contract("kmc,mab->kabc", _dslice(Wovoo_t[j], k0, kc), t2[i])
    t3 -= contract("kmb,mac->kabc", _dslice(Wovoo_t[:, j], k0, kc), t2[i])
    t3 -= contract("mb,kmca->kabc", Wovoo_t[i, j], _dslice(t2, k0, kc))
    t3 -= contract("ma,kmcb->kabc", Wovoo_t[j, i], _dslice(t2, k0, kc))
    t3 -= contract("kma,mbc->kabc", _dslice(Wovoo_t[:, i], k0, kc), t2[j])
    t3 -= contract("kmc,mba->kabc", _dslice(Wovoo_t[i], k0, kc), t2[j])
    eo = jax.lax.dynamic_slice(eps_o, (k0,), (kc,))
    denom = (eps_o[i] + eps_o[j] + eo[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return jax.lax.optimization_barrier(t3 / denom)  # see _t3c_slab


def _chunk_X(t3, WK, Lj_k, Fov_k, Ej_k):
    """X1/X2/X2l increments of one k-chunk slab for one external pair.
    Evovv[d,k,b,c] = (db|kc) == (db|ck) = W[k,d,c,b], a label permutation
    of the SAME resident tensor — XLA materializes one kc*v^3 layout copy
    per chunk instead of a second no*v^3 resident."""
    td = t3 - t3.swapaxes(1, 3)
    T = 2.0 * t3 - t3.swapaxes(2, 3) - t3.swapaxes(1, 3)
    X1 = contract("kabc,kbc->a", td, Lj_k)
    X2 = contract("kabc,kc->ab", td, Fov_k)
    X2 += contract("kabc,kdcb->ad", T, WK)
    X2l = contract("kabc,klc->lab", T, Ej_k)
    return X1, X2, X2l


@partial(jax.jit, static_argnames=("no", "kc"))
def _t_df_row_chunked(i, W, Wovoo_t, Eooov, Loovv, Fov, eps, t1, t2,
                      no, kc):
    """One fixed-i row of the (T) energy with k-chunked slabs, exploiting
    the pair-permutation symmetry (see _t_vikings_row_sym): each chunk
    slab built for j >= i feeds BOTH the (i,j) and (j,i) X-accumulators;
    the n^7 slab build runs once per unordered pair."""
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    t2w = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    k0s = jnp.arange(0, no, kc)

    def body(j, acc):
        def chunk(carry, k0):
            Xij, Xji = carry
            t3 = _t3c_chunk_ij(i, j, k0, kc, W, Wovoo_t, t2, eps_o, eps_v)
            WK = jax.lax.dynamic_slice(W, (k0, 0, 0, 0), (kc, nv, nv, nv))
            Fk = _dslice(Fov, k0, kc)
            dij = _chunk_X(t3, WK, _dslice(Loovv[j], k0, kc), Fk,
                           _dslice(Eooov[j], k0, kc))
            dji = _chunk_X(t3.swapaxes(1, 2), WK,
                           _dslice(Loovv[i], k0, kc), Fk,
                           _dslice(Eooov[i], k0, kc))
            Xij = tuple(x + d for x, d in zip(Xij, dij))
            Xji = tuple(x + d for x, d in zip(Xji, dji))
            return (Xij, Xji), 0.0

        z = (jnp.zeros((nv,), Fov.dtype), jnp.zeros((nv, nv), Fov.dtype),
             jnp.zeros((no, nv, nv), Fov.dtype))
        ((X1, X2, X2l), (Y1, Y2, Y2l)), _ = jax.lax.scan(chunk, (z, z), k0s)
        e = 2.0 * contract("a,a->", t1[i], X1)
        e += contract("ab,ab->", t2w[i, j], X2)
        e -= contract("lab,lab->", t2w[i], X2l)
        ep = 2.0 * contract("a,a->", t1[j], Y1)
        ep += contract("ab,ab->", t2w[j, i], Y2)
        ep -= contract("lab,lab->", t2w[j], Y2l)
        return acc + e + jnp.where(j > i, ep, 0.0)

    return jax.lax.fori_loop(i, no, body, jnp.asarray(0.0, Fov.dtype))


def _t_df_kc(no, nv, max_elems=2 ** 26):
    """Largest divisor of no whose chunk slab (kc, v, v, v) stays under
    max_elems elements (256 MB f32 by default — the symmetric row carries
    ~7 simultaneous chunk-sized temps: t3, its pair transpose, and both
    td/T sets)."""
    cap = max(1, int(max_elems // max(1, nv ** 3)))
    kc = 1
    for d in range(1, no + 1):
        if no % d == 0 and d <= cap:
            kc = d
    return kc


def t_vikings_scan_df_chunked(dfb, F, t1, t2, no, kc=None):
    """(T) from factors with ONE resident (o, v, v, v) integral tensor
    and k-chunked slabs: Wvvvo in the kace assembly serves the slab
    terms (W[i] is exactly the Wi layout) AND the Evovv energy term
    ((ac|bk) and (db|kc) are label permutations of the same factor
    product).  Working set W + ~6 chunk slabs: at (40, 360) f32 that is
    ~7.5 GB + kc * 1.1 GB, vs ~15 GB + no*v^3 slabs for the unchunked
    assembly — CCSD(T) for a 410-bf molecule on one 16 GB chip."""
    nv = F.shape[0] - no
    if kc is None:
        kc = _t_df_kc(no, nv)
    o = slice(0, no)

    @jax.jit
    def prep(F, Boo, Bov, Bvv):
        # k-mapped assembly: one einsum "Pae,Pkc->kace" would hold the
        # natural (a,e,k,c) dot output AND the transposed copy (2x the
        # ~7.5 GB W at (40,360)); per-row the copy is one v^3 sheet
        W = jax.lax.map(lambda Bk: contract("Pae,Pc->ace", Bvv, Bk),
                        jnp.moveaxis(Bov, 1, 0))
        Wovoo_t = contract("Pij,Pka->jkia", Boo, Bov)
        Eooov = contract("Pik,Pja->ijka", Boo, Bov)
        Eoovv = contract("Pia,Pjb->ijab", Bov, Bov)
        Loovv = 2.0 * Eoovv - Eoovv.swapaxes(2, 3)
        return W, Wovoo_t, Eooov, Loovv, F[o, no:], jnp.diagonal(F)

    W, Wovoo_t, Eooov, Loovv, Fov, eps = prep(jnp.asarray(F), dfb.Boo,
                                              dfb.Bov, dfb.Bvv)
    e = jnp.asarray(0.0, Fov.dtype)
    for i in range(no):
        e = e + _t_df_row_chunked(jnp.asarray(i), W, Wovoo_t, Eooov,
                                  Loovv, Fov, eps, t1, t2, no=no, kc=kc)
    return e


# ---------------------------------------------------------------------------
# Memory-scalable (T) density: per-(i,j) slabs (lax.fori_loop)
# ---------------------------------------------------------------------------

def _perm_v_slab(s, order):
    """Permute the three virtual axes (1,2,3) of a (k,a,b,c) slab."""
    axes = (0,) + tuple(1 + "abc".index(c) for c in order)
    return (s).transpose(*axes)


def _X3_v_slab(s):
    return (8.0 * s - 4.0 * _perm_v_slab(s, "bac") - 4.0 * _perm_v_slab(s, "acb")
            - 4.0 * _perm_v_slab(s, "cba") + 2.0 * _perm_v_slab(s, "cab")
            + 2.0 * _perm_v_slab(s, "bca"))


def _t3d_slab_ij(i, j, t1, t2, Eoovv, Fov, eps_o, eps_v):
    """Disconnected T3[i, j] slab (k,a,b,c) (cctriples.py:68-83, sliced)."""
    t3 = contract("ab,kc->kabc", Eoovv[i, j], t1)
    t3 += contract("kac,b->kabc", Eoovv[i], t1[j])
    t3 += contract("kbc,a->kabc", Eoovv[j], t1[i])
    t3 += contract("ab,kc->kabc", t2[i, j], Fov)
    t3 += contract("kac,b->kabc", t2[i], Fov[j])
    t3 += contract("kbc,a->kabc", t2[j], Fov[i])
    denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return jax.lax.optimization_barrier(t3 / denom)  # see _t3c_slab


def t3_density_scan(cc):
    """(T) Lambda sources + density blocks with O(no v^3) working memory.

    Produces the exact same nine outputs as `t3_density`
    (ccwfn.py:721-855) without ever materializing the full no^3 v^3 T3.
    One connected + one disconnected slab per ordered (i,j) pair feed every
    contraction; the occupied-axis permutation combos (X3_o in the full
    code) are rewritten as virtual-axis transposes of the SAME slab using
    T3's invariance under simultaneous occupied/virtual permutations:
    M[x,p,q,a,b,c] = M[p,q,x,b,c,a], so the Doo term needs only the
    (p,q)-slab already in registers.  Results are cached on the ccwfn
    object for ccdensity/cclambda, as in the full-tensor path."""
    no = cc.no
    t1, t2 = cc.t1, cc.t2
    o, v = _slices(no)

    if getattr(cc, "storage", "full") == "df":
        # (T)-density slices from the Cholesky factors — the same
        # assembly as the DF-(T) energy (t_vikings_scan), plus Eovvv.
        # Dirac <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s].
        @jax.jit
        def prep_df(F, Boo, Bov, Bvv):
            Wvvvo_o = contract("Pac,Pib->iabc", Bvv, Bov)
            Wovoo_t = contract("Pij,Pka->jkia", Boo, Bov)
            Evovv = contract("Pab,Pic->aibc", Bvv, Bov)
            Eooov = contract("Pik,Pja->ijka", Boo, Bov)
            Eovvv = contract("Pib,Pac->iabc", Bov, Bvv)
            Eoovv = contract("Pia,Pjb->ijab", Bov, Bov)
            Loovv = 2.0 * Eoovv - Eoovv.swapaxes(2, 3)
            return (Wvvvo_o, Wovoo_t, Evovv, Eooov, Eovvv, Eoovv,
                    Loovv, F[o, v], jnp.diagonal(F))

        (Wvvvo, Wovoo, Evovv, Eooov, Eovvv, Eoovv,
         Loovv, Fov, eps) = prep_df(jnp.asarray(cc.H.F), cc.dfb.Boo,
                                    cc.dfb.Bov, cc.dfb.Bvv)
    elif getattr(cc, "storage", "full") == "blocked":
        from .models.blocked import blocked_views

        @jax.jit
        def prep_b(F, blocks):
            ERI, L = blocked_views(blocks, no)
            Wvvvo_o, Wovoo_t = slab_layouts(ERI[v, v, v, o],
                                            ERI[o, v, o, o])
            return (Wvvvo_o, Wovoo_t, ERI[v, o, v, v], ERI[o, o, o, v],
                    ERI[o, v, v, v], ERI[o, o, v, v], L[o, o, v, v],
                    F[o, v], jnp.diagonal(F))

        (Wvvvo, Wovoo, Evovv, Eooov, Eovvv, Eoovv,
         Loovv, Fov, eps) = prep_b(jnp.asarray(cc.H.F), cc.blocks)
    else:
        @jax.jit
        def prep(F, ERI, L):
            Wvvvo_o, Wovoo_t = slab_layouts(ERI[v, v, v, o],
                                            ERI[o, v, o, o])
            return (Wvvvo_o, Wovoo_t, ERI[v, o, v, v],
                    ERI[o, o, o, v], ERI[o, v, v, v], ERI[o, o, v, v],
                    L[o, o, v, v], F[o, v], jnp.diagonal(F))

        (Wvvvo, Wovoo, Evovv, Eooov, Eovvv, Eoovv,
         Loovv, Fov, eps) = prep(cc.H.F, cc.H.ERI, cc.H.L)
    ET, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2 = t3_density_scan_core(
        Wvvvo, Wovoo, Evovv, Eooov, Eovvv, Eoovv, Loovv, Fov, eps, t1, t2,
        no)
    cc.Doo_t3, cc.Dvv_t3, cc.Dov_t3 = Doo, Dvv, Dov
    cc.Goovv, cc.Gooov, cc.Gvvvo = Goovv, Gooov, Gvvvo
    cc.S1, cc.S2 = S1, S2
    return ET


def _order_axes(order):
    return (0,) + tuple(1 + "abc".index(c) for c in order)


def _view_labels(axes, base="abc"):
    """einsum labels L such that using transpose(s, axes) labeled "k"+base
    is the same as using s labeled "k"+L (labels permuted, no copy)."""
    return "".join(base[axes.index(n) - 1] for n in (1, 2, 3))


# X3 combination (8 - 4 P_ab - 4 P_bc - 4 P_ac + 2 P_cab + 2 P_bca)
_X3_TERMS = ((8.0, "abc"), (-4.0, "bac"), (-4.0, "acb"), (-4.0, "cba"),
             (2.0, "cab"), (2.0, "bca"))


@partial(jax.jit, static_argnames="no")
def _t3_density_row_mn(i, acc, Wvvvo_o, Wovoo_t, Evovv, Eooov, Eoovv,
                       Loovv, Fov, eps, t1, t2, no):
    """Row program 1: M/N-direct accumulations (X2, Dvv, Dov, Goovv, S1).

    The (T)-density row is split into three jitted programs per occupied
    row because every distinct operand permutation materializes a slab-size
    layout copy; one combined program holds ~60 such 256 MB copies
    live at (32,128), more than a 16 GB device.  Rebuilding the (cheap) M/N
    slabs per program trades ~3x slab-build flops for a ~4 GB peak."""
    eps_o, eps_v = eps[:no], eps[no:]
    tt = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)

    def lab(order, base="abc"):
        return _view_labels(_order_axes(order), base)

    def body(j, acc):
        (X2, Dvv, Dov, Goovv, S1) = acc
        M = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        N = _t3d_slab_ij(i, j, t1, t2, Eoovv, Fov, eps_o, eps_v)
        MN = jax.lax.optimization_barrier(M + N)

        # Md = M - M^{a<->c};  T = 2M - M^{b<->c} - M^{a<->c}  (relabeled)
        x2ij = contract("kabc,kc->ab", M, Fov)
        x2ij -= contract("k" + lab("cba") + ",kc->ab", M, Fov)
        for c_, o_ in ((2.0, "abc"), (-1.0, "acb"), (-1.0, "cba")):
            x2ij += c_ * contract("k" + lab(o_) + ",dkbc->ad", M, Evovv)
            X2 = X2.at[i].add(
                -c_ * contract("k" + lab(o_) + ",klc->lab", M, Eooov[j]))
        X2 = X2.at[i, j].add(x2ij)

        # Dvv = 0.5 M . (X3+Y3)(MN): distribute the 6 permutations
        for c_, o_ in _X3_TERMS:
            Dvv = Dvv + (0.5 * c_) * contract(
                "kacd,k" + lab(o_, "bcd") + "->ab", M, MN)

        Dov = Dov.at[i].add(contract("kabc,kbc->a", M, tt[j])
                            - contract("k" + lab("cba") + ",kbc->a",
                                       M, tt[j]))

        # Z3 = 2M - 2 M^{b<->c} - M^{a<->b} + M^{bca}
        g = 2.0 * contract("kabc,kc->ab", M, t1)
        g -= 2.0 * contract("k" + lab("acb") + ",kc->ab", M, t1)
        g -= contract("k" + lab("bac") + ",kc->ab", M, t1)
        g += contract("k" + lab("bca") + ",kc->ab", M, t1)
        Goovv = Goovv.at[i, j].add(4.0 * g)

        S1 = S1.at[i].add(2.0 * (contract("kabc,kbc->a", M, Loovv[j])
                                 - contract("k" + lab("bac") + ",kbc->a",
                                            M, Loovv[j])))
        return (X2, Dvv, Dov, Goovv, S1)

    return jax.lax.fori_loop(0, no, body, acc)


@partial(jax.jit, static_argnames="no")
def _t3_density_row_w(i, acc, Wvvvo_o, Wovoo_t, Evovv, Eooov, Eovvv, Eoovv,
                      Loovv, Fov, eps, t1, t2, no):
    """Row program 2: W = (2 X3 + Y3)-based accumulations (Gooov, Gvvvo,
    S2)."""
    eps_o, eps_v = eps[:no], eps[no:]

    def lab(order, base="abc"):
        return _view_labels(_order_axes(order), base)

    def body(j, acc):
        (Gooov, Gvvvo_t, S2) = acc
        M = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        N = _t3d_slab_ij(i, j, t1, t2, Eoovv, Fov, eps_o, eps_v)
        P = jax.lax.optimization_barrier(2.0 * M + N)
        # W = X3(P) is never materialized: distribute the 6 permutations
        # into each consumer (a 256 MB layout copy per distinct perm beats
        # holding W plus its build chain live)
        g_la = 0.0
        g_abd = 0.0
        s_lab = 0.0
        s_ad = 0.0
        for c_, o_ in _X3_TERMS:
            pl = "k" + lab(o_)
            g_la += c_ * contract(pl + ",lkbc->la", P, t2)
            g_abd += c_ * contract(pl + ",kcd->abd", P, t2[:, i])
            s_lab += c_ * contract(pl + ",klc->lab", P, Eooov[j])
            s_ad += c_ * contract(pl + ",kdcb->ad", P, Eovvv)
        Gooov = Gooov.at[j, i].add(-g_la)
        Gvvvo_t = Gvvvo_t.at[j].add(g_abd)
        S2 = S2.at[i].add(-s_lab)
        S2 = S2.at[i, j].add(s_ad)
        return (Gooov, Gvvvo_t, S2)

    return jax.lax.fori_loop(0, no, body, acc)


@partial(jax.jit, static_argnames="no")
def _t3_density_row_doo(i, Doo, Wvvvo_o, Wovoo_t, Eoovv, Fov, eps, t1, t2,
                        no):
    """Row program 3: Doo via the occupied-permutation label cycle."""
    eps_o, eps_v = eps[:no], eps[no:]
    cyc = (0, 3, 1, 2)  # A[x,a,b,c] = M[x,b,c,a]
    a_lab = "i" + _view_labels(cyc)

    def body(j, Doo):
        M = _t3c_slab_ij(i, j, Wvvvo_o, Wovoo_t, t2, eps_o, eps_v)
        N = _t3d_slab_ij(i, j, t1, t2, Eoovv, Fov, eps_o, eps_v)
        MN = jax.lax.optimization_barrier(M + N)
        for c_, o_ in _X3_TERMS:
            comb = tuple(cyc[k] for k in _order_axes(o_))
            Doo = Doo - (0.5 * c_) * contract(
                a_lab + ",j" + _view_labels(comb) + "->ij", M, MN)
        return Doo

    return jax.lax.fori_loop(0, no, body, Doo)


def t3_density_scan_core(Wvvvo_o, Wovoo_t, Evovv, Eooov, Eovvv, Eoovv,
                         Loovv, Fov, eps, t1, t2, no):
    """Slice-fed (T)-density core: returns (ET, Doo, Dvv, Dov, Goovv,
    Gooov, Gvvvo, S1, S2); callable directly when the full ERI/L are never
    materialized (sliced-H storage, probes).

    Host loop over i with one jitted device program per row (see
    t_vikings_scan_core: short dispatches instead of one minutes-long
    program).  Do NOT wrap in jax.jit."""
    nv = Fov.shape[1]
    dt = Fov.dtype
    zeros = jnp.zeros
    acc1 = (zeros((no, no, nv, nv), dt), zeros((nv, nv), dt),
            zeros((no, nv), dt), zeros((no, no, nv, nv), dt),
            zeros((no, nv), dt))
    acc2 = (zeros((no, no, no, nv), dt), zeros((no, nv, nv, nv), dt),
            zeros((no, no, nv, nv), dt))
    Doo = zeros((no, no), dt)
    for i in range(no):
        ii = jnp.asarray(i)
        acc1 = _t3_density_row_mn(ii, acc1, Wvvvo_o, Wovoo_t, Evovv, Eooov,
                                  Eoovv, Loovv, Fov, eps, t1, t2, no=no)
        acc2 = _t3_density_row_w(ii, acc2, Wvvvo_o, Wovoo_t, Evovv, Eooov,
                                 Eovvv, Eoovv, Loovv, Fov, eps, t1, t2,
                                 no=no)
        Doo = _t3_density_row_doo(ii, Doo, Wvvvo_o, Wovoo_t, Eoovv, Fov,
                                  eps, t1, t2, no=no)
    (X2, Dvv, Dov, Goovv, S1) = acc1
    (Gooov, Gvvvo_t, S2) = acc2
    Gvvvo = (Gvvvo_t).transpose(1, 2, 3, 0)
    tt = 4.0 * t2 - 2.0 * t2.swapaxes(2, 3)
    S2 = S2 + S2.transpose(1, 0, 3, 2)
    ET = contract("ia,ia->", t1, S1)
    ET += contract("ijab,ijab->", tt, X2)
    return ET, Doo, Dvv, Dov, Goovv, Gooov, Gvvvo, S1, S2
