"""CC3: iterative approximate triples model.

Rebuild of the CC3 pieces of the reference (T1-dressed intermediates and
per-triple T3 loops in /root/reference/pycc/ccwfn.py:371-404,625-710, the
Lambda-CC3 Z-intermediates in cclambda.py:322-441, and the CC3 one-electron
densities in ccdensity.py:277-346).  All per-(i,j,k) Python loops become
full-tensor einsum batches over the whole (o^3 v^3) T3/L3 space —
matmul-shaped dot_general graphs under jit.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.contract import contract
from ..ops.ctensor import ct_zeros_like
from ..triples import t3_denom, t3c_full, _swap_ac, _swap_bc, slab_layouts
from .ccsd import build_Fme, residuals_ccsd, slices


# ---------------------------------------------------------------------------
# T1-dressed intermediates (ccwfn.build_cc3_*)
# ---------------------------------------------------------------------------

def cc3_intermediates(ERI, t1, no):
    o, v = slices(no)
    Wmnij = ERI[o, o, o, o]
    tmp = contract("ijma,na->ijmn", ERI[o, o, o, v], t1)
    Wmnij = Wmnij + tmp + tmp.transpose(1, 0, 3, 2)
    Wmnij = Wmnij + contract("mnif,jf->mnij",
                             contract("ia,mnaf->mnif", t1, ERI[o, o, v, v]), t1)

    Wmbij = ERI[o, v, o, o]
    Wmbij = Wmbij - contract("mnij,nb->mbij", Wmnij, t1)
    Wmbij = Wmbij + contract("mbie,je->mbij", ERI[o, v, o, v], t1)
    tmp = ERI[o, v, v, o] + contract("mbef,jf->mbej", ERI[o, v, v, v], t1)
    Wmbij = Wmbij + contract("ie,mbej->mbij", t1, tmp)

    Wmnie = ERI[o, o, o, v] + contract("if,mnfe->mnie", t1, ERI[o, o, v, v])
    Wamef = ERI[v, o, v, v] - contract("na,nmef->amef", t1, ERI[o, o, v, v])

    # Wabei (ccwfn.build_cc3_Wabei)
    Z = ERI[v, o, v, v]
    tmp_ints = ERI[v, v, v, v] + ERI[v, v, v, v].swapaxes(2, 3)
    Z1 = 0.5 * contract("if,abef->eiab", t1, tmp_ints)
    tmp_ints = ERI[v, v, v, v] - ERI[v, v, v, v].swapaxes(2, 3)
    Z2 = 0.5 * contract("if,abef->eiab", t1, tmp_ints)
    Z_eiab = Z + Z1 + Z2
    Zeiam = ERI[v, o, v, o]
    Zamei = contract("amef,if->amei", ERI[v, o, v, v], t1)
    Zeiam = Zeiam + Zamei.transpose(2, 3, 0, 1)
    Z_eiab = Z_eiab - contract("eiam,mb->eiab", Zeiam, t1)
    Zmnei = ERI[o, o, v, o] + contract("mnef,if->mnei", ERI[o, o, v, v], t1)
    Zanei = contract("ma,mnei->anei", t1, Zmnei)
    Z_eiab = Z_eiab + contract("anei,nb->eiab", Zanei, t1)
    Zmbei = ERI[o, v, v, o] + contract("mbef,if->mbei", ERI[o, v, v, v], t1)
    Z_abei = -1.0 * contract("ma,mbei->abei", t1, Zmbei)
    Wabei = Z_abei + Z_eiab.transpose(2, 3, 0, 1)

    return Wmnij, Wmbij, Wmnie, Wamef, Wabei


def cc3_intermediates_df(dfb, t1, no, scan_layout=False):
    """The five T1-dressed CC3 W intermediates assembled from Cholesky/DF
    factors — cc3_intermediates term by term with ERI[p,q,r,s] = <pq|rs>
    = (pr|qs) = sum_P B[P,p,r] B[P,q,s] and the rank-1 t1 dressings of
    models/dfhbar.py.  The ov^3 tensors (Wamef, Wabei) ARE materialized
    (the slab scans need them resident anyway), but nothing nact^4 ever
    exists: the dense builder consumes ERI[v,v,v,v] (cc3_intermediates
    line 45), which is why the reference's CC3 stops at dense-ERI sizes
    (/root/reference/pycc/ccwfn.py:371-404 via hamiltonian.py:36).

    scan_layout=True emits Wabei directly as the occupied-major
    [i,a,b,e] slab layout and Wmbij as [i,j,m,b] (triples.slab_layouts),
    skipping the per-iteration v^3 o layout copy.

    Derivation sketch (each term one 'Pxy,Pzw->xyzw' matmul):
      t1[if] on a ket virtual  -> Cbi[P,b,i]  = Bvv[P,b,f] t1[i,f]
      t1[if] on a ket occupied -> Dmi[P,m,i]  = Bov[P,m,f] t1[i,f]
      t1[ma] on a bra virtual  -> Sae[P,a,e]  = t1[m,a] Bov[P,m,e]
      t1[mb] on a bra occupied -> Eib[P,i,b]  = Boo[P,i,m] t1[m,b]
    The Z1+Z2 pair of the dense Wabei is algebraically t1[if]<ab|ef>
    (the even/odd split sums back); every remaining term collapses onto
    one of the dressed factors above (Gib/Kib below are their
    double-dressed compositions)."""
    Boo, Bov, Bvv = dfb.Boo, dfb.Bov, dfb.Bvv
    Bvo = Bov.transpose(0, 2, 1)
    Dmi = contract("Pmf,if->Pmi", Bov, t1)
    Cbi = contract("Pbf,if->Pbi", Bvv, t1)
    CbiT = Cbi.transpose(0, 2, 1)
    Sae = contract("ma,Pme->Pae", t1, Bov)
    Eib = contract("Pim,mb->Pib", Boo, t1)
    Gib = contract("Pmi,mb->Pib", Dmi, t1)
    Kib = contract("Pni,nb->Pib", Boo + Dmi, t1)

    # Wmnij[mnij] = <mn|ij> + <mn|ia>t1[ja] + (transp) + t1.t1 bilinear
    tmp = contract("Pmi,Pnj->mnij", Boo, Dmi)
    Wmnij = (contract("Pmi,Pnj->mnij", Boo, Boo)
             + tmp + tmp.transpose(1, 0, 3, 2)
             + contract("Pmi,Pnj->mnij", Dmi, Dmi))

    # Wmbij[mbij] = <mb|ij> - Wmnij t1[nb] + <mb|ie>t1[je]
    #             + t1[ie](<mb|ej> + <mb|ef>t1[jf])
    Wmbij = (contract("Pmi,Pbj->mbij", Boo, Bvo + Cbi)
             - contract("mnij,nb->mbij", Wmnij, t1)
             + contract("Pmi,Pbj->mbij", Dmi, Bvo + Cbi))

    # Wmnie = Bd_mi . Bov (== dfhbar Hooov);  Wamef = Bd_ae . Bov
    Wmnie = contract("Pmi,Pne->mnie", Boo + Dmi, Bov)
    Wamef = contract("Pae,Pmf->amef", Bvv - Sae, Bov)

    # Wabei[abei] = Z_abei + Z_eiab^T, all six dense terms regrouped into
    # two factor dots (see docstring):
    #   Z_eiab: <ei|ab> + t1[if]<ab|ef> - Zeiam t1[mb] + Zanei t1[nb]
    #   Z_abei: -t1[ma] Zmbei
    out = "iabe" if scan_layout else "abei"
    Wabei = (contract("Pae,Pib->" + out, Bvv, Bov + CbiT - Eib - Gib)
             + contract("Pae,Pib->" + out, Sae, Kib - Bov - CbiT))
    if scan_layout:
        Wmbij = Wmbij.transpose(2, 3, 0, 1)
    return Wmnij, Wmbij, Wmnie, Wamef, Wabei


def cc3_scan_prep_df(F, dfb, t1, t2, no, real_time=False, F_ref=None,
                     nblocks=None):
    """cc3_scan_prep from factors: the CCSD residual part via the DF
    residuals (models/dfccsd.py) and the dressed W's via
    cc3_intermediates_df, already in slab layout."""
    from .dfccsd import _eri_oovv, residuals_ccsd_df

    o, v = slices(no)
    r1, r2 = residuals_ccsd_df(F, dfb, t1, t2, no, nblocks=nblocks)
    e = _eri_oovv(dfb)
    Lo = 2.0 * e - e.swapaxes(2, 3)
    Fme = F[o, v] + contract("nf,mnef->me", t1, Lo)
    _, Wmbij_t, Wmnie, Wamef, Wabei_o = cc3_intermediates_df(
        dfb, t1, no, scan_layout=True)
    eps = jnp.diagonal(F)
    if real_time:
        Vov = (F - F_ref.astype(F.dtype))[o, v]
    else:
        Vov = jnp.zeros_like(F[o, v])
    return r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, Lo, Vov


def residuals_cc3_scan_df(F, dfb, t1, t2, no, real_time=False, F_ref=None,
                          nblocks=None):
    """CC3 T1/T2 residuals over Cholesky/DF factors, O(no v^3) triples
    working memory — the storage='df' counterpart of residuals_cc3_scan
    (equal given exact factors, test_026).  Jittable: the per-row T3
    slabs run under lax.fori_loop."""
    import jax

    F_ref = F if F_ref is None else F_ref
    (r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t,
     eps, Lo, Vov) = cc3_scan_prep_df(F, dfb, t1, t2, no,
                                      real_time=real_time, F_ref=F_ref,
                                      nblocks=nblocks)
    X1 = ct_zeros_like(r1)
    X2 = ct_zeros_like(r2)
    X1, X2 = jax.lax.fori_loop(
        0, no,
        lambda i, c: _cc3_row_xs(i, c, Wabei_o, Wmbij_t, t2, eps, Lo,
                                 Fme, Wamef, Wmnie, Vov, no, real_time),
        (X1, X2))
    r1 = r1 + X1
    r2 = r2 + X2 + X2.transpose(1, 0, 3, 2)
    return r1, r2


# Lambda-side dressed intermediates (cclambda.build_cc3_W*)
def cc3_lambda_intermediates(ERI, t1, no):
    o, v = slices(no)
    Wmbje = (ERI[o, v, o, v]
             + contract("mbfe,jf->mbje", ERI[o, v, v, v], t1)
             - contract("mnje,nb->mbje", ERI[o, o, o, v], t1)
             - contract("mnfe,jf,nb->mbje", ERI[o, o, v, v], t1, t1))
    Wmbej = (ERI[o, v, v, o]
             + contract("mbef,jf->mbej", ERI[o, v, v, v], t1)
             - contract("mnej,nb->mbej", ERI[o, o, v, o], t1)
             - contract("mnef,jf,nb->mbej", ERI[o, o, v, v], t1, t1))
    Wabef = ERI[v, v, v, v]
    tmp = contract("mbef,ma->abef", ERI[o, v, v, v], t1)
    Wabef = Wabef - tmp - tmp.transpose(1, 0, 3, 2)
    Wabef = Wabef + contract("mnef,ma,nb->abef", ERI[o, o, v, v], t1, t1)
    return Wmbje, Wmbej, Wabef


# ---------------------------------------------------------------------------
# T3 (full tensor), with the optional RT perturbation term
# ---------------------------------------------------------------------------

def t3_pert_full(F, F_ref, t2, no):
    """Connected-T3 perturbation correction for RT-CC3
    (cctriples.t3_pert_ijk over the full index space)."""
    o, v = slices(no)
    V = F - F_ref.astype(F.dtype)
    tmp = contract("ld,ijad->ijal", V[o, v], t2)
    t3 = contract("ijal,klcb->ijkabc", tmp, t2)
    return t3 / t3_denom(F, no)


def cc3_t3_full(F, ERI, t1, t2, no, real_time=False, F_ref=None):
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    t3 = t3c_full(Wabei, Wmbij, t2, F, no)
    if real_time:
        t3 = t3 - t3_pert_full(F, F_ref, t2, no)
    return t3, (Wmnij, Wmbij, Wmnie, Wamef, Wabei)


# ---------------------------------------------------------------------------
# CC3 ground-state residuals
# ---------------------------------------------------------------------------

def residuals_cc3(F, ERI, L, t1, t2, no, real_time=False, F_ref=None):
    o, v = slices(no)
    r1, r2 = residuals_ccsd(F, ERI, L, t1, t2, no)
    Fme = build_Fme(F, L, t1, no)
    t3, (Wmnij, Wmbij, Wmnie, Wamef, Wabei) = cc3_t3_full(
        F, ERI, t1, t2, no, real_time=real_time, F_ref=F_ref)

    td = t3 - _swap_ac(t3)
    T = 2.0 * t3 - _swap_bc(t3) - _swap_ac(t3)
    X1 = contract("ijkabc,jkbc->ia", td, L[o, o, v, v])
    X2 = contract("ijkabc,kc->ijab", td, Fme)
    X2 += contract("ijkabc,dkbc->ijad", T, Wamef)
    X2 -= contract("ijkabc,jklc->ilab", T, Wmnie)

    r1 = r1 + X1
    r2 = r2 + X2 + X2.transpose(1, 0, 3, 2)
    return r1, r2


# ---------------------------------------------------------------------------
# L3 (full tensor)
# ---------------------------------------------------------------------------

def l3_full(F, L, l1, l2, Fov, Wvovv, Wooov, no):
    """L3 over the whole index space (cctriples.l3_ijk batched)."""
    o, v = slices(no)
    Lo = L[o, o, v, v]
    l3 = contract("ijab,kc->ijkabc", Lo, l1) - contract("ijac,kb->ijkabc", Lo, l1)
    l3 += contract("ikac,jb->ijkabc", Lo, l1) - contract("ikab,jc->ijkabc", Lo, l1)
    l3 += contract("jiba,kc->ijkabc", Lo, l1) - contract("jibc,ka->ijkabc", Lo, l1)
    l3 += contract("kica,jb->ijkabc", Lo, l1) - contract("kicb,ja->ijkabc", Lo, l1)
    l3 += contract("jkbc,ia->ijkabc", Lo, l1) - contract("jkba,ic->ijkabc", Lo, l1)
    l3 += contract("kjcb,ia->ijkabc", Lo, l1) - contract("kjca,ib->ijkabc", Lo, l1)

    l3 += contract("ia,jkbc->ijkabc", Fov, l2) - contract("ib,jkac->ijkabc", Fov, l2)
    l3 += contract("ia,kjcb->ijkabc", Fov, l2) - contract("ic,kjab->ijkabc", Fov, l2)
    l3 += contract("jb,ikac->ijkabc", Fov, l2) - contract("ja,ikbc->ijkabc", Fov, l2)
    l3 += contract("kc,ijab->ijkabc", Fov, l2) - contract("ka,ijcb->ijkabc", Fov, l2)
    l3 += contract("jb,kica->ijkabc", Fov, l2) - contract("jc,kiba->ijkabc", Fov, l2)
    l3 += contract("kc,jiba->ijkabc", Fov, l2) - contract("kb,jica->ijkabc", Fov, l2)

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    l3 += contract("ejab,kice->ijkabc", tW, l2)
    l3 += contract("ekac,jibe->ijkabc", tW, l2)
    l3 += contract("eiba,kjce->ijkabc", tW, l2)
    l3 += contract("eica,jkbe->ijkabc", tW, l2)
    l3 += contract("ekbc,ijae->ijkabc", tW, l2)
    l3 += contract("ejcb,ikae->ijkabc", tW, l2)

    l3 -= contract("eibc,jkea->ijkabc", Wvovv, l2)
    l3 -= contract("eicb,kjea->ijkabc", Wvovv, l2)
    l3 -= contract("ekba,jiec->ijkabc", Wvovv, l2)
    l3 -= contract("ejac,ikeb->ijkabc", Wvovv, l2)
    l3 -= contract("ejca,kieb->ijkabc", Wvovv, l2)
    l3 -= contract("ekab,ijec->ijkabc", Wvovv, l2)

    tW = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("jima,kmcb->ijkabc", tW, l2)
    l3 -= contract("kima,jmbc->ijkabc", tW, l2)
    l3 -= contract("ijmb,kmca->ijkabc", tW, l2)
    l3 -= contract("ikmc,jmba->ijkabc", tW, l2)
    l3 -= contract("kjmb,imac->ijkabc", tW, l2)
    l3 -= contract("jkmc,imab->ijkabc", tW, l2)

    l3 += contract("ijmc,kmba->ijkabc", Wooov, l2)
    l3 += contract("ikmb,jmca->ijkabc", Wooov, l2)
    l3 += contract("kjma,imbc->ijkabc", Wooov, l2)
    l3 += contract("jimc,kmab->ijkabc", Wooov, l2)
    l3 += contract("jkma,imcb->ijkabc", Wooov, l2)
    l3 += contract("kimb,jmac->ijkabc", Wooov, l2)

    return l3 / t3_denom(F, no)


# ---------------------------------------------------------------------------
# Lambda-CC3 extra residual terms (cclambda.py:322-441 batched)
# ---------------------------------------------------------------------------

def cc3_lambda_extra(F, ERI, L, t1, t2, l1, l2, no, real_time=False,
                     F_ref=None):
    o, v = slices(no)
    Fov = build_Fme(F, L, t1, no)
    t3, (Woooo, Wovoo, Wooov, Wvovv, Wvvvo) = cc3_t3_full(
        F, ERI, t1, t2, no, real_time=real_time, F_ref=F_ref)
    Wovov, Wovvo, Wvvvv = cc3_lambda_intermediates(ERI, t1, no)

    Lo = L[o, o, v, v]
    Eo = ERI[o, o, v, v]

    # t3 -> L1 couplings
    Zmndi = contract("lmndef,ilef->mndi", t3, Eo)
    Zmndi -= contract("lmnfed,ilef->mndi", t3, Lo)
    Zmdfa = contract("lmndef,nlea->mdfa", t3, Eo)
    Zmdfa -= contract("lmndfe,nlea->mdfa", t3, Lo)
    Znf = contract("lmde,lmndef->nf", l2, t3 - t3.swapaxes(3, 5))

    Y1 = contract("imdf,mdfa->ia", l2, Zmdfa)
    Y1 += contract("imaf,mf->ia", Lo, Znf)
    Y1 += contract("mnad,mndi->ia", l2, Zmndi)

    # l3 terms
    l3 = l3_full(F, L, l1, l2, Fov, Wvovv, Wooov, no)

    Zbide = contract("jkbc,kijcde->bide", t2, l3)
    Zblad1 = contract("jkbc,kijcad->biad", t2, l3)
    Zblad2 = contract("jkbc,kijcda->biad", t2, l3)
    Zjlma = contract("pkbc,kijcab->pija", t2, l3)
    Zjlid1 = contract("pkbc,kijcbd->pijd", t2, l3)
    Zjlid2 = contract("pkbc,kijcdb->pijd", t2, l3)

    Y1 += contract("bide,deab->ia", Zbide, Wvvvv)
    Y1 += contract("jlma,ijlm->ia", Zjlma, Woooo)
    Y1 -= contract("jlid,jdla->ia", Zjlid1, Wovov)
    Y1 -= contract("jlid,jdal->ia", Zjlid2, Wovvo)
    Y1 -= contract("blad,pdlb->pa", Zblad1, Wovov)
    Y1 -= contract("blad,pdbl->pa", Zblad2, Wovvo)

    Y2 = contract("kijdeb,edak->ijab", l3, Wvvvo)
    Y2 -= contract("kijdab,ldjk->ilab", l3, Wovoo)

    return Y1, Y2 + Y2.transpose(1, 0, 3, 2)


# ---------------------------------------------------------------------------
# CC3 one-electron densities (ccdensity.py:277-346 batched)
# ---------------------------------------------------------------------------

def cc3_onepdm(cc, t1, t2, l1, l2, real_time=False):
    from ..ccdensity import onepdm
    no, nv, nact = cc.no, cc.nv, cc.nact
    # jnp conversion up front: under storage='blocked' the dense
    # Hamiltonian tensors live host-side as numpy arrays
    F, ERI, L = (jnp.asarray(cc.H.F), jnp.asarray(cc.H.ERI),
                 jnp.asarray(cc.H.L))
    o, v = slices(no)

    if jnp.iscomplexobj(t1):
        F = F.astype(t1.dtype)

    Fov = build_Fme(F, L, t1, no)
    t3, (Woooo, Wovoo, Wooov, Wvovv, Wvvvo) = cc3_t3_full(
        F, ERI, t1, t2, no, real_time=real_time, F_ref=cc.H.F)
    l3 = l3_full(F, L, l1, l2, Fov, Wvovv, Wooov, no)

    # Dov
    Zlmdi = contract("ijkdef,kpfe->ijdp", l3, t2)
    Dov = contract("ijkabc,jkbc->ia", t3 - t3.swapaxes(3, 4), l2)
    Dov -= contract("lmdp,lmda->pa", Zlmdi, t2)

    # Doo / Dvv
    Doo = -0.5 * contract("lmiabc,lmjabc->ij", t3, l3)
    Dvv = 0.5 * contract("ijkbdc,ijkadc->ab", t3, l3)

    opdm = onepdm(cc.model, t1, t2, l1, l2, no, nact, Dov_x=Dov)
    opdm_cc3 = jnp.zeros((nact, nact), dtype=t1.dtype)
    opdm_cc3 = opdm_cc3.at[o, o].set(Doo)
    opdm_cc3 = opdm_cc3.at[v, v].set(Dvv)
    return opdm, opdm_cc3


# ---------------------------------------------------------------------------
# Memory-scalable CC3 residuals: per-occupied-index T3 slabs (lax.map)
# ---------------------------------------------------------------------------

def residuals_cc3_scan(F, ERI, L, t1, t2, no, real_time=False, F_ref=None):
    """Same result as residuals_cc3 with O(no v^3) triples working memory:
    the T3 contributions to r1/r2 are accumulated one (i,j) occupied pair
    at a time with lax.fori_loop (cf. triples._t3c_slab_ij)."""
    import jax
    from ..triples import _t3c_slab_ij, slab_layouts

    o, v = slices(no)
    r1, r2 = residuals_ccsd(F, ERI, L, t1, t2, no)
    Fme = build_Fme(F, L, t1, no)
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
    eps = jnp.diagonal(F)
    eps_o, eps_v = eps[:no], eps[no:]

    if real_time:
        V = F - F_ref.astype(F.dtype)
        Vov = V[o, v]

    Lo = L[o, o, v, v]

    def body(ij, carry):
        X1, X2 = carry
        i, j = ij // no, ij % no
        t3 = _t3c_slab_ij(i, j, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
        if real_time:
            # t3_pert slab (cctriples.t3_pert_ijk with i, j fixed)
            tmp = contract("ld,ad->al", Vov, t2[i, j])
            t3p = contract("al,klcb->kabc", tmp, t2)
            denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
                     - eps_v[None, :, None, None]
                     - eps_v[None, None, :, None]
                     - eps_v[None, None, None, :])
            t3 = t3 - t3p / denom
        td = t3 - (t3).swapaxes(1, 3)
        T = 2.0 * t3 - (t3).swapaxes(2, 3) - (t3).swapaxes(1, 3)
        X1 = X1.at[i].add(contract("kabc,kbc->a", td, Lo[j]))
        X2_ij = contract("kabc,kc->ab", td, Fme)
        X2_ij += contract("kabc,dkbc->ad", T, Wamef)
        X2 = X2.at[i, j].add(X2_ij)
        X2 = X2.at[i].add(-contract("kabc,klc->lab", T, Wmnie[j]))
        return (X1, X2)

    X1 = ct_zeros_like(r1)
    X2 = ct_zeros_like(r2)
    X1, X2 = jax.lax.fori_loop(0, no * no, body, (X1, X2))
    r1 = r1 + X1
    r2 = r2 + X2 + X2.transpose(1, 0, 3, 2)
    return r1, r2


def cc3_scan_prep(F, ERI, L, t1, t2, no, real_time=False, F_ref=None):
    """CCSD residual part + T1-dressed intermediates for the row-scan CC3
    residual (jit this; everything returned is at most O(o v^3))."""
    o, v = slices(no)
    r1, r2 = residuals_ccsd(F, ERI, L, t1, t2, no)
    Fme = build_Fme(F, L, t1, no)
    from ..triples import slab_layouts
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
    eps = jnp.diagonal(F)
    if real_time:
        Vov = (F - F_ref.astype(F.dtype))[o, v]
    else:
        Vov = jnp.zeros_like(F[o, v])
    return r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t, eps, L[o, o, v, v], Vov


def _cc3_row_xs(i, carry, Wabei_o, Wmbij_t, t2, eps, Lo, Fme, Wamef, Wmnie,
                Vov, no, real_time):
    """T3 contributions to X1/X2 from one occupied row i (fori over j)."""
    from ..triples import _t3c_slab_ij
    import jax
    eps_o, eps_v = eps[:no], eps[no:]

    def body(j, carry):
        X1, X2 = carry
        t3 = _t3c_slab_ij(i, j, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
        if real_time:
            tmp = contract("ld,ad->al", Vov, t2[i, j])
            t3p = contract("al,klcb->kabc", tmp, t2)
            denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
                     - eps_v[None, :, None, None]
                     - eps_v[None, None, :, None]
                     - eps_v[None, None, None, :])
            t3 = t3 - t3p / denom
        td = t3 - (t3).swapaxes(1, 3)
        T = 2.0 * t3 - (t3).swapaxes(2, 3) - (t3).swapaxes(1, 3)
        X1 = X1.at[i].add(contract("kabc,kbc->a", td, Lo[j]))
        X2_ij = contract("kabc,kc->ab", td, Fme)
        X2_ij += contract("kabc,dkbc->ad", T, Wamef)
        X2 = X2.at[i, j].add(X2_ij)
        X2 = X2.at[i].add(-contract("kabc,klc->lab", T, Wmnie[j]))
        return (X1, X2)

    return jax.lax.fori_loop(0, no, body, carry)


def _cc3_row_xs_chunked(i, carry, Wabei_o, Wmbij_t, t2, eps, Lo, Fme,
                        Wamef, Wmnie, Vov, no, real_time, kc):
    """T3 contributions to X1/X2 from one occupied row i, k-chunked:
    identical arithmetic to _cc3_row_xs with peak slab memory kc*v^3
    instead of no*v^3 (see triples._t3c_chunk_ij; uracil/aug-cc-pVDZ
    (21,191) compile-OOM'd the unchunked row at 27.7 GB)."""
    import jax

    from ..triples import _dslice, _t3c_chunk_ij
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    k0s = jnp.arange(0, no, kc)
    nvW = Wamef.shape[0]

    def body(j, carry):
        X1, X2 = carry

        def chunk(cr, k0):
            x1, x2ij, x2l = cr
            t3 = _t3c_chunk_ij(i, j, k0, kc, Wabei_o, Wmbij_t, t2,
                               eps_o, eps_v)
            if real_time:
                tmp = contract("ld,ad->al", Vov, t2[i, j])
                t3p = contract("al,klcb->kabc", tmp, _dslice(t2, k0, kc))
                eo = jax.lax.dynamic_slice(eps_o, (k0,), (kc,))
                denom = (eps_o[i] + eps_o[j] + eo[:, None, None, None]
                         - eps_v[None, :, None, None]
                         - eps_v[None, None, :, None]
                         - eps_v[None, None, None, :])
                t3 = t3 - t3p / denom
            td = t3 - (t3).swapaxes(1, 3)
            T = 2.0 * t3 - (t3).swapaxes(2, 3) - (t3).swapaxes(1, 3)
            x1 = x1 + contract("kabc,kbc->a", td, _dslice(Lo[j], k0, kc))
            x2ij = x2ij + contract("kabc,kc->ab", td, _dslice(Fme, k0, kc))
            WamefK = jax.lax.dynamic_slice(Wamef, (0, k0, 0, 0),
                                           (nvW, kc, nv, nv))
            x2ij = x2ij + contract("kabc,dkbc->ad", T, WamefK)
            x2l = x2l + contract("kabc,klc->lab", T,
                                 _dslice(Wmnie[j], k0, kc))
            return (x1, x2ij, x2l), 0.0

        z = (jnp.zeros((nv,), t2.dtype), jnp.zeros((nv, nv), t2.dtype),
             jnp.zeros((no, nv, nv), t2.dtype))
        (x1, x2ij, x2l), _ = jax.lax.scan(chunk, z, k0s)
        X1 = X1.at[i].add(x1)
        X2 = X2.at[i, j].add(x2ij)
        X2 = X2.at[i].add(-x2l)
        return (X1, X2)

    return jax.lax.fori_loop(0, no, body, carry)


_cc3_row_xs_jit = None
_cc3_row_xs_chunked_jit = None


def _prep_from_blocks(F, blocks, t1, t2, F_ref, no, real_time):
    from .blocked import blocked_views
    bE, bL = blocked_views(blocks, no)
    return cc3_scan_prep(F, bE, bL, t1, t2, no, real_time, F_ref)


def residuals_cc3_rows(F, ERI, L, t1, t2, no, real_time=False, F_ref=None,
                       blocks=None, dfb=None, nblocks=None):
    """Host-orchestrated CC3 residuals: one short jitted device program per
    occupied row instead of one minutes-long dispatch (see
    triples.t_vikings_scan_core).  Identical result
    to residuals_cc3 / residuals_cc3_scan.  NOT jit-able — use from a
    host-level solver loop only.  dfb= sources the prep from Cholesky/DF
    factors (cc3_scan_prep_df) instead of dense tensors or blocks."""
    global _cc3_row_xs_jit, _cc3_row_xs_chunked_jit
    import jax

    from ..ops.ctensor import CTensor
    if _cc3_row_xs_jit is None:
        _cc3_row_xs_jit = jax.jit(
            _cc3_row_xs, static_argnames=("no", "real_time"),
            donate_argnums=(1,))
    if _cc3_row_xs_chunked_jit is None:
        _cc3_row_xs_chunked_jit = jax.jit(
            _cc3_row_xs_chunked,
            static_argnames=("no", "real_time", "kc"),
            donate_argnums=(1,))
    # past ~2^27 elements of no*v^3 slab the unchunked row's simultaneous
    # slab temps compile-OOM (same wall as triples.t_vikings_scan); the
    # CTensor (RT re/im) path keeps the unchunked row — dynamic_slice
    # does not dispatch through the CTensor contraction layer
    nv_ = t2.shape[-1]
    use_chunked = (no * nv_ ** 3 > 2 ** 27
                   and not isinstance(t2, CTensor)
                   and not isinstance(t1, CTensor))
    F_ref = F if F_ref is None else F_ref
    if dfb is not None:
        prep_d = jax.jit(cc3_scan_prep_df,
                         static_argnames=("no", "real_time", "nblocks"))
        (r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t,
         eps, Lo, Vov) = prep_d(F, dfb, t1, t2, no=no,
                                real_time=real_time, F_ref=F_ref,
                                nblocks=nblocks)
    elif blocks is not None:
        prep_b = jax.jit(_prep_from_blocks,
                         static_argnames=("no", "real_time"))
        (r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t,
         eps, Lo, Vov) = prep_b(F, blocks, t1, t2, F_ref, no=no,
                                real_time=real_time)
    else:
        prep = jax.jit(cc3_scan_prep, static_argnames=("no", "real_time"))
        (r1, r2, Fme, Wamef, Wmnie, Wabei_o, Wmbij_t,
         eps, Lo, Vov) = prep(F, ERI, L, t1, t2, no=no,
                              real_time=real_time, F_ref=F_ref)
    X1 = ct_zeros_like(r1)
    X2 = ct_zeros_like(r2)
    if use_chunked:
        from ..triples import _t_df_kc
        kc = _t_df_kc(no, nv_)
        for i in range(no):
            X1, X2 = _cc3_row_xs_chunked_jit(
                jnp.asarray(i), (X1, X2), Wabei_o, Wmbij_t, t2, eps, Lo,
                Fme, Wamef, Wmnie, Vov, no=no, real_time=real_time, kc=kc)
    else:
        for i in range(no):
            X1, X2 = _cc3_row_xs_jit(jnp.asarray(i), (X1, X2), Wabei_o,
                                     Wmbij_t, t2, eps, Lo, Fme, Wamef,
                                     Wmnie, Vov, no=no, real_time=real_time)
    r1 = r1 + X1
    r2 = r2 + X2 + X2.transpose(1, 0, 3, 2)
    return r1, r2


# ---------------------------------------------------------------------------
# L3 slab (fixed first occupied index) + scanned Lambda-CC3 / CC3 density
# ---------------------------------------------------------------------------

def l3_slab(i, L4, l1, l2, Fov, Wvovv, Wooov, eps_o, eps_v):
    """l3[i] slab (j,k,a,b,c) — l3_full with the first index fixed."""
    Lo = L4
    Loi = Lo[i]
    LoTi = Lo[:, i]
    l2i = l2[i]
    l2Ti = l2[:, i]
    l3 = contract("jab,kc->jkabc", Loi, l1) - contract("jac,kb->jkabc", Loi, l1)
    l3 += contract("kac,jb->jkabc", Loi, l1) - contract("kab,jc->jkabc", Loi, l1)
    l3 += contract("jba,kc->jkabc", LoTi, l1) - contract("jbc,ka->jkabc", LoTi, l1)
    l3 += contract("kca,jb->jkabc", LoTi, l1) - contract("kcb,ja->jkabc", LoTi, l1)
    l3 += contract("jkbc,a->jkabc", Lo, l1[i]) - contract("jkba,c->jkabc", Lo, l1[i])
    l3 += contract("kjcb,a->jkabc", Lo, l1[i]) - contract("kjca,b->jkabc", Lo, l1[i])

    l3 += contract("a,jkbc->jkabc", Fov[i], l2) - contract("b,jkac->jkabc", Fov[i], l2)
    l3 += contract("a,kjcb->jkabc", Fov[i], l2) - contract("c,kjab->jkabc", Fov[i], l2)
    l3 += contract("jb,kac->jkabc", Fov, l2i) - contract("ja,kbc->jkabc", Fov, l2i)
    l3 += contract("kc,jab->jkabc", Fov, l2i) - contract("ka,jcb->jkabc", Fov, l2i)
    l3 += contract("jb,kca->jkabc", Fov, l2Ti) - contract("jc,kba->jkabc", Fov, l2Ti)
    l3 += contract("kc,jba->jkabc", Fov, l2Ti) - contract("kb,jca->jkabc", Fov, l2Ti)

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    l3 += contract("ejab,kce->jkabc", tW, l2Ti)
    l3 += contract("ekac,jbe->jkabc", tW, l2Ti)
    l3 += contract("eba,kjce->jkabc", tW[:, i], l2)
    l3 += contract("eca,jkbe->jkabc", tW[:, i], l2)
    l3 += contract("ekbc,jae->jkabc", tW, l2i)
    l3 += contract("ejcb,kae->jkabc", tW, l2i)

    l3 -= contract("ebc,jkea->jkabc", Wvovv[:, i], l2)
    l3 -= contract("ecb,kjea->jkabc", Wvovv[:, i], l2)
    l3 -= contract("ekba,jec->jkabc", Wvovv, l2Ti)
    l3 -= contract("ejac,keb->jkabc", Wvovv, l2i)
    l3 -= contract("ejca,keb->jkabc", Wvovv, l2Ti)
    l3 -= contract("ekab,jec->jkabc", Wvovv, l2i)

    tW2 = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("jma,kmcb->jkabc", tW2[:, i], l2)
    l3 -= contract("kma,jmbc->jkabc", tW2[:, i], l2)
    l3 -= contract("jmb,kmca->jkabc", tW2[i], l2)
    l3 -= contract("kmc,jmba->jkabc", tW2[i], l2)
    l3 -= contract("kjmb,mac->jkabc", tW2, l2i)
    l3 -= contract("jkmc,mab->jkabc", tW2, l2i)

    l3 += contract("jmc,kmba->jkabc", Wooov[i], l2)
    l3 += contract("kmb,jmca->jkabc", Wooov[i], l2)
    l3 += contract("kjma,mbc->jkabc", Wooov, l2i)
    l3 += contract("jmc,kmab->jkabc", Wooov[:, i], l2)
    l3 += contract("jkma,mcb->jkabc", Wooov, l2i)
    l3 += contract("kmb,jmac->jkabc", Wooov[:, i], l2)

    denom = (eps_o[i] + eps_o[:, None, None, None, None]
             + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None]
             - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    # barrier: materialize the slab once instead of letting XLA remat the
    # ~40-dot assembly into every permuted consumer (see
    # triples._t3c_slab — the same pathology cost the (T) scan 5.6x)
    return jax.lax.optimization_barrier(l3 / denom)


def _l3_slab_ij(i, j, L4, l1, l2, Fov, Wvovv, Wooov, eps_o, eps_v):
    """l3[i, j] slab (k,a,b,c) — l3_full with the first two indices fixed.

    Mechanical fixing of j in every term of l3_slab; the production tiling
    for at-scale Lambda-CC3/density-CC3 (one 4-D slab instead of 5-D)."""
    Lo = L4
    Loi = Lo[i]
    LoTi = Lo[:, i]
    l2i = l2[i]
    l2Ti = l2[:, i]
    l3 = contract("ab,kc->kabc", Loi[j], l1) - contract("ac,kb->kabc", Loi[j], l1)
    l3 += contract("kac,b->kabc", Loi, l1[j]) - contract("kab,c->kabc", Loi, l1[j])
    l3 += contract("ba,kc->kabc", LoTi[j], l1) - contract("bc,ka->kabc", LoTi[j], l1)
    l3 += contract("kca,b->kabc", LoTi, l1[j]) - contract("kcb,a->kabc", LoTi, l1[j])
    l3 += contract("kbc,a->kabc", Lo[j], l1[i]) - contract("kba,c->kabc", Lo[j], l1[i])
    l3 += contract("kcb,a->kabc", Lo[:, j], l1[i]) - contract("kca,b->kabc", Lo[:, j], l1[i])

    l3 += contract("a,kbc->kabc", Fov[i], l2[j]) - contract("b,kac->kabc", Fov[i], l2[j])
    l3 += contract("a,kcb->kabc", Fov[i], l2[:, j]) - contract("c,kab->kabc", Fov[i], l2[:, j])
    l3 += contract("b,kac->kabc", Fov[j], l2i) - contract("a,kbc->kabc", Fov[j], l2i)
    l3 += contract("kc,ab->kabc", Fov, l2i[j]) - contract("ka,cb->kabc", Fov, l2i[j])
    l3 += contract("b,kca->kabc", Fov[j], l2Ti) - contract("c,kba->kabc", Fov[j], l2Ti)
    l3 += contract("kc,ba->kabc", Fov, l2Ti[j]) - contract("kb,ca->kabc", Fov, l2Ti[j])

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    l3 += contract("eab,kce->kabc", tW[:, j], l2Ti)
    l3 += contract("ekac,be->kabc", tW, l2Ti[j])
    l3 += contract("eba,kce->kabc", tW[:, i], l2[:, j])
    l3 += contract("eca,kbe->kabc", tW[:, i], l2[j])
    l3 += contract("ekbc,ae->kabc", tW, l2i[j])
    l3 += contract("ecb,kae->kabc", tW[:, j], l2i)

    l3 -= contract("ebc,kea->kabc", Wvovv[:, i], l2[j])
    l3 -= contract("ecb,kea->kabc", Wvovv[:, i], l2[:, j])
    l3 -= contract("ekba,ec->kabc", Wvovv, l2Ti[j])
    l3 -= contract("eac,keb->kabc", Wvovv[:, j], l2i)
    l3 -= contract("eca,keb->kabc", Wvovv[:, j], l2Ti)
    l3 -= contract("ekab,ec->kabc", Wvovv, l2i[j])

    tW2 = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("ma,kmcb->kabc", tW2[j, i], l2)
    l3 -= contract("kma,mbc->kabc", tW2[:, i], l2[j])
    l3 -= contract("mb,kmca->kabc", tW2[i, j], l2)
    l3 -= contract("kmc,mba->kabc", tW2[i], l2[j])
    l3 -= contract("kmb,mac->kabc", tW2[:, j], l2i)
    l3 -= contract("kmc,mab->kabc", tW2[j], l2i)

    l3 += contract("mc,kmba->kabc", Wooov[i, j], l2)
    l3 += contract("kmb,mca->kabc", Wooov[i], l2[j])
    l3 += contract("kma,mbc->kabc", Wooov[:, j], l2i)
    l3 += contract("mc,kmab->kabc", Wooov[j, i], l2)
    l3 += contract("kma,mcb->kabc", Wooov[j], l2i)
    l3 += contract("kmb,mac->kabc", Wooov[:, i], l2[j])

    denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return jax.lax.optimization_barrier(l3 / denom)  # see l3_slab


def _l3_slab_ij_chunk(i, j, k0, kc, L4, l1, l2, Fov, Wvovv, Wooov,
                      eps_o, eps_v):
    """_l3_slab_ij restricted to a k-window: every k-carrying operand is
    dynamic-sliced, every term otherwise verbatim.  Peak slab memory
    kc*v^3 instead of no*v^3 (the full slab's ~6 simultaneous permutation
    temps compile-OOM the Lambda-CC3 l3 row at uracil/aug-cc-pVDZ)."""
    import jax

    from ..triples import _dslice
    nv = eps_v.shape[0]
    Lo = L4
    Loi = Lo[i]
    LoTi = Lo[:, i]
    l2i = l2[i]
    l2Ti = l2[:, i]
    sl = lambda x: _dslice(x, k0, kc)
    l1k, Fovk = sl(l1), sl(Fov)
    Loik, LoTik = sl(Loi), sl(LoTi)
    Lojk, LoTjk = sl(Lo[j]), sl(Lo[:, j])
    l2k = sl(l2)
    l2ik, l2Tik = sl(l2i), sl(l2Ti)
    l2jk, l2Tjk = sl(l2[j]), sl(l2[:, j])

    l3 = contract("ab,kc->kabc", Loi[j], l1k) - contract("ac,kb->kabc", Loi[j], l1k)
    l3 += contract("kac,b->kabc", Loik, l1[j]) - contract("kab,c->kabc", Loik, l1[j])
    l3 += contract("ba,kc->kabc", LoTi[j], l1k) - contract("bc,ka->kabc", LoTi[j], l1k)
    l3 += contract("kca,b->kabc", LoTik, l1[j]) - contract("kcb,a->kabc", LoTik, l1[j])
    l3 += contract("kbc,a->kabc", Lojk, l1[i]) - contract("kba,c->kabc", Lojk, l1[i])
    l3 += contract("kcb,a->kabc", LoTjk, l1[i]) - contract("kca,b->kabc", LoTjk, l1[i])

    l3 += contract("a,kbc->kabc", Fov[i], l2jk) - contract("b,kac->kabc", Fov[i], l2jk)
    l3 += contract("a,kcb->kabc", Fov[i], l2Tjk) - contract("c,kab->kabc", Fov[i], l2Tjk)
    l3 += contract("b,kac->kabc", Fov[j], l2ik) - contract("a,kbc->kabc", Fov[j], l2ik)
    l3 += contract("kc,ab->kabc", Fovk, l2i[j]) - contract("ka,cb->kabc", Fovk, l2i[j])
    l3 += contract("b,kca->kabc", Fov[j], l2Tik) - contract("c,kba->kabc", Fov[j], l2Tik)
    l3 += contract("kc,ba->kabc", Fovk, l2Ti[j]) - contract("kb,ca->kabc", Fovk, l2Ti[j])

    tW = 2.0 * Wvovv - Wvovv.swapaxes(2, 3)
    tWk = jax.lax.dynamic_slice(tW, (0, k0, 0, 0),
                                (nv, kc, nv, nv))
    Wvk = jax.lax.dynamic_slice(Wvovv, (0, k0, 0, 0),
                                (nv, kc, nv, nv))
    l3 += contract("eab,kce->kabc", tW[:, j], l2Tik)
    l3 += contract("ekac,be->kabc", tWk, l2Ti[j])
    l3 += contract("eba,kce->kabc", tW[:, i], l2Tjk)
    l3 += contract("eca,kbe->kabc", tW[:, i], l2jk)
    l3 += contract("ekbc,ae->kabc", tWk, l2i[j])
    l3 += contract("ecb,kae->kabc", tW[:, j], l2ik)

    l3 -= contract("ebc,kea->kabc", Wvovv[:, i], l2jk)
    l3 -= contract("ecb,kea->kabc", Wvovv[:, i], l2Tjk)
    l3 -= contract("ekba,ec->kabc", Wvk, l2Ti[j])
    l3 -= contract("eac,keb->kabc", Wvovv[:, j], l2ik)
    l3 -= contract("eca,keb->kabc", Wvovv[:, j], l2Tik)
    l3 -= contract("ekab,ec->kabc", Wvk, l2i[j])

    tW2 = 2.0 * Wooov - Wooov.swapaxes(0, 1)
    l3 -= contract("ma,kmcb->kabc", tW2[j, i], l2k)
    l3 -= contract("kma,mbc->kabc", sl(tW2[:, i]), l2[j])
    l3 -= contract("mb,kmca->kabc", tW2[i, j], l2k)
    l3 -= contract("kmc,mba->kabc", sl(tW2[i]), l2[j])
    l3 -= contract("kmb,mac->kabc", sl(tW2[:, j]), l2i)
    l3 -= contract("kmc,mab->kabc", sl(tW2[j]), l2i)

    l3 += contract("mc,kmba->kabc", Wooov[i, j], l2k)
    l3 += contract("kmb,mca->kabc", sl(Wooov[i]), l2[j])
    l3 += contract("kma,mbc->kabc", sl(Wooov[:, j]), l2i)
    l3 += contract("mc,kmab->kabc", Wooov[j, i], l2k)
    l3 += contract("kma,mcb->kabc", sl(Wooov[j]), l2i)
    l3 += contract("kmb,mac->kabc", sl(Wooov[:, i]), l2[j])

    eo = jax.lax.dynamic_slice(eps_o, (k0,), (kc,))
    denom = (eps_o[i] + eps_o[j] + eo[:, None, None, None]
             - eps_v[None, :, None, None]
             - eps_v[None, None, :, None]
             - eps_v[None, None, None, :])
    return jax.lax.optimization_barrier(l3 / denom)  # see l3_slab


def _cc3_t3_slab(i, F, Wabei_o, Wmbij_t, t2, eps_o, eps_v, real_time,
                 F_ref, no):
    """Takes the occupied-major layouts from triples.slab_layouts."""
    from ..triples import _t3c_slab
    t3 = _t3c_slab(i, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
    if real_time:
        o, v = slices(no)
        V = F - F_ref.astype(F.dtype)
        tmp = contract("ld,jad->jal", V[o, v], t2[i])
        t3p = contract("jal,klcb->jkabc", tmp, t2)
        denom = (eps_o[i] + eps_o[:, None, None, None, None]
                 + eps_o[None, :, None, None, None]
                 - eps_v[None, None, :, None, None]
                 - eps_v[None, None, None, :, None]
                 - eps_v[None, None, None, None, :])
        t3 = jax.lax.optimization_barrier(t3 - t3p / denom)
    return t3


def _cc3_t3_slab_pair(i, j, Vov, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                      real_time):
    """T1-dressed T3[i, j] slab (k,a,b,c), with the RT perturbation term."""
    from ..triples import _t3c_slab_ij
    t3 = _t3c_slab_ij(i, j, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
    if real_time:
        tmp = contract("ld,ad->al", Vov, t2[i, j])
        t3p = contract("al,klcb->kabc", tmp, t2)
        denom = (eps_o[i] + eps_o[j] + eps_o[:, None, None, None]
                 - eps_v[None, :, None, None]
                 - eps_v[None, None, :, None]
                 - eps_v[None, None, None, :])
        t3 = jax.lax.optimization_barrier(t3 - t3p / denom)
    return t3


def cc3_lambda_intermediates_df(dfb, t1, no):
    """cc3_lambda_intermediates from factors.  Wmbje/Wmbej are pure
    t1-dressed integrals (rank-1 factor assemblies); Wabef is EXACTLY the
    dressed bilinear sum_P Bd_ae[P,a,e] Bd_ae[P,b,f] (the t1.t1 bilinear
    of the dense form is the product of the two dressings), so the v^4
    tensor stays implicit — the caller contracts against Bd_ae."""
    Boo, Bov, Bvv = dfb.Boo, dfb.Bov, dfb.Bvv
    Bvo = Bov.transpose(0, 2, 1)
    Dmi = contract("Pmf,if->Pmi", Bov, t1)
    Cbi = contract("Pbf,if->Pbi", Bvv, t1)
    Sae = contract("ma,Pme->Pae", t1, Bov)
    Bd_ae = Bvv - Sae

    # Wmbje[mbje] = <mb|je> + t1[jf]<mb|fe> - t1[nb]<mn|je> - bilinear
    #   <mb|je> = (mj|be); t1[jf]<mb|fe> = t1[jf](mf|be) -> Dmi.Bvv;
    #   t1[nb]<mn|je> = t1[nb](mj|ne) and the bilinear both dress the
    #   (b,e) factor with -t1[nb]Bov[P,n,e] — i.e. exactly Bd_ae
    Wmbje = contract("Pmj,Pbe->mbje", Boo + Dmi, Bd_ae)

    # Wmbej[mbej] = <mb|ej> + t1[jf]<mb|ef> - t1[nb]<mn|ej> - bilinear
    #   <mb|ej> = (me|bj); t1[jf]<mb|ef> = t1[jf](me|bf) -> Bov.Cbi;
    #   t1[nb]<mn|ej> = t1[nb](me|nj) -> Bov.(Boo-dressed);
    #   bilinear: t1[jf]t1[nb](me|nf) -> Bov.(Dmi-dressed)
    Fbj = contract("nb,Pnj->Pbj", t1, Boo + Dmi)
    Wmbej = contract("Pme,Pbj->mbej", Bov, Bvo + Cbi - Fbj)
    return Wmbje, Wmbej, Bd_ae


def cc3_lambda_prep_df(F, dfb, t1, t2, no, real_time=False, F_ref=None):
    """cc3_lambda_prep from factors: Wvvvv's slot carries Bd_ae (the
    implicit dressed-bilinear form) instead of the v^4 tensor."""
    from .dfccsd import _eri_oovv

    o, v = slices(no)
    e = _eri_oovv(dfb)
    Lo = 2.0 * e - e.swapaxes(2, 3)
    Fov = F[o, v] + contract("nf,mnef->me", t1, Lo)
    Wmnij, Wmbij_t, Wmnie, Wamef, Wabei_o = cc3_intermediates_df(
        dfb, t1, no, scan_layout=True)
    Wovov, Wovvo, Bd_ae = cc3_lambda_intermediates_df(dfb, t1, no)
    eps = jnp.diagonal(F)
    if real_time:
        Vov = (F - F_ref.astype(F.dtype))[o, v]
    else:
        Vov = jnp.zeros_like(F[o, v])
    return (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo,
            Bd_ae, eps, Lo, e, Vov)


def cc3_lambda_prep(F, ERI, L, t1, t2, no, real_time=False, F_ref=None):
    """Intermediates for the row-scanned Lambda-CC3 extras (jit this)."""
    o, v = slices(no)
    Fov = build_Fme(F, L, t1, no)
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
    Wovov, Wovvo, Wvvvv = cc3_lambda_intermediates(ERI, t1, no)
    eps = jnp.diagonal(F)
    if real_time:
        Vov = (F - F_ref.astype(F.dtype))[o, v]
    else:
        Vov = jnp.zeros_like(F[o, v])
    return (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo,
            Wvvvv, eps, L[o, o, v, v], ERI[o, o, v, v], Vov)


@partial(jax.jit, static_argnames=("no", "real_time"), donate_argnums=(1,))
def _cc3_lambda_row_t3(l, carry, Wabei_o, Wmbij_t, t2, l2, eps, Lo, Eo,
                       Vov, no, real_time):
    """t3-side Z accumulations for one leading index l (fori over m)."""
    eps_o, eps_v = eps[:no], eps[no:]

    def body(m, carry):
        Zmndi, Zmdfa, Znf = carry
        s = _cc3_t3_slab_pair(l, m, Vov, Wabei_o, Wmbij_t, t2, eps_o,
                              eps_v, real_time)   # [n,d,e,f]
        Zmndi = Zmndi.at[m].add(contract("ndef,pef->ndp", s, Eo[:, l])
                                - contract("nfed,pef->ndp", s, Lo[:, l]))
        Zmdfa = Zmdfa.at[m].add(contract("ndef,nea->dfa", s, Eo[:, l])
                                - contract("ndfe,nea->dfa", s, Lo[:, l]))
        Znf = Znf + contract("de,ndef->nf", l2[l, m],
                             s - (s).swapaxes(1, 3))
        return (Zmndi, Zmdfa, Znf)

    return jax.lax.fori_loop(0, no, body, carry)


@partial(jax.jit, static_argnames=("no", "real_time", "kc"), donate_argnums=(1,))
def _cc3_lambda_row_t3_chunked(l, carry, Wabei_o, Wmbij_t, t2, l2, eps,
                               Lo, Eo, Vov, no, real_time, kc):
    """_cc3_lambda_row_t3 with the slab's free occupied index n windowed
    into kc-chunks: peak slab memory kc*v^3 instead of no*v^3 (the
    unchunked row compile-OOM'd at 18.8 GB at uracil/aug-cc-pVDZ)."""
    from ..triples import _dslice, _t3c_chunk_ij
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    k0s = jnp.arange(0, no, kc)

    def body(m, carry):
        Zmndi, Zmdfa, Znf = carry

        def chunk(cr, k0):
            zndp, zdfa, znf = cr
            s = _t3c_chunk_ij(l, m, k0, kc, Wabei_o, Wmbij_t, t2,
                              eps_o, eps_v)
            if real_time:
                tmp = contract("ld,ad->al", Vov, t2[l, m])
                t3p = contract("al,klcb->kabc", tmp, _dslice(t2, k0, kc))
                eo = jax.lax.dynamic_slice(eps_o, (k0,), (kc,))
                denom = (eps_o[l] + eps_o[m] + eo[:, None, None, None]
                         - eps_v[None, :, None, None]
                         - eps_v[None, None, :, None]
                         - eps_v[None, None, None, :])
                s = s - t3p / denom
            # s = the n-window of the (n,d,e,f) slab
            c_ndp = (contract("ndef,pef->ndp", s, Eo[:, l])
                     - contract("nfed,pef->ndp", s, Lo[:, l]))
            zndp = jax.lax.dynamic_update_slice(
                zndp, jax.lax.dynamic_slice(
                    zndp, (k0, 0, 0), (kc, nv, no)) + c_ndp, (k0, 0, 0))
            zdfa = zdfa + (contract("ndef,nea->dfa", s,
                                    _dslice(Eo[:, l], k0, kc))
                           - contract("ndfe,nea->dfa", s,
                                      _dslice(Lo[:, l], k0, kc)))
            c_nf = contract("de,ndef->nf", l2[l, m], s - (s).swapaxes(1, 3))
            znf = jax.lax.dynamic_update_slice(
                znf, jax.lax.dynamic_slice(znf, (k0, 0), (kc, nv)) + c_nf,
                (k0, 0))
            return (zndp, zdfa, znf), 0.0

        z = (jnp.zeros((no, nv, no), t2.dtype),
             jnp.zeros((nv, nv, nv), t2.dtype),
             jnp.zeros((no, nv), t2.dtype))
        (zndp, zdfa, znf), _ = jax.lax.scan(chunk, z, k0s)
        Zmndi = Zmndi.at[m].add(zndp)
        Zmdfa = Zmdfa.at[m].add(zdfa)
        Znf = Znf + znf
        return (Zmndi, Zmdfa, Znf)

    return jax.lax.fori_loop(0, no, body, carry)


@partial(jax.jit, static_argnames="no", donate_argnums=(1,))
def _cc3_lambda_row_l3(k, carry, t2, l1, l2, Fov, Wamef, Wmnie, Wabei_o,
                       Wmbij_t, eps, Lo, no):
    """l3-side Z/Y2 accumulations for one leading index k (fori over i)."""
    eps_o, eps_v = eps[:no], eps[no:]

    def body(i, carry):
        (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2) = carry
        s = _l3_slab_ij(k, i, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o, eps_v)
        # s[j, c, d, e] == l3_full[k, i, j, c, d, e]
        tk = t2[:, k]
        Zbide = Zbide.at[:, i].add(contract("jbc,jcde->bde", tk, s))
        Zblad1 = Zblad1.at[:, i].add(contract("jbc,jcad->bad", tk, s))
        Zblad2 = Zblad2.at[:, i].add(contract("jbc,jcda->bad", tk, s))
        Zjlma = Zjlma.at[:, i].add(contract("pbc,jcab->pja", tk, s))
        Zjlid1 = Zjlid1.at[:, i].add(contract("pbc,jcbd->pjd", tk, s))
        Zjlid2 = Zjlid2.at[:, i].add(contract("pbc,jcdb->pjd", tk, s))
        Y2 = Y2.at[i].add(contract("jdeb,eda->jab", s, Wabei_o[k])
                          - contract("jdab,jld->lab", s, Wmbij_t[:, k]))
        return (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2)

    return jax.lax.fori_loop(0, no, body, carry)


@partial(jax.jit, static_argnames=("no", "kc"), donate_argnums=(1,))
def _cc3_lambda_row_l3_chunked(k, carry, t2, l1, l2, Fov, Wamef, Wmnie,
                               Wabei_o, Wmbij_t, eps, Lo, no, kc):
    """_cc3_lambda_row_l3 with the slab's free occupied index windowed
    into kc-chunks (see _l3_slab_ij_chunk): identical accumulations with
    peak slab memory kc*v^3."""
    from ..triples import _dslice
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    k0s = jnp.arange(0, no, kc)

    def body(i, carry):
        (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2) = carry
        tk = t2[:, k]

        def chunk(cr, k0):
            (zbde, zbad1, zbad2, zpja, zpjd1, zpjd2, yjab, ylab) = cr
            s = _l3_slab_ij_chunk(k, i, k0, kc, Lo, l1, l2, Fov, Wamef,
                                  Wmnie, eps_o, eps_v)
            tkw = _dslice(tk, k0, kc)
            zbde = zbde + contract("jbc,jcde->bde", tkw, s)
            zbad1 = zbad1 + contract("jbc,jcad->bad", tkw, s)
            zbad2 = zbad2 + contract("jbc,jcda->bad", tkw, s)

            def wadd(buf, c):
                return jax.lax.dynamic_update_slice(
                    buf, jax.lax.dynamic_slice(
                        buf, (0, k0, 0), (buf.shape[0], kc, buf.shape[2]))
                    + c, (0, k0, 0))

            zpja = wadd(zpja, contract("pbc,jcab->pja", tk, s))
            zpjd1 = wadd(zpjd1, contract("pbc,jcbd->pjd", tk, s))
            zpjd2 = wadd(zpjd2, contract("pbc,jcdb->pjd", tk, s))
            yjab = jax.lax.dynamic_update_slice(
                yjab, jax.lax.dynamic_slice(yjab, (k0, 0, 0), (kc, nv, nv))
                + contract("jdeb,eda->jab", s, Wabei_o[k]), (k0, 0, 0))
            ylab = ylab + contract("jdab,jld->lab", s,
                                   _dslice(Wmbij_t[:, k], k0, kc))
            return (zbde, zbad1, zbad2, zpja, zpjd1, zpjd2,
                    yjab, ylab), 0.0

        D = t2.dtype
        z0 = (jnp.zeros((nv, nv, nv), D), jnp.zeros((nv, nv, nv), D),
              jnp.zeros((nv, nv, nv), D), jnp.zeros((no, no, nv), D),
              jnp.zeros((no, no, nv), D), jnp.zeros((no, no, nv), D),
              jnp.zeros((no, nv, nv), D), jnp.zeros((no, nv, nv), D))
        (zbde, zbad1, zbad2, zpja, zpjd1, zpjd2,
         yjab, ylab), _ = jax.lax.scan(chunk, z0, k0s)
        Zbide = Zbide.at[:, i].add(zbde)
        Zblad1 = Zblad1.at[:, i].add(zbad1)
        Zblad2 = Zblad2.at[:, i].add(zbad2)
        Zjlma = Zjlma.at[:, i].add(zpja)
        Zjlid1 = Zjlid1.at[:, i].add(zpjd1)
        Zjlid2 = Zjlid2.at[:, i].add(zpjd2)
        Y2 = Y2.at[i].add(yjab - ylab)
        return (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2)

    return jax.lax.fori_loop(0, no, body, carry)


def cc3_lambda_extra_rows(F, ERI, L, t1, t2, l1, l2, no, real_time=False,
                          F_ref=None, blocks=None, dfb=None):
    """Host-orchestrated Lambda-CC3 extras: one short jitted device program
    per leading occupied index, per-(i,j) 4-D slabs (the 5-D slabs of
    cc3_lambda_extra_scan are 8.6 GB each at (32,128)).  Identical result.
    NOT jit-able.  dfb= sources the prep from Cholesky/DF factors: the
    only v^4 consumer (the Y1 Wvvvv dot below) then contracts the
    dressed-bilinear factors instead."""
    F_ref = F if F_ref is None else F_ref
    if dfb is not None:
        prep_d = jax.jit(cc3_lambda_prep_df,
                         static_argnames=("no", "real_time"))
        (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Wvvvv,
         eps, Lo, Eo, Vov) = prep_d(F, dfb, t1, t2, no=no,
                                    real_time=real_time, F_ref=F_ref)
    elif blocks is not None:
        from .blocked import blocked_views
        prep_b = jax.jit(
            lambda F_, bl, t1_, t2_, Fr: cc3_lambda_prep(
                F_, *blocked_views(bl, no), t1_, t2_, no, real_time, Fr))
        (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Wvvvv,
         eps, Lo, Eo, Vov) = prep_b(F, blocks, t1, t2, F_ref)
    else:
        prep = jax.jit(cc3_lambda_prep, static_argnames=("no", "real_time"))
        (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Wvvvv,
         eps, Lo, Eo, Vov) = prep(F, ERI, L, t1, t2, no=no,
                                  real_time=real_time, F_ref=F_ref)
    nv = t2.shape[2]
    D = t2.dtype

    from ..ops.ctensor import CTensor

    def _zeros(shape):
        z = jnp.zeros(shape, D)
        return CTensor(z, jnp.zeros(shape, D)) if isinstance(t2, CTensor) else z

    carry = (_zeros((no, no, nv, no)), _zeros((no, nv, nv, nv)),
             _zeros((no, nv)))
    # past ~2^27 elements of no*v^3 slab the unchunked t3-side row
    # compile-OOMs (18.8 GB at uracil/aug-cc-pVDZ); the CTensor (RT)
    # path keeps the unchunked row (dynamic_slice does not dispatch
    # through the CTensor layer)
    chunked = (no * nv ** 3 > 2 ** 27 and not isinstance(t2, CTensor)
               and not isinstance(l2, CTensor))
    if chunked:
        from ..triples import _t_df_kc
        kc = _t_df_kc(no, nv)
        for l in range(no):
            carry = _cc3_lambda_row_t3_chunked(
                jnp.asarray(l), carry, Wabei_o, Wmbij_t, t2, l2, eps, Lo,
                Eo, Vov, no=no, real_time=real_time, kc=kc)
    else:
        for l in range(no):
            carry = _cc3_lambda_row_t3(jnp.asarray(l), carry, Wabei_o,
                                       Wmbij_t, t2, l2, eps, Lo, Eo, Vov,
                                       no=no, real_time=real_time)
    Zmndi, Zmdfa, Znf = carry

    Y1 = contract("imdf,mdfa->ia", l2, Zmdfa)
    Y1 += contract("imaf,mf->ia", Lo, Znf)
    Y1 += contract("mnad,mndi->ia", l2, Zmndi)

    carry = (_zeros((nv, no, nv, nv)), _zeros((nv, no, nv, nv)),
             _zeros((nv, no, nv, nv)), _zeros((no, no, no, nv)),
             _zeros((no, no, no, nv)), _zeros((no, no, no, nv)),
             _zeros((no, no, nv, nv)))
    if chunked:
        for k in range(no):
            carry = _cc3_lambda_row_l3_chunked(
                jnp.asarray(k), carry, t2, l1, l2, Fov, Wamef, Wmnie,
                Wabei_o, Wmbij_t, eps, Lo, no=no, kc=kc)
    else:
        for k in range(no):
            carry = _cc3_lambda_row_l3(jnp.asarray(k), carry, t2, l1, l2,
                                       Fov, Wamef, Wmnie, Wabei_o, Wmbij_t,
                                       eps, Lo, no=no)
    Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = carry

    if dfb is not None:
        # Wvvvv[deab] = sum_P Bd[P,d,a] Bd[P,e,b] stays implicit: two
        # dots with a (naux, o, v) largest intermediate (Wvvvv here
        # holds Bd_ae, cc3_lambda_prep_df)
        K = contract("bide,Peb->Pid", Zbide, Wvvvv)
        Y1 += contract("Pid,Pda->ia", K, Wvvvv)
    else:
        Y1 += contract("bide,deab->ia", Zbide, Wvvvv)
    Y1 += contract("jlma,ijlm->ia", Zjlma, Wmnij)
    Y1 -= contract("jlid,jdla->ia", Zjlid1, Wovov)
    Y1 -= contract("jlid,jdal->ia", Zjlid2, Wovvo)
    Y1 -= contract("blad,pdlb->pa", Zblad1, Wovov)
    Y1 -= contract("blad,pdbl->pa", Zblad2, Wovvo)

    return Y1, Y2 + Y2.transpose(1, 0, 3, 2)


def cc3_lambda_extra_scan(F, ERI, L, t1, t2, l1, l2, no, real_time=False,
                          F_ref=None):
    """Same result as cc3_lambda_extra with O(no^2 v^3) triples memory:
    lax.fori_loop over the leading occupied index of the T3/L3 slabs."""
    import jax
    o, v = slices(no)
    Fov = build_Fme(F, L, t1, no)
    Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
    Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
    Wovov, Wovvo, Wvvvv = cc3_lambda_intermediates(ERI, t1, no)
    eps = jnp.diagonal(F)
    eps_o, eps_v = eps[:no], eps[no:]
    Lo = L[o, o, v, v]
    Eo = ERI[o, o, v, v]
    nv = t2.shape[2]

    # --- t3-side accumulations (loop over l = leading index of t3)
    def body_t3(l, carry):
        Zmndi, Zmdfa, Znf = carry
        t3 = _cc3_t3_slab(l, F, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                          real_time, F_ref, no)
        Zmndi += contract("mndef,pef->mndp", t3, Eo[:, l])
        Zmndi -= contract("mnfed,pef->mndp", t3, Lo[:, l])
        Zmdfa += contract("mndef,nea->mdfa", t3, Eo[:, l])
        Zmdfa -= contract("mndfe,nea->mdfa", t3, Lo[:, l])
        Znf += contract("mde,mndef->nf", l2[l], t3 - t3.swapaxes(2, 4))
        return (Zmndi, Zmdfa, Znf)

    Zmndi = jnp.zeros((no, no, nv, no), dtype=t2.dtype)
    Zmdfa = jnp.zeros((no, nv, nv, nv), dtype=t2.dtype)
    Znf = jnp.zeros((no, nv), dtype=t2.dtype)
    Zmndi, Zmdfa, Znf = jax.lax.fori_loop(0, no, body_t3,
                                          (Zmndi, Zmdfa, Znf))

    Y1 = contract("imdf,mdfa->ia", l2, Zmdfa)
    Y1 += contract("imaf,mf->ia", Lo, Znf)
    Y1 += contract("mnad,mndi->ia", l2, Zmndi)

    # --- l3-side accumulations (loop over k = leading index of l3)
    def body_l3(k, carry):
        Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = carry
        l3k = l3_slab(k, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o, eps_v)
        # l3k[i, j, c, d, e] == l3_full[k, i, j, c, d, e]
        Zbide += contract("jbc,ijcde->bide", t2[:, k], l3k)
        Zblad1 += contract("jbc,ijcad->biad", t2[:, k], l3k)
        Zblad2 += contract("jbc,ijcda->biad", t2[:, k], l3k)
        Zjlma += contract("pbc,ijcab->pija", t2[:, k], l3k)
        Zjlid1 += contract("pbc,ijcbd->pijd", t2[:, k], l3k)
        Zjlid2 += contract("pbc,ijcdb->pijd", t2[:, k], l3k)
        Y2 += contract("ijdeb,eda->ijab", l3k, Wabei_o[k])
        Y2 -= contract("ijdab,jld->ilab", l3k, Wmbij_t[:, k])
        return (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2)

    D = t2.dtype
    carry = (jnp.zeros((nv, no, nv, nv), D), jnp.zeros((nv, no, nv, nv), D),
             jnp.zeros((nv, no, nv, nv), D), jnp.zeros((no, no, no, nv), D),
             jnp.zeros((no, no, no, nv), D), jnp.zeros((no, no, no, nv), D),
             jnp.zeros((no, no, nv, nv), D))
    Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = jax.lax.fori_loop(
        0, no, body_l3, carry)

    Y1 += contract("bide,deab->ia", Zbide, Wvvvv)
    Y1 += contract("jlma,ijlm->ia", Zjlma, Wmnij)
    Y1 -= contract("jlid,jdla->ia", Zjlid1, Wovov)
    Y1 -= contract("jlid,jdal->ia", Zjlid2, Wovvo)
    Y1 -= contract("blad,pdlb->pa", Zblad1, Wovov)
    Y1 -= contract("blad,pdbl->pa", Zblad2, Wovvo)

    return Y1, Y2 + Y2.transpose(1, 0, 3, 2)


def cc3_lambda_extra_scan_df(F, dfb, t1, t2, l1, l2, no, real_time=False,
                             F_ref=None):
    """cc3_lambda_extra_scan over Cholesky/DF factors: df prep
    (cc3_lambda_prep_df) + the same T3/L3 slab fori_loops, with the one
    v^4 consumer (the Y1 Wvvvv dot) contracted against the dressed
    bilinear factors.  Jittable; CTensor-safe carries for the RT
    re/im-split mode."""
    import jax
    from ..ops.ctensor import CTensor

    F_ref = F if F_ref is None else F_ref
    (Fov, Wmnij, Wmnie, Wamef, Wabei_o, Wmbij_t, Wovov, Wovvo, Bd,
     eps, Lo, Eo, Vov) = cc3_lambda_prep_df(F, dfb, t1, t2, no,
                                            real_time=real_time,
                                            F_ref=F_ref)
    eps_o, eps_v = eps[:no], eps[no:]
    nv = t2.shape[2]
    D = t2.dtype

    def _zeros(shape):
        z = jnp.zeros(shape, D)
        return (CTensor(z, jnp.zeros(shape, D))
                if isinstance(t2, CTensor) else z)

    def body_t3(l, carry):
        Zmndi, Zmdfa, Znf = carry
        t3 = _cc3_t3_slab(l, F, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                          real_time, F_ref, no)
        Zmndi += contract("mndef,pef->mndp", t3, Eo[:, l])
        Zmndi -= contract("mnfed,pef->mndp", t3, Lo[:, l])
        Zmdfa += contract("mndef,nea->mdfa", t3, Eo[:, l])
        Zmdfa -= contract("mndfe,nea->mdfa", t3, Lo[:, l])
        Znf += contract("mde,mndef->nf", l2[l], t3 - t3.swapaxes(2, 4))
        return (Zmndi, Zmdfa, Znf)

    carry = (_zeros((no, no, nv, no)), _zeros((no, nv, nv, nv)),
             _zeros((no, nv)))
    Zmndi, Zmdfa, Znf = jax.lax.fori_loop(0, no, body_t3, carry)

    Y1 = contract("imdf,mdfa->ia", l2, Zmdfa)
    Y1 += contract("imaf,mf->ia", Lo, Znf)
    Y1 += contract("mnad,mndi->ia", l2, Zmndi)

    def body_l3(k, carry):
        Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = carry
        l3k = l3_slab(k, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o, eps_v)
        Zbide += contract("jbc,ijcde->bide", t2[:, k], l3k)
        Zblad1 += contract("jbc,ijcad->biad", t2[:, k], l3k)
        Zblad2 += contract("jbc,ijcda->biad", t2[:, k], l3k)
        Zjlma += contract("pbc,ijcab->pija", t2[:, k], l3k)
        Zjlid1 += contract("pbc,ijcbd->pijd", t2[:, k], l3k)
        Zjlid2 += contract("pbc,ijcdb->pijd", t2[:, k], l3k)
        Y2 += contract("ijdeb,eda->ijab", l3k, Wabei_o[k])
        Y2 -= contract("ijdab,jld->ilab", l3k, Wmbij_t[:, k])
        return (Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2)

    carry = (_zeros((nv, no, nv, nv)), _zeros((nv, no, nv, nv)),
             _zeros((nv, no, nv, nv)), _zeros((no, no, no, nv)),
             _zeros((no, no, no, nv)), _zeros((no, no, no, nv)),
             _zeros((no, no, nv, nv)))
    Zbide, Zblad1, Zblad2, Zjlma, Zjlid1, Zjlid2, Y2 = jax.lax.fori_loop(
        0, no, body_l3, carry)

    # implicit Wvvvv[deab] = sum_P Bd[P,d,a] Bd[P,e,b]
    K = contract("bide,Peb->Pid", Zbide, Bd)
    Y1 += contract("Pid,Pda->ia", K, Bd)
    Y1 += contract("jlma,ijlm->ia", Zjlma, Wmnij)
    Y1 -= contract("jlid,jdla->ia", Zjlid1, Wovov)
    Y1 -= contract("jlid,jdal->ia", Zjlid2, Wovvo)
    Y1 -= contract("blad,pdlb->pa", Zblad1, Wovov)
    Y1 -= contract("blad,pdbl->pa", Zblad2, Wovvo)

    return Y1, Y2 + Y2.transpose(1, 0, 3, 2)


# slab elements above which the pdm row assembles t3/l3 by k-chunked
# builds (tests lower it to force multi-chunk assembly at tiny size)
_PDM_CHUNK_ELEMS = 3e7


def _t3c_pair_chunk(i, j, k0, kc, Vov, Wabei_o, Wmbij_t, t2, eps_o,
                    eps_v, real_time):
    """T1-dressed T3[i, j] k-window (K,a,b,c), with the RT term."""
    from ..triples import _dslice, _t3c_chunk_ij
    t3 = _t3c_chunk_ij(i, j, k0, kc, Wabei_o, Wmbij_t, t2, eps_o, eps_v)
    if real_time:
        tmp = contract("ld,ad->al", Vov, t2[i, j])
        t3p = contract("al,klcb->kabc", tmp, _dslice(t2, k0, kc))
        eo = jax.lax.dynamic_slice(eps_o, (k0,), (kc,))
        denom = (eps_o[i] + eps_o[j] + eo[:, None, None, None]
                 - eps_v[None, :, None, None]
                 - eps_v[None, None, :, None]
                 - eps_v[None, None, None, :])
        t3 = jax.lax.optimization_barrier(t3 - t3p / denom)
    return t3


@partial(jax.jit, static_argnames=("no", "kc", "real_time"),
         donate_argnums=(1,))
def _cc3_onepdm_row(i, carry, Wabei_o, Wmbij_t, t2, l1, l2, Fov, Wamef,
                    Wmnie, eps, Lo, Vov, no, kc, real_time):
    """One leading-index row of the CC3 one-pdm triples corrections.

    The t3/l3 pair slabs are ASSEMBLED by k-chunked builds into full
    (no, v^3) buffers: the one-shot 12-dot + 30-dot builds pile up ~26
    slab-size buffers, over 16 GB at uracil/aug-cc-pVDZ (21,191);
    chunked assembly caps the
    build pile at kc*v^3 while the four consumers read the two
    naturally-stored full slabs.  kc == no (one chunk) reproduces the
    original single-pass build at small sizes."""
    eps_o, eps_v = eps[:no], eps[no:]
    nv = eps_v.shape[0]
    nk = no // kc

    def body(j, carry):
        Dov, Zlmdi, Doo, Dvv = carry

        def kbody(c, slabs):
            t3f, l3f = slabs
            k0 = c * kc
            t3c = _t3c_pair_chunk(i, j, k0, kc, Vov, Wabei_o, Wmbij_t,
                                  t2, eps_o, eps_v, real_time)
            l3c = _l3_slab_ij_chunk(i, j, k0, kc, Lo, l1, l2, Fov,
                                    Wamef, Wmnie, eps_o, eps_v)
            t3f = jax.lax.dynamic_update_slice(t3f, t3c, (k0, 0, 0, 0))
            l3f = jax.lax.dynamic_update_slice(l3f, l3c, (k0, 0, 0, 0))
            return (t3f, l3f)

        z = jnp.zeros((no, nv, nv, nv), t2.dtype)
        t3, l3 = jax.lax.fori_loop(0, nk, kbody, (z, jnp.zeros_like(z)))
        Zlmdi = Zlmdi.at[i, j].add(contract("kdef,kpfe->dp", l3, t2))
        Dov = Dov.at[i].add(
            contract("kabc,kbc->a", t3 - (t3).swapaxes(1, 2), l2[j]))
        # this pair is (lead, m); the free occupied axes of t3/l3 are p/q
        Doo = Doo - 0.5 * contract("pabc,qabc->pq", t3, l3)
        Dvv = Dvv + 0.5 * contract("kbdc,kadc->ab", t3, l3)
        return (Dov, Zlmdi, Doo, Dvv)

    return jax.lax.fori_loop(0, no, body, carry)


def cc3_onepdm_rows(cc, t1, t2, l1, l2, real_time=False):
    """cc3_onepdm with per-(i,j) 4-D slabs, one short jitted device program
    per leading occupied index.  Identical to cc3_onepdm; the production
    path at scale (the 5-D slabs of cc3_onepdm_scan are 8.6 GB each at
    (32,128)).  NOT jit-able."""
    from ..ccdensity import onepdm
    no, nv, nact = cc.no, cc.nv, cc.nact
    o, v = slices(no)
    F = jnp.asarray(cc.H.F)
    if jnp.iscomplexobj(t1):
        F = F.astype(t1.dtype)
    storage = getattr(cc, "storage", "full")
    blocks = cc.blocks if storage == "blocked" else None
    if storage == "df":
        # factor-sourced prep (the onepdm rows never touch Wvvvv)
        prep_d = jax.jit(cc3_lambda_prep_df,
                         static_argnames=("no", "real_time"))
        (Fov, _, Wmnie, Wamef, Wabei_o, Wmbij_t, _, _, _, eps, Lo, _,
         Vov) = prep_d(F, cc.dfb, t1, t2, no=no, real_time=real_time,
                       F_ref=jnp.asarray(cc.H.F))
    elif blocks is not None:
        from .blocked import blocked_views

        def _prep(F_, bl, t1_, t2_, Fr):
            bE, bL = blocked_views(bl, no)
            return cc3_lambda_prep(F_, bE, bL, t1_, t2_, no, real_time, Fr)

        (Fov, _, Wmnie, Wamef, Wabei_o, Wmbij_t, _, _, _, eps, Lo, _,
         Vov) = jax.jit(_prep)(F, blocks, t1, t2, jnp.asarray(cc.H.F))
    else:
        ERI = jnp.asarray(cc.H.ERI)
        L = jnp.asarray(cc.H.L)
        prep = jax.jit(cc3_lambda_prep, static_argnames=("no", "real_time"))
        (Fov, _, Wmnie, Wamef, Wabei_o, Wmbij_t, _, _, _, eps, Lo, _,
         Vov) = prep(F, ERI, L, t1, t2, no=no, real_time=real_time,
                     F_ref=jnp.asarray(cc.H.F))
    D = t1.dtype
    from ..models.dfccsd import _div_chunk
    kc = _div_chunk(no, max(1, int(_PDM_CHUNK_ELEMS // nv ** 3)))
    carry = (jnp.zeros((no, nv), D), jnp.zeros((no, no, nv, no), D),
             jnp.zeros((no, no), D), jnp.zeros((nv, nv), D))
    for i in range(no):
        carry = _cc3_onepdm_row(jnp.asarray(i), carry, Wabei_o,
                                Wmbij_t, t2, l1, l2, Fov, Wamef, Wmnie,
                                eps, Lo, Vov, no=no, kc=kc,
                                real_time=real_time)
    Dov, Zlmdi, Doo, Dvv = carry
    Dov = Dov - contract("lmdp,lmda->pa", Zlmdi, t2)

    opdm = onepdm(cc.model, t1, t2, l1, l2, no, nact, Dov_x=Dov)
    opdm_cc3 = jnp.zeros((nact, nact), dtype=t1.dtype)
    opdm_cc3 = opdm_cc3.at[o, o].set(Doo)
    opdm_cc3 = opdm_cc3.at[v, v].set(Dvv)
    return opdm, opdm_cc3


def cc3_onepdm_scan(cc, t1, t2, l1, l2, real_time=False):
    """cc3_onepdm with O(no^2 v^3) triples memory (fori_loop over slabs).
    Jittable; under storage='df' the prep assembles from the factors
    (cc3_lambda_prep_df) — the traceable path the RT-CC3 df lagrangian
    needs."""
    import jax
    from ..ccdensity import onepdm
    no, nv, nact = cc.no, cc.nv, cc.nact
    o, v = slices(no)
    F = jnp.asarray(cc.H.F)
    if jnp.iscomplexobj(t1):
        F = F.astype(t1.dtype)
    if getattr(cc, "storage", "full") == "df":
        (Fov, _, Wmnie, Wamef, Wabei_o, Wmbij_t, _, _, _, eps, Lo, _,
         _) = cc3_lambda_prep_df(F, cc.dfb, t1, t2, no,
                                 real_time=real_time,
                                 F_ref=jnp.asarray(cc.H.F))
    else:
        # jnp conversion up front: under storage='blocked' the dense
        # Hamiltonian tensors live host-side as numpy arrays
        ERI, L = jnp.asarray(cc.H.ERI), jnp.asarray(cc.H.L)
        Fov = build_Fme(F, L, t1, no)
        Wmnij, Wmbij, Wmnie, Wamef, Wabei = cc3_intermediates(ERI, t1, no)
        Wabei_o, Wmbij_t = slab_layouts(Wabei, Wmbij)
        eps = jnp.diagonal(F)
        Lo = L[o, o, v, v]
    eps_o, eps_v = eps[:no], eps[no:]
    D = t1.dtype

    def body(i, carry):
        Dov, Zlmdi, Doo, Dvv = carry
        t3 = _cc3_t3_slab(i, F, Wabei_o, Wmbij_t, t2, eps_o, eps_v,
                          real_time, cc.H.F, no)
        l3 = l3_slab(i, Lo, l1, l2, Fov, Wamef, Wmnie, eps_o, eps_v)
        Zlmdi = Zlmdi.at[i].set(contract("jkdef,kpfe->jdp", l3, t2))
        Dov = Dov.at[i].set(
            contract("jkabc,jkbc->a", t3 - t3.swapaxes(2, 3), l2))
        # Doo[p,q] = -0.5 sum_{i(lead),m,abc} t3f[i,m,p,...] l3f[i,m,q,...]
        Doo = Doo - 0.5 * contract("mpabc,mqabc->pq", t3, l3)
        Dvv = Dvv + 0.5 * contract("jkbdc,jkadc->ab", t3, l3)
        return (Dov, Zlmdi, Doo, Dvv)

    carry = (jnp.zeros((no, nv), D), jnp.zeros((no, no, nv, no), D),
             jnp.zeros((no, no), D), jnp.zeros((nv, nv), D))
    Dov, Zlmdi, Doo, Dvv = jax.lax.fori_loop(0, no, body, carry)
    Dov = Dov - contract("lmdp,lmda->pa", Zlmdi, t2)

    opdm = onepdm(cc.model, t1, t2, l1, l2, no, nact, Dov_x=Dov)
    opdm_cc3 = jnp.zeros((nact, nact), dtype=t1.dtype)
    opdm_cc3 = opdm_cc3.at[o, o].set(Doo)
    opdm_cc3 = opdm_cc3.at[v, v].set(Dvv)
    return opdm, opdm_cc3
