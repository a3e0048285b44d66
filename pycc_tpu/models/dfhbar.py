"""DF (Cholesky-factorized) similarity-transformed Hamiltonian.

The dense HBAR (cchbar.py, rebuilt from /root/reference/pycc/cchbar.py)
stores three blocks that cannot exist at scale: Hvvvv (v^4), Hvovv and
Hvvvo (o v^3).  At (o,v)=(32,512) those are 17-275 GB — the reference
delivers its post-convergence property surface only as far as the dense
tensors reach (/root/reference/pycc/cchbar.py:170-327).  This module keeps
every block LARGER than o^2 v^2 implicit in the Cholesky factors:

    ERI[p,q,r,s] = <pq|rs> = (pr|qs) = sum_P B[P,p,r] B[P,q,s]

with two t1-dressed factor variants covering the pure-t1 parts of the big
blocks exactly:

    Bd_ae[P,a,e] = Bvv[P,a,e] - sum_n t1[n,a] Bov[P,n,e]
        => Hvovv[amef] = sum_P Bd_ae[P,a,e] Bov[P,m,f]          (exact)
        => Hvvvv[abef] = sum_P Bd_ae[P,a,e] Bd_ae[P,b,f]
                         + sum_mn t2[mnab->mnef...] t2 term      (CCSD)
    Bd_mi[P,m,i] = Boo[P,m,i] + sum_f t1[i,f] Bov[P,m,f]
        => Hooov[mnie] = sum_P Bd_mi[P,m,i] Bov[P,n,e]          (exact)

Every consumer of the implicit blocks (Lambda residuals, EOM sigmas,
response residuals) is re-derived so the largest intermediate is
(naux, o, v) or o^2 v^2 — each function documents the contraction it
replaces with its dense form (cclambda.py / cceom.py line references).
All equalities are oracle-tested against the dense path with exact
factors in tests/test_019_dfhbar.py.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.contract import contract
from .dfccsd import (DFERI, _eri_oooo, _eri_ooov, _eri_oovv, _eri_ovoo,
                     _eri_ovov, _eri_ovvo, _tau)


class DFHBar(NamedTuple):
    """HBAR over Cholesky factors: explicit blocks <= o^3 v, plus the
    dressed factors that generate the implicit Hvovv/Hvvvo/Hvvvv."""
    Hov: jnp.ndarray      # (o, v)
    Hvv: jnp.ndarray      # (v, v)
    Hoo: jnp.ndarray      # (o, o)
    Hoooo: jnp.ndarray    # (o, o, o, o)
    Hooov: jnp.ndarray    # (o, o, o, v)
    Hovvo: jnp.ndarray    # (o, v, v, o)
    Hovov: jnp.ndarray    # (o, v, o, v)
    Hovoo: jnp.ndarray    # (o, v, o, o)
    df: DFERI             # undressed factors
    Bd_ae: jnp.ndarray    # (naux, v, v) creation-virtual dressed
    Bd_mi: jnp.ndarray    # (naux, o, o) annihilation-occupied dressed


def dress_factors(df, t1):
    """The two t1 dressings (see module docstring)."""
    Bd_ae = df.Bvv - contract("na,Pne->Pae", t1, df.Bov)
    Bd_mi = df.Boo + contract("if,Pmf->Pmi", t1, df.Bov)
    return Bd_ae, Bd_mi


# ---------------------------------------------------------------------------
# generic blocked particle-particle ladder application
# ---------------------------------------------------------------------------

def _ladder_nblocks(nv, naux, max_elems=2 ** 26):
    blk = max(1, int(max_elems // (nv * nv * nv)))
    nblk = max(1, -(-nv // blk))
    while nv % nblk:
        nblk += 1
    return nblk


def ladder_apply(BL, BR, x2, nblocks=None):
    """sum_ef x2[ijef] W[abef],  W[abef] = sum_P BL[P,a,e] BR[P,b,f],
    assembled in a-blocks under lax.scan (peak blk*v^3, never v^4).
    Generalizes models/dfccsd.ladder_df's inner loop to arbitrary
    left/right factors (ground-state tau ladder, Lambda/EOM Hvvvv
    ladders, C1*t1 rank-1 ladders).

    Representation-uniform: CTensor factors/amplitudes (the RT re/im
    split) flow through the same scan via ct_dot/ct_contract."""
    from ..ops.ctensor import CTensor, ct_dot

    naux, nva, ne = BL.shape
    no = x2.shape[0]
    nv = BR.shape[2]
    if nblocks is None:
        nblocks = _ladder_nblocks(nva, naux)
    if nblocks == 1:
        W = contract("Pae,Pbf->abef", BL, BR)
        return contract("ijef,abef->ijab", x2, W)
    blk = -(-nva // nblocks)
    if nblocks * blk != nva:
        pad = jnp.zeros((naux, nblocks * blk - nva, ne), BL.dtype)
        if isinstance(BL, CTensor):
            BL = CTensor(jnp.concatenate([BL.re, pad], axis=1),
                         jnp.concatenate([BL.im, pad], axis=1))
        else:
            BL = jnp.concatenate([BL, pad], axis=1)
    BLs = BL.reshape(naux, nblocks, blk, ne).transpose(1, 0, 2, 3)
    x2f = x2.reshape(no * no, ne, nv)
    BR2 = BR.reshape(naux, nv * nv)

    def body(carry, BL_blk):
        W = ct_dot(BL_blk.reshape(naux, blk * ne).T, BR2,
                   preferred_element_type=x2.dtype)
        W = W.reshape(blk, ne, nv, nv)   # (a, e, b, f)
        z = contract("xef,aebf->xab", x2f, W)
        return carry, z

    _, zs = jax.lax.scan(body, 0, BLs)
    z = zs.transpose(1, 0, 2, 3).reshape(no, no, nblocks * blk, nv)
    return z[:, :, :nva, :]


def hvvvv_x2_df(dfh, t2, x2, nblocks=None):
    """0.5 * sum_ef x2[ijef] Hvvvv[efab]  (no pair symmetrization) —
    the DF form of 0.5 * models/ccsd.vvvv_contract_efab(x2, Hvvvv) used by
    the Lambda r2 (cclambda.py:85) and EOM sigma2 (cceom.py:80-82) ladders.

    Hvvvv[efab] = sum_P Bd_ae[P,e,a] Bd_ae[P,f,b]   (pure-t1 part, exact)
                + sum_mn t2[mnef] <mn|ab>           (CCSD tau-residue)
    The second line: the dressed bilinear t1.t1 term equals the t1 part of
    the dense tau contraction (cchbar.py:99-105), leaving only the pure-t2
    piece, which reduces to o^4-intermediate contractions."""
    BL = _ea_layout(dfh.Bd_ae)
    out = 0.5 * ladder_apply(BL, BL, x2, nblocks=nblocks)
    X = contract("ijef,mnef->ijmn", x2, t2)
    return out + 0.5 * contract("ijmn,mnab->ijab", X, _eri_oovv(dfh.df))


def _ea_layout(Bd_ae):
    """Bd_ae[P,a,e] -> [P,e,a]: ladder_apply wants the OUTPUT index first
    (W[abef] = BL[P,a,e] BR[P,b,f]); Hvvvv[efab] contracts x2 over its
    first two (creation) indices, so the output a,b are the annihilation
    columns of Bd_ae."""
    return Bd_ae.transpose(0, 2, 1)


# ---------------------------------------------------------------------------
# the tau * <mb|ef> one-time o^3 v block for Hovoo
# ---------------------------------------------------------------------------

def _tau_ovvv_ovoo(df, tau):
    """sum_ef tau[ijef] <mb|ef>  ->  (m, b, i, j); <mb|ef> = (me|bf).
    m-mapped so the largest live array is (naux, o^2, v) per trip."""

    def one_m(Bm):                             # Bm: (naux, v) row of Bov
        Z = contract("Pe,ijef->Pijf", Bm, tau)         # (naux, o, o, v)
        return contract("Pijf,Pbf->bij", Z, df.Bvv)    # (v, o, o)

    out = jax.lax.map(one_m, jnp.moveaxis(df.Bov, 1, 0))  # (o, v, o, o)
    return out


# ---------------------------------------------------------------------------
# HBAR build (CCSD forms; cchbar.py:81-164)
# ---------------------------------------------------------------------------

def build_hbar_df(F, dfb, t1, t2, no, model="CCSD"):
    """All <= o^3 v HBAR blocks from factors, equal to the dense
    build_hbar(model, ...) blocks exactly (given exact factors), plus the
    dressed factors for the implicit blocks.  model='CC2' produces the
    CC2 forms (cchbar.py:97-137): the doubles blocks are pure t1-dressed
    integrals — which is exactly what the dressed-factor bilinears give —
    plus bare-Fock t2 terms in Hovoo/Hvvvo.  CCD shares the CCSD forms
    (they coincide at t1 = 0)."""
    o, v = slice(0, no), slice(no, None)
    df = dfb
    cc2 = model == "CC2"
    tau = _tau(t1, t2)
    Bd_ae, Bd_mi = dress_factors(df, t1)

    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    eri_ooov = _eri_ooov(df)
    Looov = 2.0 * eri_ooov - contract("Pme,Pni->mnie", df.Bov, df.Boo)

    Hov = F[o, v] + contract("nf,mnef->me", t1, Loovv)

    # Hvv: the ovvv term sum_mf t1[mf] L[amef], L[amef] = 2(ae|mf)-(af|me)
    dP = contract("Pmf,mf->P", df.Bov, t1)
    Cam = contract("Paf,mf->Pam", df.Bvv, t1)
    ovvv_t = (2.0 * contract("P,Pae->ae", dP, df.Bvv)
              - contract("Pam,Pme->ae", Cam, df.Bov))
    Hvv = (F[v, v]
           - contract("me,ma->ae", F[o, v], t1)
           + ovvv_t
           - contract("mnfa,mnfe->ae", tau, Loovv))

    Hoo = (F[o, o]
           + contract("ie,me->mi", t1, F[o, v])
           + contract("ne,mnie->mi", t1, Looov)
           + contract("inef,mnef->mi", tau, Loovv))

    eri_oooo = _eri_oooo(df)
    tmp = contract("je,mnie->mnij", t1, eri_ooov)
    Hoooo = eri_oooo + tmp + tmp.transpose(1, 0, 3, 2)
    if cc2:
        # t1.t1 bilinear instead of tau (cchbar.py:98-100)
        Hoooo = Hoooo + contract("jf,mnif->mnij", t1,
                                 contract("ie,mnef->mnif", t1, eri_oovv))
    else:
        Hoooo = Hoooo + contract("ijef,mnef->mnij", tau, eri_oovv)

    # Hooov[mnie] = sum_P Bd_mi[P,m,i] Bov[P,n,e]  (exact; see module doc)
    Hooov = contract("Pmi,Pne->mnie", Bd_mi, df.Bov)

    eri_ovvo = _eri_ovvo(df)
    eri_ovov = _eri_ovov(df)
    eri_ovoo = _eri_ovoo(df)
    eri_oovo = contract("Pme,Pni->mnei", df.Bov, df.Boo)  # <mn|ei> = (me|ni)

    # Hovvo[mbej] (cchbar.py:110-119): t1 ovvv term via rank-1 dressing
    Cbj = contract("Pbf,jf->Pbj", df.Bvv, t1)
    Hovvo = (eri_ovvo
             + contract("Pme,Pbj->mbej", df.Bov, Cbj)
             - contract("nb,mnej->mbej", t1, eri_oovo))
    Dmj = contract("Pmf,jf->Pmj", df.Bov, t1)
    Hovov = (eri_ovov
             + contract("Pmj,Pbe->mbje", Dmj, df.Bvv)
             - contract("nb,mnje->mbje", t1, eri_ooov))
    if not cc2:
        Hovvo = (Hovvo
                 - contract("jnfb,mnef->mbej", tau, eri_oovv)
                 + contract("njfb,mnef->mbej", t2, Loovv))
        Hovov = Hovov - contract("jnfb,nmef->mbje", tau, eri_oovv)

    if cc2:
        # Hovoo CC2 (cchbar.py:130-137): dressed integral + bare-Fock t2;
        # the three t1 dressings assemble from the rank-1 factors above
        Hovoo = (eri_ovoo
                 + contract("me,ijeb->mbij", F[o, v], t2)
                 - contract("nb,mnij->mbij", t1, Hoooo)
                 + contract("Pmi,Pbj->mbij", Dmj, Cbj)
                 + contract("Pmi,Pbj->mbij", df.Boo, Cbj)
                 + contract("Pmi,Pjb->mbij", Dmj, df.Bov))
    else:
        # Hovoo[mbij] (cchbar.py:152-164)
        Hovoo = (eri_ovoo
                 + contract("me,ijeb->mbij", Hov, t2)
                 - contract("nb,mnij->mbij", t1, Hoooo)
                 + _tau_ovvv_ovoo(df, tau))
        tmpo = eri_ovov - contract("infb,mnfe->mbie", t2, eri_oovv)
        Hovoo = (Hovoo
                 - contract("ineb,nmje->mbij", t2, eri_ooov)
                 - contract("jneb,mnie->mbij", t2, eri_ooov)
                 + contract("njeb,mnie->mbij", t2, Looov)
                 + contract("je,mbie->mbij", t1, tmpo))
        tmpv = (contract("Pjb,Pme->bmje", df.Bov, df.Bov)
                - contract("jnfb,mnef->bmje", t2, eri_oovv)
                + contract("njfb,mnef->bmje", t2, Loovv))
        Hovoo = Hovoo + contract("ie,bmje->mbij", t1, tmpv)

    return DFHBar(Hov=Hov, Hvv=Hvv, Hoo=Hoo, Hoooo=Hoooo, Hooov=Hooov,
                  Hovvo=Hovvo, Hovov=Hovov, Hovoo=Hovoo,
                  df=df, Bd_ae=Bd_ae, Bd_mi=Bd_mi)


# ---------------------------------------------------------------------------
# implicit-Hvovv consumers (Hvovv[amef] = sum_P Bd_ae[P,a,e] Bov[P,m,f])
# ---------------------------------------------------------------------------

def zvv_c1_hvovv(dfh, C1):
    """2 * 'amef,mf->ae' - 'amfe,mf->ae' over Hvovv (cceom.py:51-52 /
    ccwfn Fae pattern with HBAR dressing)."""
    s = contract("Pmf,mf->P", dfh.df.Bov, C1)
    # second term: C1[mf] Hvovv[amfe] = C1[mf] Bd[P,a,f] Bov[P,m,e]
    E = contract("Paf,mf->Pam", dfh.Bd_ae, C1)
    return (2.0 * contract("P,Pae->ae", s, dfh.Bd_ae)
            - contract("Pam,Pme->ae", E, dfh.df.Bov))


def r1_c2_hvovv(dfh, C2):
    """2 * 'imef,amef->ia' - 'imef,amfe->ia' (cceom sigma1, cceom.py:34-35).
    Largest intermediate (naux, o, v)."""
    Z = contract("imef,Pmf->Pie", C2, dfh.df.Bov)
    Z2 = contract("imef,Pme->Pif", C2, dfh.df.Bov)
    return (2.0 * contract("Pie,Pae->ia", Z, dfh.Bd_ae)
            - contract("Pif,Paf->ia", Z2, dfh.Bd_ae))


def r1_gvv_hvovv(dfh, Gvv):
    """-2 'ef,eifa->ia' + 'ef,eiaf->ia' over Hvovv (cclambda.py:61-62)."""
    s = contract("ef,Pef->P", Gvv, dfh.Bd_ae)
    T = contract("ef,Pea->Pfa", Gvv, dfh.Bd_ae)
    return (-2.0 * contract("P,Pia->ia", s, dfh.df.Bov)
            + contract("Pfa,Pif->ia", T, dfh.df.Bov))


def r2_l1_hvovv(dfh, l1):
    """2 'ie,ejab->ijab' - 'ie,ejba->ijab' over Hvovv (cclambda.py:72-73)."""
    A = contract("ie,Pea->Pia", l1, dfh.Bd_ae)
    t1_ = contract("Pia,Pjb->ijab", A, dfh.df.Bov)
    A2 = contract("ie,Peb->Pib", l1, dfh.Bd_ae)
    t2_ = contract("Pib,Pja->ijab", A2, dfh.df.Bov)
    return 2.0 * t1_ - t2_


# ---------------------------------------------------------------------------
# implicit-Hvvvo consumers
# ---------------------------------------------------------------------------

def r1_l2_hvvvo(dfh, t1, t2, l2, Hov, nblocks=None, cc2=False):
    """'imef,efam->ia' over the FULL CCSD Hvvvo (cclambda.py:51) without
    materializing the o v^3 block.  Renaming Hvvvo[abei] -> [e,f,a,m],
    each of the nine dense terms (cchbar.py:138-150) reduces to factor
    assemblies with <= (naux,o,v) / o^2 v^2 intermediates; the derivation
    is in this function term by term.

    cc2=True evaluates the CC2 Hvvvo (cchbar.py:124-130) instead: bare
    F[o,v] in (2) (pass it as Hov), the t1.t1 bilinear for tau in (4),
    the t1-dressed-only Hvvvv in (3), bare integrals in (8)/(9), and no
    t2 ring terms (5)-(7)."""
    df = dfh.df
    Bov, Boo, Bvv = df.Bov, df.Boo, df.Bvv
    tau = _tau(t1, t2)

    # (1) <ef|am> = (ea|fm):  Z[P,i,e] = l2[imef] Bov[P,m,f]
    Z = contract("imef,Pmf->Pie", l2, Bov)
    out = contract("Pie,Pea->ia", Z, Bvv)
    # (2) -Hov[na] t2[nmef]   (CC2: F[o,v] instead of Hov)
    out -= contract("in,na->ia", contract("imef,nmef->in", l2, t2), Hov)
    # (3) t1[mg] Hvvvv[efag]:
    #     factor part: E[P,m,f] = t1[mg] Bd_ae[P,f,g];
    #     Z3[P,i,e] = l2[imef] E[P,m,f]; out += Z3[P,i,e] Bd_ae[P,e,a]
    E = contract("mg,Pfg->Pmf", t1, dfh.Bd_ae)
    Z3 = contract("imef,Pmf->Pie", l2, E)
    out += contract("Pie,Pea->ia", Z3, dfh.Bd_ae)
    if not cc2:
        #  t2 residue of Hvvvv: X[i,g,m?] -> via o^3 v intermediates
        l2t = contract("imef,mg->igef", l2, t1)
        X = contract("igef,pqef->igpq", l2t, t2)
        Y = contract("igpq,Pqg->Pip", X, Bov)
        out += contract("Pip,Ppa->ia", Y, Bov)
    # (4) tau[pqef] <pq|am> = (pa|qm)   (CC2: t1[pe] t1[qf] bilinear)
    if cc2:
        lt4 = contract("imef,qf->imeq", l2, t1)
        T4 = contract("imeq,pe->ipqm", lt4, t1)
    else:
        T4 = contract("imef,pqef->ipqm", l2, tau)
    Y4 = contract("ipqm,Pqm->Pip", T4, Boo)
    out += contract("Pip,Ppa->ia", Y4, Bov)
    if cc2:
        # (8') -t1[pf] <ep|am>, <ep|am> = (ea|pm)
        lt = contract("imef,pf->imep", l2, t1)
        W8 = contract("imep,Ppm->Pie", lt, Boo)
        out -= contract("Pie,Pea->ia", W8, Bvv)
        # (9') -t1[pe] <fp|ma>, <fp|ma> = (fm|pa)
        ZT = contract("pe,Pie->Pip", t1, Z)
        out -= contract("Pip,Ppa->ia", ZT, Bov)
        return out
    # (5) -t2[mpge] <fp|ga> = (fg|pa):  U[i,f,p,g] = l2[imef] t2[mpge]
    U = contract("imef,mpge->ifpg", l2, t2)
    W5 = contract("ifpg,Pfg->Pip", U, Bvv)
    out -= contract("Pip,Ppa->ia", W5, Bov)
    # (6) -t2[mpgf] <ep|ag> = (ea|pg):  V[i,e,p,g] = l2[imef] t2[mpgf]
    V = contract("imef,mpgf->iepg", l2, t2)
    W6 = contract("iepg,Ppg->Pie", V, Bov)
    out -= contract("Pie,Pea->ia", W6, Bvv)
    # (7) +t2[pmgf] L[epag] = 2(ea|pg) - (eg|pa)
    Vp = contract("imef,pmgf->iepg", l2, t2)
    W7 = contract("iepg,Ppg->Pie", Vp, Bov)
    out += 2.0 * contract("Pie,Pea->ia", W7, Bvv)
    W7b = contract("iepg,Peg->Pip", Vp, Bvv)
    out -= contract("Pip,Ppa->ia", W7b, Bov)
    # (8) -t1[pf] tmp1[e,p,a,m], tmp1 = <ep|am> - t2[mqge] <qp|ga>
    #     <ep|am> = (ea|pm):
    lt = contract("imef,pf->imep", l2, t1)
    W8 = contract("imep,Ppm->Pie", lt, Boo)
    out -= contract("Pie,Pea->ia", W8, Bvv)
    #     + t2[mqge] <pq|ga>, <pq|ga> = (pg|qa): pair p with g, q with a
    K8 = contract("imef,mqge->ifqg", l2, t2)
    C8 = contract("pf,Ppg->Pfg", t1, Bov)
    M8 = contract("ifqg,Pfg->Piq", K8, C8)
    out += contract("Piq,Pqa->ia", M8, Bov)
    # (9) -t1[pe] tmp2[f,p,m,a],
    #     tmp2 = <fp|ma> - t2[mngf] <pn|ga> + t2[nmgf] L[pnga]
    #     <fp|ma> = (fm|pa):  ZT[P,i,p] = t1[pe] Z[P,i,e]   (Z from (1))
    ZT = contract("pe,Pie->Pip", t1, Z)
    out -= contract("Pip,Ppa->ia", ZT, Bov)
    #     + t2[mngf] <pn|ga>, <pn|ga> = (pa|ng): pair n with g, p with a
    l2t1 = contract("imef,pe->imfp", l2, t1)
    X9 = contract("imfp,mngf->ipng", l2t1, t2)
    W9 = contract("ipng,Png->Pip", X9, Bov)
    out += contract("Pip,Ppa->ia", W9, Bov)
    #     - t2[nmgf] L[pnag], L[pnag] = 2(pa|ng) - (pg|na):
    X9b = contract("imfp,nmgf->ipng", l2t1, t2)
    W9b = contract("ipng,Png->Pip", X9b, Bov)
    out -= 2.0 * contract("Pip,Ppa->ia", W9b, Bov)
    W9c = contract("ipng,Ppg->Pin", X9b, Bov)
    out += contract("Pin,Pna->ia", W9c, Bov)
    return out


def s2_c1_hvvvo(dfh, t1, t2, C1, Hov, nblocks=None):
    """'ie,abej->ijab' over the FULL CCSD Hvvvo (cceom.py:69-71) without
    the o v^3 block; o^2 v^2 output.  Same nine dense terms
    (cchbar.py:138-150), contracted over e with C1 first."""
    df = dfh.df
    Bov, Boo, Bvv = df.Bov, df.Boo, df.Bvv
    tau = _tau(t1, t2)
    Eia = contract("ie,Pae->Pia", C1, Bvv)          # C1-dressed vv factor
    CB = contract("ie,Pme->Pim", C1, Bov)

    # (1) (ae|bj)
    out = contract("Pia,Pjb->ijab", Eia, Bov)
    # (2) -C1[ie] Hov[me] t2[mjab]
    out -= contract("im,mjab->ijab", contract("ie,me->im", C1, Hov), t2)
    # (3) +C1[ie] t1[jf] Hvvvv[abef]: rank-1 ladder + t2 residue
    #     Hvvvv[abef] = Bd[P,a,e] Bd[P,b,f] + t2[mnab] <mn|ef>
    x2 = contract("ie,jf->ijef", C1, t1)
    EiaD = contract("ie,Pae->Pia", C1, dfh.Bd_ae)
    TjbD = contract("jf,Pbf->Pjb", t1, dfh.Bd_ae)
    out += contract("Pia,Pjb->ijab", EiaD, TjbD)
    X = contract("ijef,mnef->ijmn", x2, _eri_oovv(df))
    out += contract("ijmn,mnab->ijab", X, t2)
    # (4) +C1[ie] tau[mnab] <mn|ej> = (me|nj)
    G4 = contract("Pim,Pnj->ijmn", CB, Boo)
    out += contract("ijmn,mnab->ijab", G4, tau)
    # (5) -C1[ie] t2[jmfa] <bm|fe> = (bf|me)
    D5 = contract("Pim,Pbf->imbf", CB, Bvv)
    out -= contract("jmfa,imbf->ijab", t2, D5)
    # (6) -C1[ie] t2[jmfb] <am|ef> = (ae|mf)
    D6 = contract("Pia,Pmf->iamf", Eia, Bov)
    out -= contract("jmfb,iamf->ijab", t2, D6)
    # (7) +C1[ie] t2[mjfb] L[amef],  L[amef] = 2(ae|mf) - (af|me)
    D7 = contract("Pim,Paf->imaf", CB, Bvv)
    out += contract("mjfb,iamf->ijab", t2, 2.0 * D6)
    out -= contract("mjfb,imaf->ijab", t2, D7)
    # (8) -t1[mb] (C1[ie]<am|ej> - C1[ie] t2[jnfa] <mn|fe>)
    #     <am|ej> = (ae|mj); <mn|fe> = (mf|ne): pair m-f, n-e
    G8 = contract("Pia,Pmj->iamj", Eia, Boo)
    CB2 = contract("ie,Pne->Pin", C1, Bov)
    K8b = contract("Pin,Pmf->imnf", CB2, Bov)    # C1[ie] <mn|fe>
    T8 = G8 - contract("jnfa,imnf->iamj", t2, K8b)
    out -= contract("mb,iamj->ijab", t1, T8)
    K8 = contract("Pim,Pnf->imnf", CB, Bov)      # C1[ie] <mn|ef>

    # (9) -t1[ma] (C1[ie]<bm|je> - C1[ie] t2[jnfb] <mn|ef>
    #              + C1[ie] t2[njfb] L[mnef])
    #     <bm|je> = (bj|me); <mn|ef> = (me|nf); L[mnef] = 2(me|nf)-(mf|ne)
    G9 = contract("Pim,Pjb->imjb", CB, Bov)
    T9 = G9 - contract("jnfb,imnf->imjb", t2, K8)
    # L part: C1[ie] L[mnef] = 2 C1[ie]<mn|ef> - C1[ie]<mn|fe>
    #   = 2 K8 - K8b
    T9 = T9 + contract("njfb,imnf->imjb", t2, 2.0 * K8 - K8b)
    out -= contract("ma,imjb->ijab", t1, T9)
    return out


def hvvvv_x2_abef_df(dfh, t2, x2, nblocks=None):
    """0.5 * sum_ef x2[ijef] Hvvvv[abef] — the DF form of
    0.5 * models/ccsd.vvvv_contract(x2, Hvvvv) (EOM sigma2, cceom.py:81).
    Hvvvv[abef] = sum_P Bd_ae[P,a,e] Bd_ae[P,b,f] + t2[mnab] <mn|ef>."""
    out = 0.5 * ladder_apply(dfh.Bd_ae, dfh.Bd_ae, x2, nblocks=nblocks)
    X = contract("ijef,mnef->ijmn", x2, _eri_oovv(dfh.df))
    return out + 0.5 * contract("ijmn,mnab->ijab", X, t2)


def loovv_df(df):
    """L[o,o,v,v] = 2<mn|ef> - <mn|fe> assembled from factors."""
    e = _eri_oovv(df)
    return 2.0 * e - e.swapaxes(2, 3)


# ---------------------------------------------------------------------------
# Lambda residuals over the DF-HBAR (cclambda.lambda_residuals, CCSD branch)
# ---------------------------------------------------------------------------

def lambda_residuals_df(dfh, t1, t2, l1, l2, no, S1=None, S2=None,
                        nblocks=None, model="CCSD", F=None):
    """r_L1, r_L2 over factors: every big-block contraction of the dense
    model branch (cclambda.lambda_residuals, cclambda.py:33-94) replaced
    by its factor-implicit form; equal to the dense path given exact
    factors (test_019).  CCD is exact here because the CCSD HBAR forms
    reduce to the CCD ones at t1 = 0 (and CCD keeps t1 = 0).  CC2
    (cclambda.py:56-61,78-82) needs the bare Fock matrix F for its
    one-body r2 terms; dfh must be built with model='CC2'."""
    from ..ops.ctensor import ct_zeros_like

    ccd = model == "CCD"
    if model == "CC2":
        return _lambda_residuals_cc2_df(dfh, F, t1, t2, l1, l2, no,
                                        S1=S1, S2=S2)
    Goo = contract("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * contract("ijeb,ijab->ae", t2, l2)
    Loovv = loovv_df(dfh.df)
    Hovvo_s = 2.0 * dfh.Hovvo - dfh.Hovov.swapaxes(2, 3)

    if ccd:
        r1 = ct_zeros_like(l1)
    else:
        r1 = 2.0 * dfh.Hov
        if S1 is not None:
            r1 = r1 + S1
        r1 += contract("ie,ea->ia", l1, dfh.Hvv)
        r1 -= contract("ma,im->ia", l1, dfh.Hoo)
        r1 += r1_l2_hvvvo(dfh, t1, t2, l2, dfh.Hov)
        r1 -= contract("mnae,iemn->ia", l2, dfh.Hovoo)
        r1 += contract("me,ieam->ia", l1, Hovvo_s)
        r1 += r1_gvv_hvovv(dfh, Gvv)
        r1 -= 2.0 * contract("mn,mina->ia", Goo, dfh.Hooov)
        r1 += contract("mn,imna->ia", Goo, dfh.Hooov)

    r2 = Loovv
    if not ccd:
        if S2 is not None:
            r2 = r2 + 0.5 * S2
        r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, dfh.Hov)
        r2 -= contract("ja,ib->ijab", l1, dfh.Hov)
        r2 += r2_l1_hvovv(dfh, l1)
        r2 -= 2.0 * contract("mb,jima->ijab", l1, dfh.Hooov)
        r2 += contract("mb,ijma->ijab", l1, dfh.Hooov)
    r2 = r2 + contract("ijeb,ea->ijab", l2, dfh.Hvv)
    r2 -= contract("mjab,im->ijab", l2, dfh.Hoo)
    r2 += 0.5 * contract("mnab,ijmn->ijab", l2, dfh.Hoooo)
    r2 += hvvvv_x2_df(dfh, t2, l2, nblocks=nblocks)
    r2 += contract("mjeb,ieam->ijab", l2, Hovvo_s)
    r2 -= contract("mibe,jema->ijab", l2, dfh.Hovov)
    r2 -= contract("mieb,jeam->ijab", l2, dfh.Hovvo)
    r2 += contract("ae,ijeb->ijab", Gvv, Loovv)
    r2 -= contract("mi,mjab->ijab", Goo, Loovv)
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    return r1, r2


def _lambda_residuals_cc2_df(dfh, F, t1, t2, l1, l2, no, S1=None, S2=None):
    """CC2 Lambda residuals over factors (cclambda.py:48-61, 68-82, CC2
    branch): the heavy-block terms (Hvvvv ladder, Hovvo/Hovov rings,
    Goo/Gvv) are absent in CC2; what remains is the implicit-Hvovv /
    implicit-Hvvvo l1/l2 terms plus bare-Fock one-body r2 terms.  dfh
    must be a model='CC2' build (Hoooo/Hovvo/Hovov/Hovoo CC2 forms)."""
    if F is None:
        raise Exception("CC2 df Lambda residuals need the Fock matrix F "
                        "(the dense CC2 r2 uses bare-Fock one-body terms).")
    o, v = slice(0, no), slice(no, None)
    tau = _tau(t1, t2)
    eri_oovv = _eri_oovv(dfh.df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    Hovvo_s = 2.0 * dfh.Hovvo - dfh.Hovov.swapaxes(2, 3)

    r1 = 2.0 * dfh.Hov
    if S1 is not None:
        r1 = r1 + S1
    r1 += contract("ie,ea->ia", l1, dfh.Hvv)
    r1 -= contract("ma,im->ia", l1, dfh.Hoo)
    r1 += r1_l2_hvvvo(dfh, t1, t2, l2, F[o, v], cc2=True)
    r1 -= contract("mnae,iemn->ia", l2, dfh.Hovoo)
    r1 += contract("me,ieam->ia", l1, Hovvo_s)
    tmp = contract("me,nmfe->nf", l1, t2)
    r1 += 2.0 * contract("nf,inaf->ia", tmp, Loovv)
    tmp = contract("me,mnfe->nf", l1, tau)
    r1 -= 2.0 * contract("nf,inaf->ia", tmp, eri_oovv)
    r1 += contract("nf,inaf->ia", tmp, eri_oovv.swapaxes(2, 3))

    r2 = Loovv
    if S2 is not None:
        r2 = r2 + 0.5 * S2
    r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, dfh.Hov)
    r2 -= contract("ja,ib->ijab", l1, dfh.Hov)
    r2 += r2_l1_hvovv(dfh, l1)
    r2 -= 2.0 * contract("mb,jima->ijab", l1, dfh.Hooov)
    r2 += contract("mb,ijma->ijab", l1, dfh.Hooov)
    r2 += contract("ijeb,ea->ijab", l2,
                   F[v, v] - contract("me,ma->ae", F[o, v], t1))
    r2 -= contract("mjab,im->ijab", l2,
                   F[o, o] + contract("ie,me->mi", t1, F[o, v]))
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    return r1, r2


def lambda_r2_small_a_df(dfh, l1, l2, no, S2=None):
    """First residual program at scale: Loovv seed plus the l1-driven
    Hov/Hooov terms.

    The fused residual holds ~14 simultaneous o^2 v^2 temps — 12.4 GB
    at (no,nv)=(40,360), too much for a 16 GB device on its own; a
    two-program split's seed still carried 7.4 GB and a three-way
    'small' 5.8 GB (the compiler's memory_analysis;
    examples/probe_lambda_hbm.py) on top of the ~10 GB resident set.
    The at-scale Lambda step therefore runs as FIVE host-sequenced
    device programs (the cceom.py per-vector pattern): small_a,
    small_b, lambda_r2_ladder_df, lambda_r2_rings_df, and lambda_r1_df
    — each <= ~4.5 GB of temps.  Equality with the fused form is
    tested (test_019_dfhbar)."""
    Loovv = loovv_df(dfh.df)
    r2 = Loovv
    if S2 is not None:
        r2 = r2 + 0.5 * S2
    r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, dfh.Hov)
    r2 -= contract("ja,ib->ijab", l1, dfh.Hov)
    r2 -= 2.0 * contract("mb,jima->ijab", l1, dfh.Hooov)
    r2 += contract("mb,ijma->ijab", l1, dfh.Hooov)
    return r2


def lambda_r2_small_b_df(dfh, l1, l2, r2_seed, no):
    """Second residual program at scale: the implicit-Hvovv l1 term and
    the one-index Hvv/Hoo/Hoooo contractions, onto the donated seed."""
    r2 = r2_seed + r2_l1_hvovv(dfh, l1)
    r2 += contract("ijeb,ea->ijab", l2, dfh.Hvv)
    r2 -= contract("mjab,im->ijab", l2, dfh.Hoo)
    r2 += 0.5 * contract("mnab,ijmn->ijab", l2, dfh.Hoooo)
    return r2


def lambda_r2_ladder_df(dfh, t2, l2, r2_seed, no, nblocks=None):
    """Third residual program at scale: the t1-dressed vvvv ladder on
    l2, accumulated onto the (donated) seed."""
    return r2_seed + hvvvv_x2_df(dfh, t2, l2, nblocks=nblocks)


def lambda_r2_seed_df(dfh, t1, t2, l1, l2, no, S2=None, nblocks=None):
    """small_a + small_b + ladder in one graph (the equality-test
    target)."""
    r2 = lambda_r2_small_a_df(dfh, l1, l2, no, S2)
    r2 = lambda_r2_small_b_df(dfh, l1, l2, r2, no)
    return lambda_r2_ladder_df(dfh, t2, l2, r2, no, nblocks=nblocks)


def lambda_r2_rings_df(dfh, t2, l2, r2_seed, no):
    """Second residual program at scale: the ovvo/ovov rings, the
    G-intermediate terms, and the pair symmetrization — the r2 half of
    the old finish program.  The spin-adapted 2*Hovvo - Hovov^T ring is
    expanded into two dots so the o^2v^2 Hovvo_s temp never exists."""
    Goo = contract("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * contract("ijeb,ijab->ae", t2, l2)
    Loovv = loovv_df(dfh.df)
    r2 = r2_seed
    r2 += 2.0 * contract("mjeb,ieam->ijab", l2, dfh.Hovvo)
    r2 -= contract("mjeb,iema->ijab", l2, dfh.Hovov)
    r2 -= contract("mibe,jema->ijab", l2, dfh.Hovov)
    r2 -= contract("mieb,jeam->ijab", l2, dfh.Hovvo)
    r2 += contract("ae,ijeb->ijab", Gvv, Loovv)
    r2 -= contract("mi,mjab->ijab", Goo, Loovv)
    return r2 + r2.transpose(1, 0, 3, 2)


def lambda_r1_df(dfh, t1, t2, l1, l2, no, S1=None):
    """Third residual program at scale: the full r1 (its r1_l2_hvvvo
    chain holds several o^2v^2 temps of its own, so it gets a program
    to itself at (40,360); see lambda_r2_seed_df)."""
    Goo = contract("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * contract("ijeb,ijab->ae", t2, l2)
    r1 = 2.0 * dfh.Hov
    if S1 is not None:
        r1 = r1 + S1
    r1 += contract("ie,ea->ia", l1, dfh.Hvv)
    r1 -= contract("ma,im->ia", l1, dfh.Hoo)
    r1 += r1_l2_hvvvo(dfh, t1, t2, l2, dfh.Hov)
    r1 -= contract("mnae,iemn->ia", l2, dfh.Hovoo)
    r1 += 2.0 * contract("me,ieam->ia", l1, dfh.Hovvo)
    r1 -= contract("me,iema->ia", l1, dfh.Hovov)
    r1 += r1_gvv_hvovv(dfh, Gvv)
    r1 -= 2.0 * contract("mn,mina->ia", Goo, dfh.Hooov)
    r1 += contract("mn,imna->ia", Goo, dfh.Hooov)
    return r1


def lambda_r1_r2_finish_df(dfh, t1, t2, l1, l2, r2_seed, no, S1=None,
                           nblocks=None):
    """Old two-program finish, kept as the equality-test target: the
    rings/G/symmetrization r2 plus the full r1 in one graph."""
    r2 = lambda_r2_rings_df(dfh, t2, l2, r2_seed, no)
    r1 = lambda_r1_df(dfh, t1, t2, l1, l2, no, S1)
    return r1, r2


# ---------------------------------------------------------------------------
# Host-sequenced Lambda residual with the HBAR built ON THE FLY
# (the RT-at-scale path: rt/rtcc.py _f_host_df)
# ---------------------------------------------------------------------------
#
# The solve-side five-program split (lambda_r2_small_a_df ... lambda_r1_df)
# consumes a PREBUILT DFHBar — fine when the 11 blocks are real and the
# build is amortized over a whole Lambda solve.  The RT RHS rebuilds the
# HBAR from the field-dressed F EVERY evaluation, and with CTensor re/im
# amplitudes every dressed block doubles: the fused RHS requested 26 GB at
# (32,256) naux=1024 (measured compile OOM).  These programs therefore
# assemble only the HBAR pieces they consume and release them at the
# program boundary; Hovvo/Hovov/Hovoo never coexist.  The l1-ring r1
# contributions are computed WHERE the ring blocks are resident (programs
# 4/5 return them as (o, v) extras) so the r1 program never rebuilds them.
# Equality with lambda_residuals_df(build_hbar_df(...)) is exact (same
# contractions, regrouped); tested in tests/test_025_rt_df.py.

from functools import partial as _partial


@_partial(jax.jit, static_argnames="no")
def _lrs_small(F, dfb, t1, t2, no):
    """Program 1: every <= o^3 v block plus the dressed factors."""
    o, v = slice(0, no), slice(no, None)
    df = dfb
    tau = _tau(t1, t2)
    Bd_ae, Bd_mi = dress_factors(df, t1)

    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    eri_ooov = _eri_ooov(df)
    Looov = 2.0 * eri_ooov - contract("Pme,Pni->mnie", df.Bov, df.Boo)

    Hov = F[o, v] + contract("nf,mnef->me", t1, Loovv)
    dP = contract("Pmf,mf->P", df.Bov, t1)
    Cam = contract("Paf,mf->Pam", df.Bvv, t1)
    ovvv_t = (2.0 * contract("P,Pae->ae", dP, df.Bvv)
              - contract("Pam,Pme->ae", Cam, df.Bov))
    Hvv = (F[v, v]
           - contract("me,ma->ae", F[o, v], t1)
           + ovvv_t
           - contract("mnfa,mnfe->ae", tau, Loovv))
    Hoo = (F[o, o]
           + contract("ie,me->mi", t1, F[o, v])
           + contract("ne,mnie->mi", t1, Looov)
           + contract("inef,mnef->mi", tau, Loovv))
    tmp = contract("je,mnie->mnij", t1, eri_ooov)
    Hoooo = (_eri_oooo(df) + tmp + tmp.transpose(1, 0, 3, 2)
             + contract("ijef,mnef->mnij", tau, eri_oovv))
    Hooov = contract("Pmi,Pne->mnie", Bd_mi, df.Bov)
    return Hov, Hvv, Hoo, Hoooo, Hooov, Bd_ae, Bd_mi


@_partial(jax.jit, static_argnames="no")
def _lrs_r2_small(dfb, Bd_ae, Hov, Hvv, Hoo, Hoooo, Hooov, l1, l2, no):
    """Program 2: the r2 seed — Loovv driver, l1-driven Hov/Hooov/Hvovv
    terms, and the one-index Hvv/Hoo/Hoooo l2 contractions."""
    df = dfb
    r2 = loovv_df(df)
    r2 = r2 + 2.0 * contract("ia,jb->ijab", l1, Hov)
    r2 -= contract("ja,ib->ijab", l1, Hov)
    # r2_l1_hvovv inline (needs only Bd_ae + Bov)
    A = contract("ie,Pea->Pia", l1, Bd_ae)
    r2 += 2.0 * contract("Pia,Pjb->ijab", A, df.Bov)
    A2 = contract("ie,Peb->Pib", l1, Bd_ae)
    r2 -= contract("Pib,Pja->ijab", A2, df.Bov)
    r2 -= 2.0 * contract("mb,jima->ijab", l1, Hooov)
    r2 += contract("mb,ijma->ijab", l1, Hooov)
    r2 += contract("ijeb,ea->ijab", l2, Hvv)
    r2 -= contract("mjab,im->ijab", l2, Hoo)
    r2 += 0.5 * contract("mnab,ijmn->ijab", l2, Hoooo)
    return r2


@_partial(jax.jit, static_argnames=("no", "nblocks"), donate_argnums=(4,))
def _lrs_r2_ladder(dfb, Bd_ae, t2, l2, r2, no, nblocks):
    """Program 3: the implicit-Hvvvv ladder on l2 (hvvvv_x2_df content)."""
    BL = _ea_layout(Bd_ae)
    r2 += 0.5 * ladder_apply(BL, BL, l2, nblocks=nblocks)
    X = contract("ijef,mnef->ijmn", l2, t2)
    r2 += 0.5 * contract("ijmn,mnab->ijab", X, _eri_oovv(dfb))
    return r2


@_partial(jax.jit, static_argnames="no", donate_argnums=(5,))
def _lrs_r2_ovvo(dfb, t1, t2, l1, l2, r2, no):
    """Program 4: build Hovvo on the fly, consume its two r2 ring dots
    and the l1 r1 ring term (returned as a small (o, v) extra)."""
    df = dfb
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    tau = _tau(t1, t2)
    Cbj = contract("Pbf,jf->Pbj", df.Bvv, t1)
    eri_oovo = contract("Pme,Pni->mnei", df.Bov, df.Boo)
    Hovvo = (_eri_ovvo(df)
             + contract("Pme,Pbj->mbej", df.Bov, Cbj)
             - contract("nb,mnej->mbej", t1, eri_oovo)
             - contract("jnfb,mnef->mbej", tau, eri_oovv)
             + contract("njfb,mnef->mbej", t2, Loovv))
    r2 += 2.0 * contract("mjeb,ieam->ijab", l2, Hovvo)
    r2 -= contract("mieb,jeam->ijab", l2, Hovvo)
    r1x = 2.0 * contract("me,ieam->ia", l1, Hovvo)
    return r2, r1x


@_partial(jax.jit, static_argnames="no", donate_argnums=(5,))
def _lrs_r2_ovov_fin(dfb, t1, t2, l1, l2, r2, no):
    """Program 5: build Hovov on the fly, consume its two r2 ring dots
    and l1 r1 term, add the G-intermediate terms, symmetrize."""
    df = dfb
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    tau = _tau(t1, t2)
    Dmj = contract("Pmf,jf->Pmj", df.Bov, t1)
    Hovov = (_eri_ovov(df)
             + contract("Pmj,Pbe->mbje", Dmj, df.Bvv)
             - contract("nb,mnje->mbje", t1, _eri_ooov(df))
             - contract("jnfb,nmef->mbje", tau, eri_oovv))
    r2 -= contract("mjeb,iema->ijab", l2, Hovov)
    r2 -= contract("mibe,jema->ijab", l2, Hovov)
    r1x = -1.0 * contract("me,iema->ia", l1, Hovov)
    Goo = contract("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * contract("ijeb,ijab->ae", t2, l2)
    r2 += contract("ae,ijeb->ijab", Gvv, Loovv)
    r2 -= contract("mi,mjab->ijab", Goo, Loovv)
    return r2 + r2.transpose(1, 0, 3, 2), r1x


@_partial(jax.jit, static_argnames="no")
def _lrs_r1(F, dfb, Bd_ae, Bd_mi, Hov, Hvv, Hoo, Hoooo, Hooov,
            t1, t2, l1, l2, no):
    """Program 6: the full r1 EXCEPT the l1 ring terms (programs 4/5
    return those); builds Hovoo on the fly and releases it."""
    df = dfb
    dfh = DFHBar(Hov=Hov, Hvv=Hvv, Hoo=Hoo, Hoooo=Hoooo, Hooov=Hooov,
                 Hovvo=None, Hovov=None, Hovoo=None,
                 df=df, Bd_ae=Bd_ae, Bd_mi=Bd_mi)
    tau = _tau(t1, t2)
    eri_oovv = _eri_oovv(df)
    Loovv = 2.0 * eri_oovv - eri_oovv.swapaxes(2, 3)
    eri_ooov = _eri_ooov(df)
    Looov = 2.0 * eri_ooov - contract("Pme,Pni->mnie", df.Bov, df.Boo)

    Goo = contract("mjab,ijab->mi", t2, l2)
    Gvv = -1.0 * contract("ijeb,ijab->ae", t2, l2)

    r1 = 2.0 * Hov
    r1 += contract("ie,ea->ia", l1, Hvv)
    r1 -= contract("ma,im->ia", l1, Hoo)
    r1 += r1_l2_hvvvo(dfh, t1, t2, l2, Hov)
    r1 += r1_gvv_hvovv(dfh, Gvv)
    r1 -= 2.0 * contract("mn,mina->ia", Goo, Hooov)
    r1 += contract("mn,imna->ia", Goo, Hooov)

    # Hovoo (cchbar.py:152-164 forms), built and consumed here
    Hovoo = (_eri_ovoo(df)
             + contract("me,ijeb->mbij", Hov, t2)
             - contract("nb,mnij->mbij", t1, Hoooo)
             + _tau_ovvv_ovoo(df, tau))
    tmpo = _eri_ovov(df) - contract("infb,mnfe->mbie", t2, eri_oovv)
    Hovoo = (Hovoo
             - contract("ineb,nmje->mbij", t2, eri_ooov)
             - contract("jneb,mnie->mbij", t2, eri_ooov)
             + contract("njeb,mnie->mbij", t2, Looov)
             + contract("je,mbie->mbij", t1, tmpo))
    tmpv = (contract("Pjb,Pme->bmje", df.Bov, df.Bov)
            - contract("jnfb,mnef->bmje", t2, eri_oovv)
            + contract("njfb,mnef->bmje", t2, Loovv))
    Hovoo = Hovoo + contract("ie,bmje->mbij", t1, tmpv)
    r1 -= contract("mnae,iemn->ia", l2, Hovoo)
    return r1


def lambda_residuals_df_split(F, dfb, t1, t2, l1, l2, no, nblocks=None):
    """Host-sequenced CCSD Lambda residuals with the (field-dressed) HBAR
    built on the fly: identical fixed point to
    lambda_residuals_df(build_hbar_df(F, ...), ...), evaluated as six
    short device programs with a host sync between them.  NOT jittable —
    the RT driver calls it from _f_host_df past the fused-RHS HBM wall."""
    import jax as _jax

    if nblocks is None:
        nblocks = _ladder_nblocks(t2.shape[-1], dfb.Bvv.shape[0])
    Hov, Hvv, Hoo, Hoooo, Hooov, Bd_ae, Bd_mi = _lrs_small(
        F, dfb, t1, t2, no=no)
    _jax.block_until_ready(Hooov)
    r2 = _lrs_r2_small(dfb, Bd_ae, Hov, Hvv, Hoo, Hoooo, Hooov, l1, l2,
                       no=no)
    _jax.block_until_ready(r2)
    r2 = _lrs_r2_ladder(dfb, Bd_ae, t2, l2, r2, no=no, nblocks=nblocks)
    _jax.block_until_ready(r2)
    r2, r1a = _lrs_r2_ovvo(dfb, t1, t2, l1, l2, r2, no=no)
    _jax.block_until_ready(r2)
    r2, r1b = _lrs_r2_ovov_fin(dfb, t1, t2, l1, l2, r2, no=no)
    _jax.block_until_ready(r2)
    r1 = _lrs_r1(F, dfb, Bd_ae, Bd_mi, Hov, Hvv, Hoo, Hoooo, Hooov,
                 t1, t2, l1, l2, no=no)
    r1 = r1 + r1a + r1b
    _jax.block_until_ready(r1)
    return r1, r2


# ---------------------------------------------------------------------------
# EOM sigmas over the DF-HBAR (cceom.sigma1/sigma2)
# ---------------------------------------------------------------------------

def sigma1_df(dfh, C1, C2, Loovv, no):
    """cceom.sigma1 with the Hvovv terms factor-implicit."""
    s1 = contract("ie,ae->ia", C1, dfh.Hvv)
    s1 -= contract("mi,ma->ia", dfh.Hoo, C1)
    s1 += 2.0 * contract("maei,me->ia", dfh.Hovvo, C1)
    s1 -= contract("maie,me->ia", dfh.Hovov, C1)
    s1 += 2.0 * contract("miea,me->ia", C2, dfh.Hov)
    s1 -= contract("imea,me->ia", C2, dfh.Hov)
    s1 += r1_c2_hvovv(dfh, C2)
    s1 -= 2.0 * contract("mnie,mnae->ia", dfh.Hooov, C2)
    s1 += contract("nmie,mnae->ia", dfh.Hooov, C2)
    return s1


def sigma2_df(dfh, C1, C2, Loovv, t1, t2, no, nblocks=None):
    """cceom.sigma2 with Hvovv/Hvvvo/Hvvvv factor-implicit."""
    Zvv = zvv_c1_hvovv(dfh, C1)
    Zvv -= contract("nmaf,nmef->ae", C2, Loovv)

    Zoo = -2.0 * contract("mnie,ne->mi", dfh.Hooov, C1)
    Zoo += contract("nmie,ne->mi", dfh.Hooov, C1)
    Zoo -= contract("mnef,inef->mi", Loovv, C2)

    s2 = s2_c1_hvvvo(dfh, t1, t2, C1, dfh.Hov)
    s2 -= contract("mbij,ma->ijab", dfh.Hovoo, C1)
    s2 += contract("ijeb,ae->ijab", t2, Zvv)
    s2 += contract("mi,mjab->ijab", Zoo, t2)
    s2 += contract("ijeb,ae->ijab", C2, dfh.Hvv)
    s2 -= contract("mi,mjab->ijab", dfh.Hoo, C2)
    s2 += 0.5 * contract("mnij,mnab->ijab", dfh.Hoooo, C2)
    s2 += hvvvv_x2_abef_df(dfh, t2, C2, nblocks=nblocks)
    s2 -= contract("imeb,maje->ijab", C2, dfh.Hovov)
    s2 -= contract("imea,mbej->ijab", C2, dfh.Hovvo)
    s2 += 2.0 * contract("miea,mbej->ijab", C2, dfh.Hovvo)
    s2 -= contract("miea,mbje->ijab", C2, dfh.Hovov)
    return s2 + s2.transpose(1, 0, 3, 2)
