"""Spin-adapted closed-shell CC amplitude equations (CCD / CC2 / CCSD).

Pure functions over device arrays — the functional counterpart of the
residual builders in /root/reference/pycc/ccwfn.py:331-622.  The equations
are the standard spin-adapted RHF-CC equations (Stanton, Gauss, Watts,
Bartlett, JCP 94, 4334 (1991), closed-shell adaptation); model variants are
separate functions selected at trace time, so each jitted graph contains
exactly one model's contractions.

Conventions: t1 (o,v), t2 (o,o,v,v); ERI in Dirac <pq|rs>; L = 2<pq|rs> -
<pq|sr>; `no` is static.  All functions accept F explicitly so the real-time
module can pass the field-dressed Fock.
"""

import jax.numpy as jnp
from ..ops.contract import contract


def slices(no):
    return slice(0, no), slice(no, None)


def build_tau(t1, t2, f1=1.0, f2=1.0):
    return f1 * t2 + f2 * contract("ia,jb->ijab", t1, t1)


def vvvv_contract(tau, W):
    """'ijef,abef->ijab' as a single (o^2, v^2) x (v^2, v^2) matmul.

    The einsum lowering can materialize an (o-batch, v, v, v, v) temp that
    blows device memory at production sizes; the reshaped dot is one
    matmul with no such buffer."""
    from ..ops.ctensor import ct_dot
    no1, no2, nv, _ = tau.shape
    na, nb = W.shape[0], W.shape[1]
    out = ct_dot(tau.reshape(no1 * no2, nv * nv),
                 W.reshape(na * nb, nv * nv),
                 preferred_element_type=tau.dtype, contract_last=True)
    return out.reshape(no1, no2, na, nb)


def vvvv_contract_efab(tau, W):
    """'ijef,efab->ijab' as a single (o^2, v^2) x (v^2, v^2) matmul
    (see vvvv_contract; this is the left-Hvvvv form used by Lambda/Y2)."""
    from ..ops.ctensor import ct_dot
    no1, no2, nv, _ = tau.shape
    na, nb = W.shape[2], W.shape[3]
    out = ct_dot(tau.reshape(no1 * no2, nv * nv),
                 W.reshape(nv * nv, na * nb),
                 preferred_element_type=tau.dtype)
    return out.reshape(no1, no2, na, nb)


# ---------------------------------------------------------------------------
# one-particle intermediates (CCSD / CC2 share these; CCD variants below)
# ---------------------------------------------------------------------------

def build_Fae(F, L, t1, t2, no):
    o, v = slices(no)
    tau_h = build_tau(t1, t2, 1.0, 0.5)
    return (F[v, v]
            - 0.5 * contract("me,ma->ae", F[o, v], t1)
            + contract("mf,mafe->ae", t1, L[o, v, v, v])
            - contract("mnaf,mnef->ae", tau_h, L[o, o, v, v]))


def build_Fmi(F, L, t1, t2, no):
    o, v = slices(no)
    tau_h = build_tau(t1, t2, 1.0, 0.5)
    return (F[o, o]
            + 0.5 * contract("ie,me->mi", t1, F[o, v])
            + contract("ne,mnie->mi", t1, L[o, o, o, v])
            + contract("inef,mnef->mi", tau_h, L[o, o, v, v]))


def build_Fme(F, L, t1, no):
    o, v = slices(no)
    return F[o, v] + contract("nf,mnef->me", t1, L[o, o, v, v])


# ---------------------------------------------------------------------------
# two-particle intermediates
# ---------------------------------------------------------------------------

def build_Wmnij(ERI, t1, t2, no):
    o, v = slices(no)
    tau = build_tau(t1, t2)
    return (ERI[o, o, o, o]
            + contract("je,mnie->mnij", t1, ERI[o, o, o, v])
            + contract("ie,mnej->mnij", t1, ERI[o, o, v, o])
            + contract("ijef,mnef->mnij", tau, ERI[o, o, v, v]))


def build_Wmbej(ERI, L, t1, t2, no):
    o, v = slices(no)
    tau_x = build_tau(t1, t2, 0.5, 1.0)
    return (ERI[o, v, v, o]
            + contract("jf,mbef->mbej", t1, ERI[o, v, v, v])
            - contract("nb,mnej->mbej", t1, ERI[o, o, v, o])
            - contract("jnfb,mnef->mbej", tau_x, ERI[o, o, v, v])
            + 0.5 * contract("njfb,mnef->mbej", t2, L[o, o, v, v]))


def build_Wmbje(ERI, t1, t2, no):
    o, v = slices(no)
    tau_x = build_tau(t1, t2, 0.5, 1.0)
    return (-ERI[o, v, o, v]
            - contract("jf,mbfe->mbje", t1, ERI[o, v, v, v])
            + contract("nb,mnje->mbje", t1, ERI[o, o, o, v])
            + contract("jnfb,mnfe->mbje", tau_x, ERI[o, o, v, v]))


def build_Zmbij(ERI, t1, t2, no):
    o, v = slices(no)
    return contract("mbef,ijef->mbij", ERI[o, v, v, v], build_tau(t1, t2))


# ---------------------------------------------------------------------------
# CCSD residuals
# ---------------------------------------------------------------------------

def _r_T1(F, ERI, L, t1, t2, Fae, Fme, Fmi, no):
    o, v = slices(no)
    t2s = 2.0 * t2 - t2.swapaxes(2, 3)
    return (F[o, v]
            + contract("ie,ae->ia", t1, Fae)
            - contract("ma,mi->ia", t1, Fmi)
            + contract("imae,me->ia", t2s, Fme)
            + contract("nf,nafi->ia", t1, L[o, v, v, o])
            + contract("mief,maef->ia", t2s, ERI[o, v, v, v])
            - contract("mnae,nmei->ia", t2, L[o, o, v, o]))


def residuals_ccsd(F, ERI, L, t1, t2, no):
    o, v = slices(no)
    Fae = build_Fae(F, L, t1, t2, no)
    Fmi = build_Fmi(F, L, t1, t2, no)
    Fme = build_Fme(F, L, t1, no)
    Wmnij = build_Wmnij(ERI, t1, t2, no)
    Wmbej = build_Wmbej(ERI, L, t1, t2, no)
    Wmbje = build_Wmbje(ERI, t1, t2, no)
    Zmbij = build_Zmbij(ERI, t1, t2, no)
    tau = build_tau(t1, t2)

    r1 = _r_T1(F, ERI, L, t1, t2, Fae, Fme, Fmi, no)

    r2 = 0.5 * ERI[o, o, v, v]
    r2 += contract("ijae,be->ijab", t2, Fae)
    r2 -= 0.5 * contract("ijae,be->ijab", t2, contract("mb,me->be", t1, Fme))
    r2 -= contract("imab,mj->ijab", t2, Fmi)
    r2 -= 0.5 * contract("imab,jm->ijab", t2, contract("je,me->jm", t1, Fme))
    r2 += 0.5 * contract("mnij,mnab->ijab", Wmnij, tau)
    r2 += 0.5 * vvvv_contract(tau, ERI[v, v, v, v])
    r2 -= contract("ma,mbij->ijab", t1, Zmbij)
    r2 += contract("imae,mbej->ijab", t2 - t2.swapaxes(2, 3), Wmbej)
    r2 += contract("imae,mbej->ijab", t2, Wmbej + Wmbje.swapaxes(2, 3))
    r2 += contract("mjae,mbie->ijab", t2, Wmbje)
    tt = contract("ie,ma->imea", t1, t1)
    r2 -= contract("imea,mbej->ijab", tt, ERI[o, v, v, o])
    r2 -= contract("imeb,maje->ijab", tt, ERI[o, v, o, v])
    r2 += contract("ie,abej->ijab", t1, ERI[v, v, v, o])
    r2 -= contract("ma,mbij->ijab", t1, ERI[o, v, o, o])
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    return r1, r2


# ---------------------------------------------------------------------------
# CCD residuals
# ---------------------------------------------------------------------------

def residuals_ccd(F, ERI, L, t1, t2, no):
    o, v = slices(no)
    Fae = F[v, v] - contract("mnaf,mnef->ae", t2, L[o, o, v, v])
    Fmi = F[o, o] + contract("inef,mnef->mi", t2, L[o, o, v, v])
    Wmnij = ERI[o, o, o, o] + contract("ijef,mnef->mnij", t2, ERI[o, o, v, v])
    Wmbej = (ERI[o, v, v, o]
             - 0.5 * contract("jnfb,mnef->mbej", t2, ERI[o, o, v, v])
             + 0.5 * contract("njfb,mnef->mbej", t2, L[o, o, v, v]))
    Wmbje = (-ERI[o, v, o, v]
             + 0.5 * contract("jnfb,mnfe->mbje", t2, ERI[o, o, v, v]))

    from ..ops.ctensor import ct_zeros_like
    r1 = ct_zeros_like(t1)
    r2 = 0.5 * ERI[o, o, v, v]
    r2 += contract("ijae,be->ijab", t2, Fae)
    r2 -= contract("imab,mj->ijab", t2, Fmi)
    r2 += 0.5 * contract("mnij,mnab->ijab", Wmnij, t2)
    r2 += 0.5 * vvvv_contract(t2, ERI[v, v, v, v])
    r2 += contract("imae,mbej->ijab", t2 - t2.swapaxes(2, 3), Wmbej)
    r2 += contract("imae,mbej->ijab", t2, Wmbej + Wmbje.swapaxes(2, 3))
    r2 += contract("mjae,mbie->ijab", t2, Wmbje)
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    return r1, r2


# ---------------------------------------------------------------------------
# CC2 residuals
# ---------------------------------------------------------------------------

def residuals_cc2(F, ERI, L, t1, t2, no):
    o, v = slices(no)
    Fae = build_Fae(F, L, t1, t2, no)
    Fmi = build_Fmi(F, L, t1, t2, no)
    Fme = build_Fme(F, L, t1, no)
    Wmnij = (ERI[o, o, o, o]
             + contract("je,mnie->mnij", t1, ERI[o, o, o, v])
             + contract("ie,mnej->mnij", t1, ERI[o, o, v, o])
             + contract("jf,mnif->mnij", t1,
                        contract("ie,mnef->mnif", t1, ERI[o, o, v, v])))
    Zmbij = contract("mbif,jf->mbij", contract("mbef,ie->mbif",
                                               ERI[o, v, v, v], t1), t1)

    r1 = _r_T1(F, ERI, L, t1, t2, Fae, Fme, Fmi, no)

    r2 = 0.5 * ERI[o, o, v, v]
    fae = F[v, v] - 0.5 * contract("me,ma->ae", F[o, v], t1)
    r2 += contract("ijae,be->ijab", t2, fae)
    r2 -= 0.5 * contract("ijae,be->ijab", t2, contract("mb,me->be", t1, F[o, v]))
    fmi = F[o, o] + 0.5 * contract("ie,me->mi", t1, F[o, v])
    r2 -= contract("imab,mj->ijab", t2, fmi)
    r2 -= 0.5 * contract("imab,jm->ijab", t2, contract("je,me->jm", t1, F[o, v]))
    r2 += 0.5 * contract("ma,mbij->ijab", t1,
                         contract("nb,mnij->mbij", t1, Wmnij))
    r2 += 0.5 * contract("jf,abif->ijab", t1,
                         contract("ie,abef->abif", t1, ERI[v, v, v, v]))
    r2 -= contract("ma,mbij->ijab", t1, Zmbij)
    r2 -= contract("ma,mbij->ijab", t1,
                   contract("ie,mbej->mbij", t1, ERI[o, v, v, o]))
    r2 -= contract("mb,maji->ijab", t1,
                   contract("ie,maje->maji", t1, ERI[o, v, o, v]))
    r2 += contract("ie,abej->ijab", t1, ERI[v, v, v, o])
    r2 -= contract("ma,mbij->ijab", t1, ERI[o, v, o, o])
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    return r1, r2


# ---------------------------------------------------------------------------
# energies
# ---------------------------------------------------------------------------

def cc_energy(F, L, t1, t2, no):
    o, v = slices(no)
    ecc = 2.0 * contract("ia,ia->", F[o, v], t1)
    return ecc + contract("ijab,ijab->", build_tau(t1, t2), L[o, o, v, v])


def ccd_energy(F, L, t1, t2, no):
    o, v = slices(no)
    return contract("ijab,ijab->", t2, L[o, o, v, v])
