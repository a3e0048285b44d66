"""Pair-screened local CCD: compact strong-pair stacks.

The padded-batch local equations (lccwfn_local.py) materialize pair-pair
stacks of shape (no, no, no, no, D, D) — no^4 D^2 memory (the reference instead walks ragged per-pair
lists, /root/reference/pycc/local.py:973-1031).  This module stores every
pair-pair quantity over a COMPACT strong-pair list: pairs whose local-MP2
pair energy is below `pair_cutoff` are frozen at their MP2 amplitudes
(the standard weak-pair treatment) and excluded from both sides of every
stack, so memory scales as P^2 D^2 + P no D^2 with P = #strong pairs —
sublinear in no^4 whenever the cutoff bites, and EXACTLY the unscreened
equations when pair_cutoff = 0 (every pair strong; equality-tested in
tests/test_010).

The residual function keeps the driver-facing (no, no, D, D) amplitude
layout: weak-pair rows of the returned residual are zero, so the Jacobi
update never moves them off their MP2 values and the energy functional
picks up the frozen weak-pair MP2 contribution automatically.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .ops.contract import contract


def mp2_pair_energies(H, Local, no, nv):
    """Local-MP2 pair energies e_ij from the padded PNO stacks."""
    o, v = slice(0, no), slice(no, None)
    QLp = Local.QLp
    eps = Local.epsp
    Fdiag = jnp.diag(H.F)
    fo = Fdiag[:no]
    pair_i = jnp.arange(no * no) // no
    pair_j = jnp.arange(no * no) % no
    E4 = H.ERI[o, o, v, v].reshape(no * no, nv, nv)
    L4 = H.L[o, o, v, v].reshape(no * no, nv, nv)
    eri_loc = jnp.einsum("pva,pvw,pwb->pab", QLp, E4, QLp)
    L_loc = jnp.einsum("pva,pvw,pwb->pab", QLp, L4, QLp)
    Dloc = (eps[:, :, None] + eps[:, None, :]
            - fo[pair_i][:, None, None] - fo[pair_j][:, None, None])
    t2 = -eri_loc / Dloc
    return np.asarray(jnp.einsum("pab,pab->p", t2, L_loc)).reshape(no, no)


def screen_pairs(H, Local, no, nv, pair_cutoff):
    """Strong-pair index arrays.  Diagonal pairs are always strong, and
    the list is (i,j)<->(j,i) symmetric so the pair transpose stays
    inside it."""
    e_ij = np.abs(mp2_pair_energies(H, Local, no, nv))
    strong = (e_ij >= pair_cutoff) | (e_ij.T >= pair_cutoff)
    np.fill_diagonal(strong, True)
    pi, pj = np.nonzero(strong)
    pidx = -np.ones((no, no), dtype=np.int32)
    pidx[pi, pj] = np.arange(len(pi), dtype=np.int32)
    return (jnp.asarray(pidx), jnp.asarray(pi.astype(np.int32)),
            jnp.asarray(pj.astype(np.int32)))


def precompute_ccd_screened(H, Local, no, nv, pair_cutoff=0.0):
    """Compact strong-pair transformed-integral stacks (CCD).

    Every tensor of lccwfn_local.precompute_ccd reappears here gathered
    to the strong-pair list: (P, P, D, D) for pair-pair couplings and
    (P, no, D, D) for the per-m W heads."""
    o, v = slice(0, no), slice(no, None)
    D = Local.D2
    QLr = Local.QLp.reshape(no, no, nv, D)
    pidx, pi, pj = screen_pairs(H, Local, no, nv, pair_cutoff)
    P = int(pi.shape[0])
    QLg = QLr[pi, pj]                       # (P, nv, D)
    E4 = H.ERI[o, o, v, v]
    L4 = H.L[o, o, v, v]
    E4g = E4[pi, pj]                        # (P, nv, nv) block of pair q
    L4g = L4[pi, pj]

    pre = {"pidx": pidx, "pi": pi, "pj": pj, "P": P, "no": no, "D": D}
    pre["F_oo"] = H.F[o, o]
    # ERI_oooo gathered on both pair axes: [q, p] = <m n | i j>
    pre["ERI_oooo_g"] = _oooo_gather(H.ERI[o, o, o, o], pi, pj)
    pre["Fvv"] = contract("pva,vw,pwb->pab", QLg, H.F[v, v], QLg)
    pre["Sg"] = contract("pva,qvb->pqab", QLg, QLg)
    # TL[p,q,a,x] = QL[p]^T L4[q-block] QL[q]
    half = contract("qvw,qwx->qvx", L4g, QLg)
    pre["TLg"] = contract("pva,qvx->pqax", QLg, half)
    # BE[p,q,a,b] = QL[p]^T E4[q-block] QL[p]
    pre["BEg"] = contract("pva,qvw,pwb->pqab", QLg, E4g, QLg)
    # BL[q=(j,n), m, a, b] = QL[q]^T L4[m, n] QL[q]
    L4_n = L4[:, pj]                        # (no_m, P, nv, nv)
    pre["BLg"] = contract("qva,mqvw,qwb->qmab", QLg, L4_n, QLg)
    # W heads (p=(i,j), m): need QL[im] per (p, m)
    idx_im = pidx[pi][:, :]                 # pidx rows for i: (P, no) -> [p, m]
    mask_im = (idx_im >= 0)
    QLim = QLg[jnp.where(idx_im >= 0, idx_im, 0)]      # (P, no, nv, D)
    QLim = QLim * mask_im[:, :, None, None]
    ERIovvo_j = H.ERI[o, v, v, o][:, :, :, pj]         # (no_m, nv, nv, P)
    pre["W1g"] = contract("pvb,mvwp,pmwe->pmbe", QLg, ERIovvo_j, QLim)
    ERIovov_j = H.ERI[o, v, o, v][:, :, pj]            # (no_m, nv, P, nv)
    pre["W1jeg"] = contract("pvb,mvpw,pmwe->pmbe", QLg, ERIovov_j, QLim)
    # W1ie[ij,m,b,e] = QL[ij,vb] ERI[ovov][m,v,i,w] QL[mj,we]
    idx_mj = pidx[:, pj].T                             # (P, no) [p, m]
    mask_mj = (idx_mj >= 0)
    QLmj = QLg[jnp.where(idx_mj >= 0, idx_mj, 0)]
    QLmj = QLmj * mask_mj[:, :, None, None]
    ERIovov_i = H.ERI[o, v, o, v][:, :, pi]            # (no_m, nv, P, nv)
    pre["W1ieg"] = contract("pvb,mvpw,pmwe->pmbe", QLg, ERIovov_i, QLmj)
    # cross-pair oovv blocks over (row r, col s) pair axes:
    #   XE[r=(i,m), s=(j,n)] = QL[r]^T E4[m, n] QL[s]
    pre["XEg"] = _cross_block(QLg, E4, pj, pj, QLg)
    #   XL[r=(i,m), s=(n,j)] = QL[r]^T L4[m, n] QL[s]
    pre["XLg"] = _cross_block(QLg, L4, pj, pi, QLg)
    #   XE2[r=(j,n), s=(i,m)] = QL[r]^T E4[m, n] QL[s] (note swap)
    pre["XE2g"] = _cross_block(QLg, E4.swapaxes(0, 1), pj, pj, QLg)
    #   XE3[r=(i,n), s=(m,j)] = QL[r]^T E4[m, n]^T... E4[n from r, m from s]
    pre["XE3g"] = _cross_block(QLg, E4.swapaxes(0, 1), pj, pi, QLg)
    # pair-local vvvv block, scanned over pairs to bound the live nv^3 D
    Evvvv = H.ERI[v, v, v, v]

    def one_vv(q):                          # q: (nv, D)
        A = contract("va,vwxy->awxy", q, Evvvv)
        A = contract("wb,awxy->abxy", q, A)
        A = contract("xe,abxy->abey", q, A)
        return contract("yf,abey->abef", q, A)

    pre["VVg"] = jax.lax.map(one_vv, QLg)
    pre["idx_im"], pre["mask_im"] = idx_im, mask_im
    pre["idx_mj"], pre["mask_mj"] = idx_mj, mask_mj
    # transpose map p -> (j,i) slot (always present; list is symmetric)
    pre["ptrans"] = pidx[pj, pi]
    # energy block over the FULL pair layout (no^2 D^2 — cheap): weak
    # pairs then contribute their frozen local-MP2 energy automatically
    L4f = L4.reshape(no * no, nv, nv)
    QLf = Local.QLp
    pre["Ldiag_full"] = contract("pva,pvw,pwb->pab", QLf, L4f, QLf) \
        .reshape(no, no, D, D)
    return pre


def energy_ccd_screened(pre, t2r):
    return contract("ijab,ijab->", t2r, pre["Ldiag_full"])


def precompute_ccsd_screened(H, Local, no, nv, pair_cutoff=0.0):
    """Compact strong-pair stacks for local CCSD (singles-dressed).

    Extends precompute_ccd_screened with the singles tails of
    lccwfn_local.precompute_ccsd, every pair-pair tensor gathered to the
    strong list: (P, no, ...) for per-m heads, (Q, P, ...) for the Wmnij
    couplings, (P, D, D, D[, D]) for the pair-local ladders.  Diagonal
    pairs are always strong, so the QLd transforms are plain gathers."""
    o, v = slice(0, no), slice(no, None)
    D = Local.D2
    QLr = Local.QLp.reshape(no, no, nv, D)
    pre = precompute_ccd_screened(H, Local, no, nv, pair_cutoff)
    pidx, pi, pj = pre["pidx"], pre["pi"], pre["pj"]
    QLg = QLr[pi, pj]
    rng = jnp.arange(no)
    diag = pidx[rng, rng]                    # always >= 0
    QLd = QLg[diag]                          # (no, nv, D)
    QLd_pi, QLd_pj = QLd[pi], QLd[pj]
    E4 = H.ERI[o, o, v, v]
    L4 = H.L[o, o, v, v]
    Eovvv = H.ERI[o, v, v, v]
    Eooov = H.ERI[o, o, o, v]
    Eoovo = H.ERI[o, o, v, o]
    Fov = H.F[o, v]
    fdt = QLg.dtype

    idx_im, mask_im = pre["idx_im"], pre["mask_im"]     # [p, m] -> (i, m)
    idx_mj, mask_mj = pre["idx_mj"], pre["mask_mj"]     # [p, m] -> (m, j)
    QLim = QLg[jnp.where(idx_im >= 0, idx_im, 0)] \
        * mask_im[:, :, None, None].astype(fdt)
    QLmj = QLg[jnp.where(idx_mj >= 0, idx_mj, 0)] \
        * mask_mj[:, :, None, None].astype(fdt)

    pre["diag"] = diag
    Sg = pre["Sg"]
    pre["Sdiag_g"] = Sg[:, diag]                        # S(p, (m,m))
    pre["Siimm"] = Sg[diag][:, diag]                    # S((i,i),(m,m))
    safe_f = jnp.where(pidx >= 0, pidx, 0)
    mask_f = (pidx >= 0).astype(fdt)
    # S((i,i),(i,m)) over the full (i, m) grid, weak (i,m) masked
    pre["Siiim"] = Sg[diag][rng[:, None], safe_f] \
        * mask_f[:, :, None, None]

    pre["Fov_g"] = contract("mv,pve->pme", Fov, QLg)
    pre["Fov_ii"] = contract("iv,iva->ia", Fov, QLd)
    pre["FovD"] = contract("mv,jve->jme", Fov, QLd)
    # Fae singles tails
    pre["TLm_g"] = contract("pva,mvwz,mwb,pzc->pmabc",
                            QLg, H.L[o, v, v, v], QLd, QLg)
    pre["TLnn_g"] = contract("pve,mnvw,nwf->pmnef", QLg, L4, QLd)
    # Fmi singles tails (full occupied layout — cheap)
    pre["LooovD"] = contract("mnjv,nve->mnje", H.L[o, o, o, v], QLd)
    pre["TL2"] = contract("mnvw,jve,nwf->mnjef", L4, QLd, QLd)
    # Wmnij singles tails, both pair axes strong: [q=(m,n), p=(i,j)]
    A = Eooov[pi[:, None], pj[:, None], pi[None, :]]    # (Q, P, nv)
    pre["EooovD_g"] = contract("qpv,pve->qpe", A, QLd_pj)
    A = jnp.swapaxes(Eoovo, 2, 3)[pi[:, None], pj[:, None], pj[None, :]]
    pre["EoovoD_g"] = contract("qpv,pve->qpe", A, QLd_pi)
    E4q = E4[pi, pj]
    pre["TE2_g"] = contract("qvw,pve,pwf->qpef", E4q, QLd_pi, QLd_pj)
    # Zmbij tails
    pre["EovvvP_g"] = contract("mvwz,pvb,pwe,pzf->pmbef",
                               Eovvv, QLg, QLg, QLg)
    pre["Eovvv_iijj_g"] = contract("mvwz,pvb,pwe,pzf->pmbef",
                                   Eovvv, QLg, QLd_pi, QLd_pj)
    # Wmbej singles tails
    pre["TE_mbe_g"] = contract("mvwz,pvb,pmwe,pzf->pmbef",
                               Eovvv, QLg, QLim, QLd_pj)
    B = jnp.moveaxis(Eoovo, 3, 0)[pj]                   # (P, no_m, no_n, nv)
    pre["Eoovo_g"] = contract("pmnv,pmve->pmne", B, QLim)
    pre["XEjj_g"] = contract("pmve,mnvw,pwf->pmnef", QLim, E4, QLd_pj)
    # Wmbje singles tails
    pre["TE_bFe_g"] = contract("mvwz,pvb,pwf,pmze->pmbfe",
                               Eovvv, QLg, QLd_pj, QLim)
    B = jnp.moveaxis(Eooov, 2, 0)[pj]
    pre["Eooov_g"] = contract("pmnv,pmve->pmne", B, QLim)
    pre["XE5_g"] = contract("pvf,mnvw,pmwe->pmnfe", QLd_pj, E4, QLim)
    # Wmbie singles tails
    pre["TE_bFe_mj_g"] = contract("mvwz,pvb,pwf,pmze->pmbfe",
                                  Eovvv, QLg, QLd_pi, QLmj)
    B = jnp.moveaxis(Eooov, 2, 0)[pi]
    pre["Eooov_mj_g"] = contract("pmnv,pmve->pmne", B, QLmj)
    pre["XE6_g"] = contract("pvf,mnvw,pmwe->pmnfe", QLd_pi, E4, QLmj)
    # r_T1 pieces (full occupied layouts; weak (m,i) pairs masked)
    QLmi_f = QLg[safe_f.T] * mask_f.T[:, :, None, None]     # [m, i] -> (m,i)
    QLmi_f = jnp.swapaxes(QLmi_f, 0, 1)                     # [i, m]
    pre["Eovvv_mi"] = contract("mvwz,iva,imwe,imzf->imaef",
                               Eovvv, QLd, QLmi_f, QLmi_f)
    pre["Lnvvi"] = contract("nvwi,iva,nwf->inaf", H.L[o, v, v, o], QLd, QLd)
    A = H.L[o, o, v, o][pj, pi]                         # L[n, m, v, i] at q
    pre["LoovoD_g"] = contract("qvi,qve->qie", A, QLg)
    # r_T2 pieces: pair-local ladders scanned over pairs
    Evvvv = H.ERI[v, v, v, v]
    Evvvo = H.ERI[v, v, v, o]

    def one_vv2(args):
        q, qi, qj = args
        A = contract("va,vwxy->awxy", q, Evvvv)
        A = contract("wb,awxy->abxy", q, A)
        A = contract("xe,abxy->abey", qi, A)
        return contract("yf,abey->abef", qj, A)

    pre["VV2_g"] = jax.lax.map(one_vv2, (QLg, QLd_pi, QLd_pj))

    def one_vvvo(args):
        q, qi, j = args
        Ej = Evvvo[:, :, :, j]
        A = contract("va,vwz->awz", q, Ej)
        A = contract("wb,awz->abz", q, A)
        return contract("ze,abz->abe", qi, A)

    pre["Evvvo_g"] = jax.lax.map(one_vvvo, (QLg, QLd_pi, pj))
    B = jnp.moveaxis(H.ERI[o, v, v, o], 3, 0)[pj]       # (P, no_m, nv, nv)
    pre["E9_g"] = contract("pmvw,pva,pwe->pmae", B, QLg, QLd_pi)
    B = jnp.moveaxis(H.ERI[o, v, o, v], 2, 0)[pj]
    pre["E11_g"] = contract("pmvw,pva,pwe->pmae", B, QLg, QLd_pi)
    B = jnp.moveaxis(H.ERI[o, v, o, o], (2, 3), (0, 1))[pi, pj]
    pre["Eovoo_g"] = contract("pmv,pvb->pmb", B, QLg)
    # energy singles block (full layout)
    pre["LdiagX"] = contract("ijvw,iva,jwb->ijab", L4, QLd, QLd)
    return pre


def energy_ccsd_screened(pre, t1loc, t2r):
    e = 2.0 * contract("ia,ia->", pre["Fov_ii"], t1loc)
    e += contract("ijab,ijab->", t2r, pre["Ldiag_full"])
    e += contract("ia,jb,ijab->", t1loc, t1loc, pre["LdiagX"])
    return e


def _oooo_gather(Eoooo, pi, pj):
    """<pi[q] pj[q] | pi[p] pj[p]> -> (Q, P)."""
    return Eoooo[pi[:, None], pj[:, None], pi[None, :], pj[None, :]]


def _cross_block(QLrow, E4, row_k, col_k, QLcol):
    """A[r, s, e, f] = QLrow[r,v,e] E4[row_k[r], col_k[s], v, w]
    QLcol[s,w,f] — the generic (P, P, D, D) cross-pair transformed
    block, built via a scan over rows to bound the live gather."""
    def one_row(args):
        qr, kr = args
        blk = E4[kr][col_k]                 # (P, nv, nv)
        h = contract("svw,swf->svf", blk, QLcol)
        return contract("ve,svf->sef", qr, h)

    return jax.lax.map(one_row, (QLrow, row_k))


def residuals_ccd_screened(pre, t2r):
    """r2 (no,no,D,D): the lccwfn_local.residuals_ccd_local equations over
    the compact strong-pair stacks; weak-pair rows return 0."""
    pidx, pi, pj = pre["pidx"], pre["pi"], pre["pj"]
    # static ints from the amplitude SHAPE: pre is a jit argument, so its
    # scalar entries arrive as tracers and cannot parameterize reshapes
    no, D = t2r.shape[0], t2r.shape[2]
    Sg, TLg, BEg = pre["Sg"], pre["TLg"], pre["BEg"]
    t2c = t2r.reshape(no * no, D, D)[pi * no + pj]
    t2sc = t2c - t2c.swapaxes(1, 2)

    # Fae[p,a,e] = Fvv - sum_q (Sg[p,q] t2c[q]) . TLg[p,q]
    ST = contract("pqax,qxy->pqay", Sg, t2c)
    Fae = pre["Fvv"] - contract("pqay,pqey->pae", ST, TLg)
    # Fmi[m, j]: sum over pairs q=(j,n): t2c[q] . BLg[q, m]
    term = contract("qab,qmab->qm", t2c, pre["BLg"])
    Fmi = pre["F_oo"] + jax.ops.segment_sum(
        term, pi, num_segments=no).T        # rows m, cols j
    # Wmnij[q, p] = <mn|ij> + t2c[p] . BEg[p, q]
    Wmnij = pre["ERI_oooo_g"] + contract("pef,pqef->qp", t2c, BEg)

    idx_im, mask_im = pre["idx_im"], pre["mask_im"]
    idx_mj, mask_mj = pre["idx_mj"], pre["mask_mj"]
    im_safe = jnp.where(idx_im >= 0, idx_im, 0)
    mj_safe = jnp.where(idx_mj >= 0, idx_mj, 0)
    # idx_jn[p, n] = pidx[pj[p], n]
    idx_jn = pidx[pj]
    jn_safe = jnp.where(idx_jn >= 0, idx_jn, 0)
    mask_jn = (idx_jn >= 0)
    # idx_nj[p, n] = pidx[n, pj[p]]; idx_in[p, n] = pidx[pi[p], n]
    idx_nj = pidx[:, pj].T
    nj_safe = jnp.where(idx_nj >= 0, idx_nj, 0)
    mask_nj = (idx_nj >= 0)

    # gathered overlaps S[ij, xy-pair]: (P, no, D, D)
    Sjn = Sg[jnp.arange(Sg.shape[0])[:, None], jn_safe] * \
        mask_jn[:, :, None, None]
    Snj = Sg[jnp.arange(Sg.shape[0])[:, None], nj_safe] * \
        mask_nj[:, :, None, None]
    Sim = Sg[jnp.arange(Sg.shape[0])[:, None], im_safe] * \
        mask_im[:, :, None, None]
    Smj = Sg[jnp.arange(Sg.shape[0])[:, None], mj_safe] * \
        mask_mj[:, :, None, None]
    # gathered amplitudes
    t2jn = t2c[jn_safe] * mask_jn[:, :, None, None]      # (P, no, D, D)
    t2nj = t2c[nj_safe] * mask_nj[:, :, None, None]
    t2im = t2c[im_safe] * mask_im[:, :, None, None]
    t2sim = t2sc[im_safe] * mask_im[:, :, None, None]
    t2mj = t2c[mj_safe] * mask_mj[:, :, None, None]

    # W intermediates per (p, m), XE-type gathered per (p, m, n) inside a
    # scan over m so the live gather stays (P, no, D, D)
    G_jn = contract("pnby,pnfy->pnbf", Sjn, t2jn)
    G_nj = contract("pnby,pnfy->pnbf", Snj, t2nj)
    G_jnx = contract("pnby,pnxy->pnbx", Sjn, t2jn)
    idx_in = pidx[pi]
    in_safe = jnp.where(idx_in >= 0, idx_in, 0)
    mask_in = (idx_in >= 0)
    Sin = Sg[jnp.arange(Sg.shape[0])[:, None], in_safe] * \
        mask_in[:, :, None, None]
    t2in = t2c[in_safe] * mask_in[:, :, None, None]
    G_in = contract("pnby,pnxy->pnbx", Sin, t2in)

    XEg, XLg, XE2g, XE3g = pre["XEg"], pre["XLg"], pre["XE2g"], pre["XE3g"]
    W1g, W1jeg, W1ieg = pre["W1g"], pre["W1jeg"], pre["W1ieg"]

    def w_body(m):
        # rows r for this m: r_im[p] = pidx[pi[p], m], etc.
        r_im = im_safe[:, m]
        msk_im = mask_im[:, m][:, None, None]
        # XE[r=(i,m), s=(j,n)] gathered at (p, n): rows r_im[p], cols jn
        XE_pm = XEg[r_im[:, None], jn_safe] * mask_jn[:, :, None, None] \
            * msk_im[:, None]
        Wmbej_m = W1g[:, m] - 0.5 * contract("pnbf,pnef->pbe", G_jn, XE_pm)
        XL_pm = XLg[r_im[:, None], nj_safe] * mask_nj[:, :, None, None] \
            * msk_im[:, None]
        Wmbej_m += 0.5 * contract("pnbf,pnef->pbe", G_nj, XL_pm)
        # XE2[r=(j,n), s=(i,m)]: rows jn, col r_im
        XE2_pm = XE2g[jn_safe, r_im[:, None]] * mask_jn[:, :, None, None] \
            * msk_im[:, None]
        Wmbje_m = -W1jeg[:, m] + 0.5 * contract(
            "pnbx,pnxe->pbe", G_jnx, XE2_pm)
        # XE3[r=(i,n), s=(m,j)]: rows in, col r_mj[p] = pidx[m, pj[p]]
        r_mj = mj_safe[:, m]
        msk_mj = mask_mj[:, m][:, None, None]
        XE3_pm = XE3g[in_safe, r_mj[:, None]] * mask_in[:, :, None, None] \
            * msk_mj[:, None]
        Wmbie_m = -W1ieg[:, m] + 0.5 * contract(
            "pnbx,pnxe->pbe", G_in, XE3_pm)

        # r2 contributions for this m
        D3 = contract("pax,pxy,pby->pab", Sim[:, m], t2im[:, m], Sim[:, m])
        out = -contract("pab,p->pab", D3, Fmi[m, pj])
        D5 = contract("pax,pxe->pae", Sim[:, m], t2sim[:, m])
        out += contract("pae,pbe->pab", D5, Wmbej_m)
        D6 = contract("pax,pxe->pae", Sim[:, m], t2im[:, m])
        out += contract("pae,pbe->pab", D6, Wmbej_m + Wmbje_m)
        D7 = contract("pax,pxe->pae", Smj[:, m], t2mj[:, m])
        out += contract("pae,pbe->pab", D7, Wmbie_m)
        return out

    r2c = jnp.sum(jax.lax.map(w_body, jnp.arange(no)), axis=0)

    # m-independent terms
    diag = jnp.arange(Sg.shape[0])
    r2c += 0.5 * BEg[diag, diag]
    r2c += contract("pae,pbe->pab", t2c, Fae)
    # pair-local vvvv via the diagonal BE-style transform is in VVg —
    # assembled here from Sg-free quantities: VV[p,abef] was precomputed
    # densely in the unscreened path; here contract through the ladder
    r2c += 0.5 * contract("pef,pabef->pab", t2c, pre["VVg"])
    D8 = contract("pqay,qyx,pqbx->pqab", Sg, t2c, Sg)
    r2c += 0.5 * contract("pqab,qp->pab", D8, Wmnij)

    # pair symmetrization: r2[ij] += r2[ji]^T(ab)
    r2c = r2c + r2c[pre["ptrans"]].swapaxes(1, 2)

    # scatter back to the (no, no, D, D) layout; weak rows stay zero
    out = jnp.zeros((no * no,) + r2c.shape[1:], r2c.dtype)
    out = out.at[pi * no + pj].set(r2c)
    return out.reshape(no, no, D, D)


def residuals_ccsd_screened(pre, t1loc, t2r):
    """(r1 (no,D), r2 (no,no,D,D)): lccwfn_local.residuals_ccsd_local over
    the compact strong-pair stacks.  Weak-pair r2 rows return 0 (frozen at
    MP2); couplings through weak pairs are masked out — the standard
    strong/weak partition, exact when pair_cutoff=0."""
    pidx, pi, pj = pre["pidx"], pre["pi"], pre["pj"]
    no, D = t2r.shape[0], t2r.shape[2]
    Sg, TLg, BEg = pre["Sg"], pre["TLg"], pre["BEg"]
    t2c = t2r.reshape(no * no, D, D)[pi * no + pj]
    t2sc = t2c - t2c.swapaxes(1, 2)
    t2s2c = 2.0 * t2c - t2c.swapaxes(1, 2)
    diag = pre["diag"]
    t1i, t1j = t1loc[pi], t1loc[pj]

    # Sb[p, m, a] = S(p, (m,m)) t1[m]  (== Sb_t1mm == Sb_t1nn)
    Sb = contract("pmax,mx->pma", pre["Sdiag_g"], t1loc)

    # ---- Fae (P, D, D)
    ST = contract("pqax,qxy->pqay", Sg, t2c)
    Fae = pre["Fvv"] - contract("pqay,pqey->pae", ST, TLg)
    Fae -= 0.5 * contract("pma,pme->pae", Sb, pre["Fov_g"])
    Fae += contract("mb,pmabe->pae", t1loc, pre["TLm_g"])
    Fae -= 0.5 * contract("pma,nf,pmnef->pae", Sb, t1loc, pre["TLnn_g"])

    # ---- Fmi (no_m, no_j)
    term = contract("qab,qmab->qm", t2c, pre["BLg"])
    Fmi = pre["F_oo"] + jax.ops.segment_sum(term, pi, num_segments=no).T
    Fmi += 0.5 * contract("je,jme->mj", t1loc, pre["FovD"])
    Fmi += contract("ne,mnje->mj", t1loc, pre["LooovD"])
    Fmi += 0.5 * contract("je,nf,mnjef->mj", t1loc, t1loc, pre["TL2"])

    # ---- Fme (P, no_m, D)
    Fme = pre["Fov_g"] + contract("nf,pmnef->pme", t1loc, pre["TLnn_g"])
    FmeD = Fme[diag]                                    # [j, m, e]
    s4 = contract("je,jme->jm", t1loc, FmeD)

    # ---- Wmnij (Q, P)
    Wmnij = pre["ERI_oooo_g"] + contract("pef,pqef->qp", t2c, BEg)
    Wmnij += contract("pe,qpe->qp", t1j, pre["EooovD_g"])
    Wmnij += contract("pe,qpe->qp", t1i, pre["EoovoD_g"])
    Wmnij += contract("pe,pf,qpef->qp", t1i, t1j, pre["TE2_g"])

    # ---- Zmbij (P, no, D)
    Zmb = contract("pef,pmbef->pmb", t2c, pre["EovvvP_g"])
    Zmb += contract("pe,pf,pmbef->pmb", t1i, t1j, pre["Eovvv_iijj_g"])

    # ---- W singles tails, m-resolved (P, no, D, D)
    Wmbej_t1 = contract("pf,pmbef->pmbe", t1j, pre["TE_mbe_g"])
    Wmbej_t1 -= contract("pnb,pmne->pmbe", Sb, pre["Eoovo_g"])
    Wmbej_t1 -= contract("pf,pnb,pmnef->pmbe", t1j, Sb, pre["XEjj_g"])
    Wmbje_t1 = -contract("pf,pmbfe->pmbe", t1j, pre["TE_bFe_g"])
    Wmbje_t1 += contract("pnb,pmne->pmbe", Sb, pre["Eooov_g"])
    Wmbje_t1 += contract("pf,pnb,pmnfe->pmbe", t1j, Sb, pre["XE5_g"])
    Wmbie_t1 = -contract("pf,pmbfe->pmbe", t1i, pre["TE_bFe_mj_g"])
    Wmbie_t1 += contract("pnb,pmne->pmbe", Sb, pre["Eooov_mj_g"])
    Wmbie_t1 += contract("pf,pnb,pmnfe->pmbe", t1i, Sb, pre["XE6_g"])

    # gathered pair indices/masks (as in the CCD body)
    idx_im, mask_im = pre["idx_im"], pre["mask_im"]
    idx_mj, mask_mj = pre["idx_mj"], pre["mask_mj"]
    im_safe = jnp.where(idx_im >= 0, idx_im, 0)
    mj_safe = jnp.where(idx_mj >= 0, idx_mj, 0)
    idx_jn = pidx[pj]
    jn_safe = jnp.where(idx_jn >= 0, idx_jn, 0)
    mask_jn = (idx_jn >= 0)
    idx_nj = pidx[:, pj].T
    nj_safe = jnp.where(idx_nj >= 0, idx_nj, 0)
    mask_nj = (idx_nj >= 0)
    idx_in = pidx[pi]
    in_safe = jnp.where(idx_in >= 0, idx_in, 0)
    mask_in = (idx_in >= 0)

    rowg = jnp.arange(Sg.shape[0])
    Sjn = Sg[rowg[:, None], jn_safe] * mask_jn[:, :, None, None]
    Snj = Sg[rowg[:, None], nj_safe] * mask_nj[:, :, None, None]
    Sim = Sg[rowg[:, None], im_safe] * mask_im[:, :, None, None]
    Smj = Sg[rowg[:, None], mj_safe] * mask_mj[:, :, None, None]
    Sin = Sg[rowg[:, None], in_safe] * mask_in[:, :, None, None]
    t2jn = t2c[jn_safe] * mask_jn[:, :, None, None]
    t2nj = t2c[nj_safe] * mask_nj[:, :, None, None]
    t2im = t2c[im_safe] * mask_im[:, :, None, None]
    t2sim = t2sc[im_safe] * mask_im[:, :, None, None]
    t2mj = t2c[mj_safe] * mask_mj[:, :, None, None]
    t2in = t2c[in_safe] * mask_in[:, :, None, None]

    G_jn = contract("pnby,pnfy->pnbf", Sjn, t2jn)
    G_nj = contract("pnby,pnfy->pnbf", Snj, t2nj)
    G_jnx = contract("pnby,pnxy->pnbx", Sjn, t2jn)
    G_in = contract("pnby,pnxy->pnbx", Sin, t2in)

    XEg, XLg, XE2g, XE3g = pre["XEg"], pre["XLg"], pre["XE2g"], pre["XE3g"]
    W1g, W1jeg, W1ieg = pre["W1g"], pre["W1jeg"], pre["W1ieg"]

    def w_body(m):
        r_im = im_safe[:, m]
        msk_im = mask_im[:, m][:, None, None]
        XE_pm = XEg[r_im[:, None], jn_safe] * mask_jn[:, :, None, None] \
            * msk_im[:, None]
        Wmbej_m = W1g[:, m] + Wmbej_t1[:, m] \
            - 0.5 * contract("pnbf,pnef->pbe", G_jn, XE_pm)
        XL_pm = XLg[r_im[:, None], nj_safe] * mask_nj[:, :, None, None] \
            * msk_im[:, None]
        Wmbej_m += 0.5 * contract("pnbf,pnef->pbe", G_nj, XL_pm)
        XE2_pm = XE2g[jn_safe, r_im[:, None]] * mask_jn[:, :, None, None] \
            * msk_im[:, None]
        Wmbje_m = -W1jeg[:, m] + Wmbje_t1[:, m] + 0.5 * contract(
            "pnbx,pnxe->pbe", G_jnx, XE2_pm)
        r_mj = mj_safe[:, m]
        msk_mj = mask_mj[:, m][:, None, None]
        XE3_pm = XE3g[in_safe, r_mj[:, None]] * mask_in[:, :, None, None] \
            * msk_mj[:, None]
        Wmbie_m = -W1ieg[:, m] + Wmbie_t1[:, m] + 0.5 * contract(
            "pnbx,pnxe->pbe", G_in, XE3_pm)

        D3 = contract("pax,pxy,pby->pab", Sim[:, m], t2im[:, m], Sim[:, m])
        out = -contract("pab,p->pab", D3, Fmi[m, pj] + 0.5 * s4[pj, m])
        D5 = contract("pax,pxe->pae", Sim[:, m], t2sim[:, m])
        out += contract("pae,pbe->pab", D5, Wmbej_m)
        D6 = contract("pax,pxe->pae", Sim[:, m], t2im[:, m])
        out += contract("pae,pbe->pab", D6, Wmbej_m + Wmbje_m)
        D7 = contract("pax,pxe->pae", Smj[:, m], t2mj[:, m])
        out += contract("pae,pbe->pab", D7, Wmbie_m)
        return out

    r2c = jnp.sum(jax.lax.map(w_body, jnp.arange(no)), axis=0)

    # m-independent terms
    r2c += 0.5 * BEg[rowg, rowg]
    r2c += contract("pae,pbe->pab", t2c, Fae)
    r2c += 0.5 * contract("pef,pabef->pab", t2c, pre["VVg"])
    r2c += 0.5 * contract("pe,pf,pabef->pab", t1i, t1j, pre["VV2_g"])
    r2c += contract("pe,pabe->pab", t1i, pre["Evvvo_g"])
    r2c -= 0.5 * contract("pae,pmb,pme->pab", t2c, Sb, Fme)
    r2c -= contract("pma,pmb->pab", Sb, Zmb)
    r2c -= contract("pma,pe,pmbe->pab", Sb, t1i, pre["E9_g"])
    r2c -= contract("pmae,pe,pmb->pab", pre["E11_g"], t1i, Sb)
    r2c -= contract("pma,pmb->pab", Sb, pre["Eovoo_g"])
    D8 = contract("pqay,qyx,pqbx->pqab", Sg, t2c, Sg)
    r2c += 0.5 * contract("pqab,qp->pab", D8, Wmnij)
    r2c += 0.5 * contract("pqa,pqb,qp->pab", Sb[:, pi], Sb[:, pj], Wmnij)

    # pair symmetrization + scatter; weak rows stay zero
    r2c = r2c + r2c[pre["ptrans"]].swapaxes(1, 2)
    out = jnp.zeros((no * no,) + r2c.shape[1:], r2c.dtype)
    out = out.at[pi * no + pj].set(r2c)
    r2 = out.reshape(no, no, D, D)

    # ---- r_T1 (full occupied layout; weak (i,m)/(m,i) couplings masked)
    rng = jnp.arange(no)
    safe_f = jnp.where(pidx >= 0, pidx, 0)
    mask_f = (pidx >= 0).astype(t2r.dtype)
    t2s2_im = t2s2c[safe_f] * mask_f[:, :, None, None]
    t2s2_mi = t2s2c[safe_f.T] * mask_f.T[:, :, None, None]
    Fme_im = Fme[safe_f, rng[None, :]] * mask_f[:, :, None]

    Fae_ii = Fae[diag]
    r1 = pre["Fov_ii"] + contract("ie,iae->ia", t1loc, Fae_ii)
    St1 = contract("imax,mx->ima", pre["Siimm"], t1loc)
    r1 -= contract("ima,mi->ia", St1, Fmi)
    T1a = contract("imax,imxe->imae", pre["Siiim"], t2s2_im)
    r1 += contract("imae,ime->ia", T1a, Fme_im)
    r1 += contract("imaef,imef->ia", pre["Eovvv_mi"], t2s2_mi)
    r1 += contract("nf,inaf->ia", t1loc, pre["Lnvvi"])
    ST1 = contract("iqax,qxe->iqae", Sg[diag], t2c)
    r1 -= contract("iqae,qie->ia", ST1, pre["LoovoD_g"])

    return r1, r2
