"""EOM-CCSD: right-hand Davidson eigensolver over HBAR.

Rebuild of /root/reference/pycc/cceom.py:13-315.  The sigma builds are pure
functions, jit-compiled and vmapped over all subspace vectors at once (the
reference loops states in Python); the small-subspace QR/eig stay on host.
A `dense_matrix` helper materializes the full EOM-CCSD matrix from vmapped
sigmas — used by the test-suite as an internal oracle in place of the
reference's in-test Psi4 EOM run.
"""

import time
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .models.ccsd import slices, vvvv_contract, vvvv_contract_efab
from .ops.contract import contract
from .utils.timing import timers
from .utils.log import logger as log

HARTREE2EV = 27.211386245988


# ----------------------------------------------------------------------
# Device-resident Davidson subspace programs (at-scale path).
#
# A subspace vector is 67 MB at (32,128), and the host-side Davidson
# moves two of them across the host link per sigma vector.  These
# programs keep the subspace blocks
# C and S resident on device (rows >= M are ZERO by invariant, so no
# masking is ever needed) and move only M x M matrices, norms, and the
# tiny eig coefficients to the host.  The reference keeps its
# whole Davidson in host numpy (/root/reference/pycc/cceom.py:114-174).
# ----------------------------------------------------------------------

@jax.jit
def _dev_gram(C, S):
    return jnp.dot(C, S.T)


@jax.jit
def _dev_resid(C, S, aT, E, Dd):
    """Residual rows, their norms, and preconditioned corrections for the
    N tracked roots.  aT is (N, maxMp) zero-padded past M."""
    R = jnp.dot(aT, S) - E[:, None] * jnp.dot(aT, C)
    rn = jnp.sqrt(jnp.sum(R * R, axis=1))
    delta = R / (E[:, None] - Dd[None, :])
    return delta, rn


@jax.jit
def _dev_gs(delta, C, active, rtol):
    """DGKS Gram-Schmidt of the correction rows against the subspace AND
    each other (sequential scan), entirely on device.  Returns the
    orthonormalized candidate rows (zero where dropped/locked), their
    post-projection norms and pre-projection norms; the host applies the
    relative-dependence cutoff from the returned scalars."""
    N, dim = delta.shape

    def body(W, k):
        d = jax.lax.dynamic_slice(delta, (k, 0), (1, dim))[0]
        d0 = jnp.sqrt(jnp.sum(d * d))
        for _ in range(2):
            d = d - jnp.dot(jnp.dot(d, C.T), C)
            d = d - jnp.dot(jnp.dot(d, W.T), W)
        n = jnp.sqrt(jnp.sum(d * d))
        keep = active[k] & (n > rtol * d0)
        row = jnp.where(keep, d / jnp.where(n > 0, n, 1.0),
                        jnp.zeros_like(d))
        W = jax.lax.dynamic_update_slice(W, row[None], (k, 0))
        return W, (n, d0)

    W, (ns, d0s) = jax.lax.scan(body, jnp.zeros_like(delta),
                                jnp.arange(N))
    return W, ns, d0s


@partial(jax.jit, donate_argnums=(0,))
def _dev_append(C, W, src, dst):
    row = jax.lax.dynamic_slice(W, (src, 0), (1, W.shape[1]))
    return jax.lax.dynamic_update_slice(C, row, (dst, 0))


@jax.jit
def _dev_collapse_w(C, aT):
    """Ritz-vector block W = a^T C and its (N, N) overlap for the
    host-side Cholesky orthonormalization at subspace collapse."""
    W = jnp.dot(aT, C)
    return W, jnp.dot(W, W.T)


@partial(jax.jit, donate_argnums=(0,))
def _dev_collapse_apply(C, W, T):
    """C <- zeros with rows [0, N) = T @ W (T = inv(chol(W W^T)))."""
    Cn = jnp.dot(T, W)
    return jax.lax.dynamic_update_slice(jnp.zeros_like(C), Cn, (0, 0))


_dev_zero = jax.jit(lambda X: jnp.zeros_like(X), donate_argnums=0)


@partial(jax.jit, donate_argnums=(0,))
def _dev_set_rows(C, block, at):
    return jax.lax.dynamic_update_slice(C, block, (at, 0))


def sigma1(hb, C1, C2, L, no, aux=None):
    o, v = slices(no)
    s1 = contract("ie,ae->ia", C1, hb.Hvv)
    s1 -= contract("mi,ma->ia", hb.Hoo, C1)
    s1 += 2.0 * contract("maei,me->ia", hb.Hovvo, C1)
    s1 -= contract("maie,me->ia", hb.Hovov, C1)
    s1 += 2.0 * contract("miea,me->ia", C2, hb.Hov)
    s1 -= contract("imea,me->ia", C2, hb.Hov)
    if aux is None:
        s1 += 2.0 * contract("imef,amef->ia", C2, hb.Hvovv)
        s1 -= contract("imef,amfe->ia", C2, hb.Hvovv)
    else:
        # pre-laid Hvovv: the contracted (m,e,f) axes lead, so these are
        # clean (i, mef) x (mef, a) GEMMs — the natural einsum makes XLA
        # copy the ov^3 tensor into an o-minor layout (4x lane padding)
        # per batched sigma vector: an instant HBM OOM at (32,128)
        s1 += 2.0 * contract("imef,mefa->ia", C2, aux["Hv_mefa"])
        s1 -= contract("imef,mefa->ia", C2, aux["Hv_mfea"])
    s1 -= 2.0 * contract("mnie,mnae->ia", hb.Hooov, C2)
    s1 += contract("nmie,mnae->ia", hb.Hooov, C2)
    return s1


def sigma2(hb, C1, C2, L, t2, no, aux=None, skip_vvvv=False):
    o, v = slices(no)
    if aux is None:
        Zvv = 2.0 * contract("amef,mf->ae", hb.Hvovv, C1)
        Zvv -= contract("amfe,mf->ae", hb.Hvovv, C1)
    else:
        # ((a e), (m f)) 2-D forms: the (m, f) contraction is a clean
        # GEMV; the non-adjacent-axes einsum makes XLA relayout the
        # ov^3 operand inside the Davidson's lax.map loop, where the
        # hoisted copy is replicated per trip (2 GB at (32,128))
        nvv = C1.shape[1]
        Zvv = jnp.dot(aux["Hv_ae_mf"], C1.ravel()).reshape(nvv, nvv)
        Zvv = 2.0 * Zvv - jnp.dot(aux["Hv_ae_mf2"],
                                  C1.ravel()).reshape(nvv, nvv)
    Zvv -= contract("nmaf,nmef->ae", C2, L[o, o, v, v])

    Zoo = -2.0 * contract("mnie,ne->mi", hb.Hooov, C1)
    Zoo += contract("nmie,ne->mi", hb.Hooov, C1)
    Zoo -= contract("mnef,inef->mi", L[o, o, v, v], C2)

    if aux is None:
        s2 = contract("ie,abej->ijab", C1, hb.Hvvvo)
    else:
        s2 = contract("ie,ejab->ijab", C1, aux["Hvvvo_ejab"])
    s2 -= contract("mbij,ma->ijab", hb.Hovoo, C1)
    s2 += contract("ijeb,ae->ijab", t2, Zvv)
    s2 += contract("mi,mjab->ijab", Zoo, t2)
    s2 += contract("ijeb,ae->ijab", C2, hb.Hvv)
    s2 -= contract("mi,mjab->ijab", hb.Hoo, C2)
    s2 += 0.5 * contract("mnij,mnab->ijab", hb.Hoooo, C2)
    if not skip_vvvv:
        if aux is None:
            s2 += 0.5 * vvvv_contract(C2, hb.Hvvvv)
        else:
            s2 += 0.5 * vvvv_contract_efab(C2, aux["Hvvvv_efab"])
    s2 -= contract("imeb,maje->ijab", C2, hb.Hovov)
    s2 -= contract("imea,mbej->ijab", C2, hb.Hovvo)
    s2 += 2.0 * contract("miea,mbej->ijab", C2, hb.Hovvo)
    s2 -= contract("miea,mbje->ijab", C2, hb.Hovov)
    return s2 + s2.transpose(1, 0, 3, 2)


class cceom:
    """EOM-CCSD Davidson solver over a converged cchbar."""

    def __init__(self, cchbar):
        self.hbar = cchbar
        cc = cchbar.ccwfn
        self.ccwfn = cc
        self.no, self.nv = cc.no, cc.nv
        hbar_occ = jnp.diag(cchbar.Hoo)
        hbar_vir = jnp.diag(cchbar.Hvv)
        Dia = hbar_occ[:, None] - hbar_vir[None, :]
        Dijab = (hbar_occ[:, None, None, None] + hbar_occ[None, :, None, None]
                 - hbar_vir[None, None, :, None] - hbar_vir[None, None, None, :])
        self.D = np.hstack((np.asarray(Dia).flatten(),
                            np.asarray(Dijab).flatten()))

        hb = cchbar.hbar
        no = cc.no
        nv = cc.nv
        from .models.dfhbar import DFHBar
        if isinstance(hb, DFHBar):
            # factor-implicit sigmas: Hvovv/Hvvvo/Hvvvv never materialize
            # (models/dfhbar.py) — the dense pre-laid aux machinery below
            # is the at-scale fallback for full/blocked storage only
            self._init_df_sigma(hb, cc, no, nv)
            return
        o_, v_ = slices(no)
        # only the oovv block of L is needed by the sigmas; under blocked
        # storage assemble it on device from the oovv Dirac block (no host
        # dense L required at all); otherwise slice the host tensor.  Pass
        # everything as jit ARGUMENTS (no big closure constants)
        if getattr(cc, "storage", "full") == "blocked":
            Loovv = jax.jit(
                lambda x: 2.0 * x - jnp.swapaxes(x, 2, 3))(cc.blocks.oovv)
        else:
            Loovv = jnp.asarray(np.asarray(cc.H.L)[o_, o_, v_, v_])

        class _L:
            def __getitem__(self, key):
                return Loovv

        # pre-lay the two big HBAR tensors so the contracted axes lead
        # (once, at construction): the batched sigmas then avoid per-
        # vector o-minor layout copies of ov^3 tensors (4x lane padding)
        @jax.jit
        def _prelay(Hvovv, Hvvvo, Hvvvv):
            nvv = Hvovv.shape[0]
            noo = Hvovv.shape[1]
            return dict(Hv_mefa=jnp.transpose(Hvovv, (1, 2, 3, 0)),
                        Hv_mfea=jnp.transpose(Hvovv, (1, 3, 2, 0)),
                        # ((a e), (m f)): Hvovv[a,m,e,f] and the fe-swap
                        Hv_ae_mf=jnp.transpose(Hvovv, (0, 2, 1, 3))
                        .reshape(nvv * nvv, noo * nvv),
                        Hv_ae_mf2=jnp.transpose(Hvovv, (0, 3, 1, 2))
                        .reshape(nvv * nvv, noo * nvv),
                        Hvvvo_ejab=jnp.transpose(Hvvvo, (2, 3, 0, 1)),
                        Hvvvv_efab=jnp.transpose(Hvvvv, (2, 3, 0, 1)))

        aux = _prelay(hb.Hvovv, hb.Hvvvo, hb.Hvvvv)
        # the big-system sigma never touches hb.Hvvvv/Hvovv/Hvvvo (the
        # pre-laid aux replaces them) — hand it a slimmed HBAR so those
        # ~1.6 GB of blocks are not resident in the mapped program
        z = jnp.zeros((1, 1, 1, 1), hb.Hvv.dtype)
        hb_slim = type(hb)(*[
            z if name in ("Hvvvv", "Hvovv", "Hvvvo") else getattr(hb, name)
            for name in ("Hov", "Hvv", "Hoo", "Hoooo", "Hvvvv", "Hvovv",
                         "Hooov", "Hovvo", "Hovov", "Hvvvo", "Hovoo")])

        def sig(hb, aux, t2, cvec, skip_vvvv=False):
            C1 = cvec[:no * nv].reshape(no, nv)
            C2 = cvec[no * nv:].reshape(no, no, nv, nv)
            s1 = sigma1(hb, C1, C2, _L(), no, aux=aux)
            s2 = sigma2(hb, C1, C2, _L(), t2, no, aux=aux,
                        skip_vvvv=skip_vvvv)
            return jnp.concatenate([s1.ravel(), s2.ravel()])

        _sig_v = jax.jit(jax.vmap(sig, in_axes=(None, None, None, 0)))

        # Big-system sigma, split into TWO device programs.  Three
        # hard-won rules (each was an HBM compile OOM at (32,128)):
        # (1) the per-vector terms run under lax.map, one vector per
        # trip — a batched evaluation made the compiler broadcast
        # big operand buffers across the batch; (2) the Hvvvv ladder
        # comes OUT of the loop — a while body containing the (v^2, v^2)
        # dot replicates the invariant operand per trip (an 8 GB
        # AllocateBuffer) — and runs as ONE flat (M o^2, v^2) x
        # (v^2, v^2) matmul for the whole subspace in its own dispatch;
        # (3) the mapped program gets a slimmed HBAR and an aux without
        # the ladder tensor, so the two programs' live sets stay apart.
        aux_core = {k: v for k, v in aux.items() if k != "Hvvvv_efab"}

        @jax.jit
        def _sig_one(hb, aux, t2, c):
            return sig(hb, aux, t2, c, skip_vvvv=True)

        def _ladder_add(s_row, c_row, Hefab):
            # lax.scan over ef-chunks of the (v^2, v^2) ladder with a
            # donated accumulator, so only one chunk-sized matmul temp is
            # live at a time.  (The earlier formulation ran 4 host-sync'd
            # quarter dispatches per vector — the full one-shot dot's f32
            # synthesis allocated an 8 GB temp at (32,128); the scan
            # keeps the same q = v^2/8 split inside a single dispatch.)
            C2 = c_row[no * nv:].reshape(no * no, nv * nv)
            H2 = Hefab.reshape(nv * nv, nv * nv)
            n_chunks = 8
            q = -(-(nv * nv) // n_chunks)
            pad = n_chunks * q - nv * nv
            if pad:  # zero-pad the contracted axis (dynamic_slice CLAMPS
                # an out-of-range start, which would double-count the tail)
                H2 = jnp.pad(H2, ((0, pad), (0, 0)))
                C2 = jnp.pad(C2, ((0, 0), (0, pad)))

            def body(acc, s):
                Hh = jax.lax.dynamic_slice(H2, (s, 0), (q, nv * nv))
                Ch = jax.lax.dynamic_slice(C2, (0, s), (no * no, q))
                return acc + jnp.dot(Ch, Hh,
                                     preferred_element_type=acc.dtype), 0.0

            lad, _ = jax.lax.scan(
                body, jnp.zeros((no * no, nv * nv), c_row.dtype),
                q * jnp.arange(n_chunks))
            lad = 0.5 * lad.reshape(no, no, nv, nv)
            lad = lad + lad.transpose(1, 0, 3, 2)
            return s_row.at[no * nv:].add(lad.ravel())

        @partial(jax.jit, donate_argnums=(0,))
        def _ladder_one(s_row, c_row, Hefab):
            return _ladder_add(s_row, c_row, Hefab)

        # sequential sigma on big systems (no*nv^3 heuristic); settable
        self.sigma_sequential = no * nv ** 3 > 2e7
        if self.sigma_sequential:
            # only the slim HBAR + aux survive in the closures: keeping
            # the original Hvvvv/Hvovv/Hvvvo referenced alongside their
            # pre-laid aux forms doubles ~2 GB of residency at (32,128)
            hb = hb_slim

        def sigma(C):
          with timers.time("eom.sigma"):
            M = C.shape[0]
            if self.sigma_sequential:
                # one VECTOR per device dispatch, host-sequenced, with a
                # sync after each: any batched/scanned formulation makes
                # this backend replicate shared operands per trip, and
                # async in-flight workspaces of individually-fitting
                # programs collide in HBM.  The per-vector graphs
                # compile once each (fixed shapes), so no subspace
                # padding is needed — iterate the M real vectors only.
                # The subspace STAYS HOST-SIDE and vectors stream through
                # one at a time: C + S device-resident is ~4 GB at
                # maxM=30, which (with the aux forms) runtime-OOM'd the
                # ladder dispatch at (32,128).
                C = np.asarray(C)
                rows = []
                for k in range(M):
                    ck = jnp.asarray(C[k])
                    r = _sig_one(hb_slim, aux_core, cc.t2, ck)
                    jax.block_until_ready(r)
                    r = _ladder_one(r, ck, aux["Hvvvv_efab"])
                    rows.append(np.asarray(r))
                return np.stack(rows)
            # pad the subspace to the next power-of-two bucket: a growing
            # Davidson subspace otherwise recompiles the vmapped sigma for
            # EVERY new size
            Mp = 1
            while Mp < M:
                Mp *= 2
            if Mp != M:
                C = jnp.concatenate(
                    [jnp.asarray(C),
                     jnp.zeros((Mp - M, C.shape[1]), C.dtype)])
            else:
                C = jnp.asarray(C)
            return _sig_v(hb, aux, cc.t2, C)[:M]

        self._sigma = sigma

        # --- device-resident subspace primitives (rows >= M are zero).
        # The earlier device-resident attempt runtime-OOM'd because the
        # one-shot ladder's 8 GB f32-synthesis temp coexisted with C+S;
        # with the chunk-scanned ladder the residency at (32,128) is
        # ~2x2 GB subspace + 2.4 GB aux + slim HBAR, which fits.
        @partial(jax.jit, donate_argnums=(0,))
        def _srow_core(Sbuf, Cbuf, i, hbS, auxS, t2):
            c = jax.lax.dynamic_slice(
                Cbuf, (i, 0), (1, Cbuf.shape[1]))[0]
            s = sig(hbS, auxS, t2, c, skip_vvvv=True)
            return jax.lax.dynamic_update_slice(Sbuf, s[None], (i, 0))

        @partial(jax.jit, donate_argnums=(0,))
        def _srow_ladder(Sbuf, Cbuf, i, Hefab):
            c = jax.lax.dynamic_slice(
                Cbuf, (i, 0), (1, Cbuf.shape[1]))[0]
            s = jax.lax.dynamic_slice(
                Sbuf, (i, 0), (1, Sbuf.shape[1]))[0]
            s = _ladder_add(s, c, Hefab)
            return jax.lax.dynamic_update_slice(Sbuf, s[None], (i, 0))

        def srow(Sbuf, Cbuf, i):
            Sbuf = _srow_core(Sbuf, Cbuf, i, hb_slim, aux_core, cc.t2)
            jax.block_until_ready(Sbuf)
            return _srow_ladder(Sbuf, Cbuf, i, aux["Hvvvv_efab"])

        self._srow = srow

    # ------------------------------------------------------------------
    def _init_df_sigma(self, hb, cc, no, nv):
        """Sigma closure over the DF-HBAR (storage='df'): per-vector
        factor contractions, vmapped small-system path and host-sequenced
        per-vector big-system path (same dispatch rules as the dense
        sequential sigma — one vector per device program at scale)."""
        from .models.dfhbar import loovv_df, sigma1_df, sigma2_df

        Loovv = jax.jit(loovv_df)(hb.df)

        def sig(dfh, Lo, t1, t2, cvec):
            C1 = cvec[:no * nv].reshape(no, nv)
            C2 = cvec[no * nv:].reshape(no, no, nv, nv)
            s1 = sigma1_df(dfh, C1, C2, Lo, no)
            s2 = sigma2_df(dfh, C1, C2, Lo, t1, t2, no)
            return jnp.concatenate([s1.ravel(), s2.ravel()])

        _sig_v = jax.jit(jax.vmap(sig, in_axes=(None, None, None, None, 0)))
        _sig_one = jax.jit(sig)
        self.sigma_sequential = no * nv ** 3 > 2e7

        def sigma(C):
          with timers.time("eom.sigma"):
            M = C.shape[0]
            C = jnp.asarray(C)
            if self.sigma_sequential:
                rows = []
                for k in range(M):
                    r = _sig_one(hb, Loovv, cc.t1, cc.t2, C[k])
                    jax.block_until_ready(r)
                    rows.append(r)
                return jnp.stack(rows)
            Mp = 1
            while Mp < M:
                Mp *= 2
            if Mp != M:
                C = jnp.concatenate(
                    [C, jnp.zeros((Mp - M, C.shape[1]), C.dtype)])
            return _sig_v(hb, Loovv, cc.t1, cc.t2, C)[:M]

        self._sigma = sigma

        @partial(jax.jit, donate_argnums=(0,))
        def _srow_df(Sbuf, Cbuf, i, dfh, Lo, t1, t2):
            c = jax.lax.dynamic_slice(
                Cbuf, (i, 0), (1, Cbuf.shape[1]))[0]
            s = sig(dfh, Lo, t1, t2, c)
            return jax.lax.dynamic_update_slice(Sbuf, s[None], (i, 0))

        self._srow = (lambda Sbuf, Cbuf, i:
                      _srow_df(Sbuf, Cbuf, i, hb, Loovv, cc.t1, cc.t2))

    # ------------------------------------------------------------------
    def dense_matrix(self):
        """Materialize the full EOM-CCSD matrix (test oracle; small systems)."""
        n = self.no * self.nv + (self.no * self.nv) ** 2
        eye = jnp.eye(n)
        cols = []
        bs = 256
        for i in range(0, n, bs):
            cols.append(np.asarray(self._sigma(eye[i:i + bs])))
        return np.concatenate(cols, axis=0).T

    def release_dense_hbar(self):
        """Free the dense Hvvvv/Hvovv/Hvvvo device blocks of the wrapped
        cchbar.  The at-scale sequential sigma consumes only the pre-laid
        aux layouts built at construction, but the originals stay
        device-resident through the wrapper's references (~1.6 GB at
        (32,128)) and runtime-OOM the ladder dispatch alongside the
        Davidson working set.  Call only when no OTHER consumer (Lambda,
        response) still needs the dense blocks; the HBAR_SS guess and the
        2-index/ovvo blocks survive."""
        import dataclasses
        hb = self.hbar
        if not hasattr(hb, "Hvvvv"):  # DF hbar: nothing dense to free
            return
        z = jnp.zeros((1, 1, 1, 1), jnp.asarray(hb.Hvv).dtype)
        hb.hbar = dataclasses.replace(hb.hbar, Hvvvv=z, Hvovv=z, Hvvvo=z)
        hb.Hvvvv = hb.Hvovv = hb.Hvvvo = z

    def guess(self, M, method):
        hbar = self.hbar
        no, nv = self.no, self.nv
        D = self.D
        method = method.upper()
        if method == "UNIT":
            idx = D[:no * nv].argsort()[::-1][:M]
            c = np.eye(no * nv)[:, idx]
            eps = np.sort(D[:no * nv])[::-1]
        elif method == "CIS":
            F = np.asarray(self.ccwfn.H.F)
            o, v = slices(no)
            if getattr(self.ccwfn, "storage", "full") == "blocked":
                from .models.blocked import BlockedL
                L_voov = np.asarray(jax.jit(
                    lambda b: BlockedL(b, no)[v, o, o, v])(self.ccwfn.blocks))
            else:
                L_voov = np.asarray(self.ccwfn.H.L)[v, o, o, v]
            H = L_voov.swapaxes(0, 1).swapaxes(0, 2).copy()
            H += np.einsum("ab,ij->iajb", F[no:, no:][:nv, :nv], np.eye(no))
            H -= np.einsum("ij,ab->iajb", F[:no, :no], np.eye(nv))
            eps, c = np.linalg.eigh(H.reshape(no * nv, no * nv))
        elif method == "HBAR_SS":
            Hovvo = np.asarray(hbar.Hovvo)
            Hovov = np.asarray(hbar.Hovov)
            H = (2.0 * Hovvo.swapaxes(1, 2).swapaxes(2, 3)
                 - Hovov.swapaxes(1, 3)).copy()
            H += np.einsum("ab,ij->iajb", np.asarray(hbar.Hvv), np.eye(no))
            H -= np.einsum("ij,ab->iajb", np.asarray(hbar.Hoo), np.eye(nv))
            eps, c = np.linalg.eig(H.reshape(no * nv, no * nv))
            idx = eps.argsort()
            eps = eps[idx]
            c = c[:, idx]
        else:
            raise Exception("%s is not a valid choice of initial guess vectors."
                            % method)
        guesses = np.reshape(c.T[:M, :], (M, no, nv)).copy()
        return eps[:M], guesses

    def solve_eom(self, N=1, e_conv=1e-5, r_conv=1e-5, maxiter=100,
                  guess="HBAR_SS", maxM=None, chk=None, chk_every=1,
                  resume=False, device_subspace=None, ritz_out=False):
        """guess: one of the named singles-space guesses ("HBAR_SS" /
        "CIS" / "UNIT") or an (M0, dim) array of full-length start
        vectors (orthonormalized by QR) — the seeding hook used by
        solve_eom_mixed's f64 refinement stage.

        ritz_out=True stashes the N lowest Ritz vectors of the FINAL
        subspace in self.ritz (always done on the host path, where it is
        one small GEMM; opt-in on the device path, where it downloads
        N full-length rows to the host).

        chk=<path.npz> checkpoints the Davidson subspace C (+ energies
        and iteration counter) every chk_every iterations; resume=True
        reloads it and rebuilds the sigma block S with ONE batched sigma
        evaluation (S is not stored — at (32,128) it is as large as the
        subspace itself, and one sigma pass is exactly what an iteration
        would have spent anyway).  Survival infrastructure for the
        hour-class at-scale Davidson runs (PERF.md: 3923 s at (32,128));
        the reference has no solver checkpointing at all.

        device_subspace=True keeps the Davidson subspace blocks C and S
        resident on device (auto when the sequential at-scale sigma is
        selected): each subspace vector is 67 MB at (32,128), and the
        host-side loop moves two of them per sigma."""
        if device_subspace is None:
            device_subspace = (getattr(self, "sigma_sequential", False)
                               and hasattr(self, "_srow"))
        if device_subspace:
            return self._solve_eom_device(
                N=N, e_conv=e_conv, r_conv=r_conv, maxiter=maxiter,
                guess=guess, maxM=maxM, chk=chk, chk_every=chk_every,
                resume=resume, ritz_out=ritz_out)
        import os
        t_init = time.time()
        no, nv = self.no, self.nv
        D = self.D
        s1_len = no * nv
        s2_len = (no * nv) ** 2

        M = N * 2
        if maxM is None:
            maxM = N * 10

        niter0 = 0
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk, as_jax=False)
            C = np.asarray(d["C"])
            niter0 = int(d["niter"])
            log.info("CCEOM resumed from %s at iteration %d (M=%d); "
                     "rebuilding sigma block" % (chk, niter0, C.shape[0]))
        elif not isinstance(guess, str):
            C = np.asarray(guess, dtype=np.float64)
            if C.ndim != 2 or C.shape[1] != s1_len + s2_len:
                raise ValueError(
                    "array guess must be (M0, %d); got %r"
                    % (s1_len + s2_len, C.shape))
            M = C.shape[0]
            C = np.linalg.qr(C.T)[0].T.copy()
        else:
            _, C1 = self.guess(M, guess)
            C = np.hstack((C1.reshape(M, s1_len), np.zeros((M, s2_len))))
            # orthonormalize the initial guesses
            C = np.linalg.qr(C.T)[0].T.copy()
        S = np.asarray(self._sigma(jnp.asarray(C)))
        # the subspace algebra runs in the sigma's own precision: the
        # f64-default np.hstack/np.zeros above otherwise make C (and every
        # C @ S.T / Gram-Schmidt pass) double precision — ~4 GB of host
        # arrays and 2x the single-core flops at (32,128) with maxM=30
        C = np.ascontiguousarray(C, dtype=S.dtype)
        D = D.astype(S.dtype)
        # Gram matrix maintained INCREMENTALLY: a full C @ S.T recompute
        # is O(M^2 dim) on the single host core every iteration (~3e10
        # flops at (32,128) M=30) and dominated the at-scale wall
        G = C @ S.T
        E = np.zeros(N)

        converged = False
        # noise-floor stall detection (same policy as the CC/Lambda
        # solvers): in SP the sigma carries ~1e-6 relative error per
        # element, so the residual NORM of an O(1e7)-dim vector floors
        # around 1e-4..1e-3 — far above a small-system r_conv.  When the
        # energies are converged and the residuals stop improving for
        # three consecutive iterations, stop at the floor instead of
        # churning to maxiter (at (32,128) each iteration is minutes of
        # device time).  self.residual_floor records the plateau.
        self.residual_floor = None
        best_r = np.inf
        best_E = None
        best_dE = np.inf
        stalled = 0
        for niter in range(niter0 + 1, maxiter + 1):
            E_old = E
            M = C.shape[0]
            if chk is not None and (niter - 1) % chk_every == 0:
                from .utils.checkpoint import save_amps
                save_amps(chk, C=C, E=E, niter=niter - 1)

            E, a = np.linalg.eig(G)
            idx = np.real(E).argsort()[:N]
            E = np.real(E[idx])
            a = np.real(a[:, idx])

            r = a.T @ S - np.diag(E) @ a.T @ C
            rnorms = np.linalg.norm(r, axis=1)
            delta = r / np.subtract.outer(E, D)

            dE = E - E_old
            log.info("CCEOM iter %3d: M=%3d  E0=%.10f  |dE|=%.3e  "
                     "max|r|=%.3e  (%.1f s)"
                     % (niter, M, E[0], np.linalg.norm(dE), rnorms.max(),
                        time.time() - t_init))
            if (np.abs(np.linalg.norm(dE)) <= e_conv
                    and np.all(rnorms <= r_conv)):
                converged = True
                break

            if rnorms.max() < 0.98 * best_r:
                best_r = rnorms.max()
                best_E = E.copy()
                best_dE = float(np.linalg.norm(dE))
                stalled = 0
            else:
                stalled += 1
            if (stalled >= 3 and niter >= 6
                    and np.abs(np.linalg.norm(dE)) <= e_conv):
                converged = True
                self.residual_floor = float(rnorms.max())
                log.warning(
                    "CCEOM: residual norms stalled at %.2e (> r_conv=%.1e) "
                    "for 3 iterations with energies converged — stopping "
                    "at the precision noise floor." % (rnorms.max(), r_conv))
                break
            if stalled >= 6 and niter >= 8:
                # hard floor stop: iterating past the precision floor is
                # actively HARMFUL — noise-level corrections leak intruder
                # directions into the subspace and the lowest Ritz values
                # fall toward the operator's spectral bottom (measured at
                # (32,128) f32, 2026-08-19).  Return the best iterate.
                self.residual_floor = float(best_r)
                E = best_E
                # Only call the best iterate CONVERGED when its residual
                # plateau is explainable by the working precision: the
                # expected norm floor of a dim-length vector with ~eps
                # relative per-element sigma error is sqrt(dim)*eps.  A
                # stall far above that (bad guess, intruder state) must
                # surface as converged=False for downstream gating.
                floor_est = np.sqrt(S.shape[1]) * np.finfo(S.dtype).eps
                converged = (best_dE <= max(e_conv, best_r)
                             and best_r <= max(r_conv, 30.0 * floor_est))
                log.warning(
                    "CCEOM: residual norms stopped improving (floor %.2e "
                    "> r_conv=%.1e); returning the best iterate "
                    "(|dE| was %.2e there)." % (best_r, r_conv, best_dE))
                break

            if M >= maxM:
                # collapse to the current best N vectors
                C = np.linalg.qr((a.T @ C).T)[0].T.copy().astype(S.dtype)
                S = np.asarray(self._sigma(jnp.asarray(C)))
                G = C @ S.T
                continue

            # Gram-Schmidt the corrections against the subspace; drop
            # linearly-dependent directions (keeps the subspace full rank,
            # which the reference's QR-phase scheme does not guarantee).
            # The dependence cutoff is RELATIVE to the pre-projection norm
            # (DGKS criterion) — an absolute cutoff discards the small
            # preconditioned corrections of nearly-converged roots and
            # stalls the residual at ~1e-7.  Converged roots are locked.
            added = []
            for k in range(N):
                if rnorms[k] <= r_conv:
                    continue
                d = delta[k]
                d0 = np.linalg.norm(d)
                for _ in range(2):
                    d = d - (d @ C.T) @ C
                    for prev in added:
                        d = d - (d @ prev) * prev
                n = np.linalg.norm(d)
                if n > 1e-4 * d0:
                    added.append(d / n)
            if not added:
                # every correction was linearly dependent on the subspace;
                # trust it only if the residuals are actually small
                converged = bool(np.all(rnorms <= r_conv))
                if not converged:
                    warnings.warn(
                        "CCEOM: correction space exhausted with max residual "
                        "norm %.2e > r_conv=%.1e" % (rnorms.max(), r_conv))
                break
            new = np.array(added, dtype=S.dtype)
            S_new = np.asarray(self._sigma(jnp.asarray(new)))
            # incremental Gram update: only the new rows/columns
            G_right = C @ S_new.T
            C = np.vstack((C, new))
            S = np.vstack((S, S_new))
            G = np.vstack((np.hstack((G, G_right)), new @ S.T))

        self.converged = converged
        # N lowest Ritz vectors of the FINAL subspace (one small host
        # GEMM here): solve_eom_mixed seeds its f64 refinement with them.
        # At a hard floor stop these are the last iterate (the returned
        # E is the tracked best) — adequate as refinement seeds.
        wR, aR = np.linalg.eig(C @ S.T if C.shape[0] != G.shape[0] else G)
        idxR = np.real(wR).argsort()[:N]
        aR = np.real(aR[:, idxR])
        self.ritz = np.ascontiguousarray(aR.T @ C)
        if converged:
            log.info("\nCCEOM converged in %.3f seconds." % (time.time() - t_init))
            log.info("\nState     E_h           eV")
            for state in range(N):
                log.info("  %3d  %12.10f  %12.10f"
                      % (state, E[state], E[state] * HARTREE2EV))
        else:
            warnings.warn("CCEOM did NOT converge in %d iterations "
                          "(|dE|=%.2e)" % (maxiter, np.linalg.norm(E - E_old)))
        return E, C

    def solve_eom_mixed(self, N=1, e_conv=1e-7, r_conv=1e-7, maxiter=100,
                        sp_conv=1e-5, sp_dtype=None, refine_maxiter=None,
                        guess="HBAR_SS", maxM=None, **kw):
        """Mixed-precision EOM-CCSD, same scheme as ccwfn.solve_cc_mixed /
        cclambda.solve_lambda_mixed: rebuild the HBAR at float32, run the
        Davidson to its f32 noise floor (cheap iterations), then rebuild the HBAR at float64 and run
        a short f64 Davidson SEEDED with the floor stage's Ritz vectors.
        The refinement typically needs a handful of iterations (the seeds
        are ~1e-6-accurate), pinning the at-scale root energies past the
        ~1e-3 f32 floor-stop ambiguity.  The reference's Davidson is
        all-f64 host numpy (/root/reference/pycc/cceom.py:140-152).

        Requires a precision='DP' ccwfn (the f64 masters are the
        refinement-stage Hamiltonian); t1/t2 are a fixed PARAMETER of the
        EOM equations, so the exact f64 amplitudes are restored for the
        refinement (the same invariant as solve_lambda_mixed).  Rebuilding
        per stage re-runs cceom.__init__, so the at-scale sequential-sigma
        / device-subspace auto-selection applies independently to each
        stage.  self.hbar is left at the f64 build.

        self.e_sp_floor records the floor-stage roots."""
        cc = self.ccwfn
        if cc.precision != "DP":
            raise Exception("solve_eom_mixed needs a precision='DP' "
                            "ccwfn construction (the f64 masters are the "
                            "refinement-stage Hamiltonian).")
        if getattr(cc, "local", None) is not None:
            raise Exception("solve_eom_mixed supports canonical storage "
                            "modes only.")
        from .cchbar import cchbar as _build_hbar

        sp_dtype = sp_dtype or jnp.float32
        cc._ensure_mixed_masters()
        t1_64, t2_64 = cc.t1, cc.t2
        # ---- f32 floor stage ----
        cc._cast_stage(sp_dtype)
        self.__init__(_build_hbar(cc))
        E_sp, _ = self.solve_eom(N=N, e_conv=sp_conv, r_conv=sp_conv,
                                 maxiter=maxiter, guess=guess, maxM=maxM,
                                 ritz_out=True, **kw)
        self.e_sp_floor = np.array(E_sp)
        seeds = np.asarray(self.ritz, dtype=np.float64)
        # ---- f64 refinement from the floor Ritz vectors ----
        cc._cast_stage(jnp.float64)
        cc.t1, cc.t2 = t1_64, t2_64
        self.__init__(_build_hbar(cc))
        return self.solve_eom(N=N, e_conv=e_conv, r_conv=r_conv,
                              maxiter=refine_maxiter or maxiter,
                              guess=seeds, maxM=maxM, **kw)

    # ------------------------------------------------------------------
    def _solve_eom_device(self, N, e_conv, r_conv, maxiter, guess, maxM,
                          chk, chk_every, resume, ritz_out=False):
        """Davidson with the subspace resident on device.

        Identical algorithm to the host loop above (same guesses, DGKS
        Gram-Schmidt, root locking, collapse, stall detection) but C and
        S live in two fixed-shape (maxM + N, dim) device buffers with
        rows >= M zero by invariant; per-vector sigmas read/write rows in
        place via donation; the host sees only the (M, M) Gram matrix,
        residual norms, and eig coefficients per iteration.  Collapse
        orthonormalizes the Ritz block by symmetric (Loewdin) inverse
        square root of its (N, N) overlap — the tall-skinny QR never runs
        on device (the accelerator this was first written for had none).

        Checkpointing downloads the live rows (M x 67 MB at (32,128),
        ~2 s each warm) — prefer chk_every >= 5 at scale."""
        import os
        t_init = time.time()
        no, nv = self.no, self.nv
        s1_len = no * nv
        dim = s1_len + s1_len ** 2

        M = N * 2
        if maxM is None:
            maxM = N * 10
        maxMp = maxM + N  # collapse fires at M >= maxM, before appends

        t2 = self.ccwfn.t2
        dtype = jnp.asarray(t2).dtype
        Dd = jnp.asarray(self.D, dtype)

        niter0 = 0
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk, as_jax=False)
            C0 = np.asarray(d["C"])
            niter0 = int(d["niter"])
            M = C0.shape[0]
            if M > maxMp:
                # a checkpoint written by the host loop (or a run with a
                # larger maxM) can hold more rows than this run's fixed
                # device buffer; _dev_set_rows would fail at trace time
                # with an opaque dynamic_update_slice error.
                raise ValueError(
                    "EOM checkpoint %s holds M=%d subspace vectors but "
                    "this run's device buffer caps at maxM+N=%d; rerun "
                    "with maxM >= %d or restart without resume."
                    % (chk, M, maxMp, M - N))
            log.info("CCEOM(dev) resumed from %s at iteration %d (M=%d); "
                     "rebuilding sigma block" % (chk, niter0, M))
        elif not isinstance(guess, str):
            C0 = np.asarray(guess, dtype=np.float64)
            if C0.ndim != 2 or C0.shape[1] != dim:
                raise ValueError("array guess must be (M0, %d); got %r"
                                 % (dim, C0.shape))
            M = C0.shape[0]
            if M > maxMp:
                raise ValueError("array guess holds M=%d vectors but the "
                                 "device buffer caps at maxM+N=%d"
                                 % (M, maxMp))
            C0 = np.linalg.qr(C0.T)[0].T.copy()
        else:
            _, C1 = self.guess(M, guess)
            C0 = np.hstack((C1.reshape(M, s1_len),
                            np.zeros((M, dim - s1_len))))
            C0 = np.linalg.qr(C0.T)[0].T.copy()

        C = jnp.zeros((maxMp, dim), dtype)
        C = _dev_set_rows(C, jnp.asarray(C0, dtype), 0)
        del C0
        S = jnp.zeros((maxMp, dim), dtype)
        with timers.time("eom.sigma"):
            for i in range(M):
                S = self._srow(S, C, i)
            jax.block_until_ready(S)

        E = np.zeros(N)
        converged = False
        self.residual_floor = None
        best_r = np.inf
        best_E = None
        best_dE = np.inf
        stalled = 0
        E_old = E
        for niter in range(niter0 + 1, maxiter + 1):
            E_old = E
            if chk is not None and (niter - 1) % chk_every == 0:
                from .utils.checkpoint import save_amps
                save_amps(chk, C=np.asarray(C[:M]), E=E, niter=niter - 1)

            G = np.asarray(_dev_gram(C, S))[:M, :M].astype(np.float64)
            E, a = np.linalg.eig(G)
            idx = np.real(E).argsort()[:N]
            E = np.real(E[idx])
            a = np.real(a[:, idx])
            aT = np.zeros((N, maxMp))
            aT[:, :M] = a.T
            aT = jnp.asarray(aT, dtype)
            Ed = jnp.asarray(E, dtype)

            delta, rn = _dev_resid(C, S, aT, Ed, Dd)
            rnorms = np.asarray(rn).astype(np.float64)

            dE = E - E_old
            log.info("CCEOM iter %3d: M=%3d  E0=%.10f  |dE|=%.3e  "
                     "max|r|=%.3e  (%.1f s)"
                     % (niter, M, E[0], np.linalg.norm(dE), rnorms.max(),
                        time.time() - t_init))
            if (np.abs(np.linalg.norm(dE)) <= e_conv
                    and np.all(rnorms <= r_conv)):
                converged = True
                break

            if rnorms.max() < 0.98 * best_r:
                best_r = rnorms.max()
                best_E = E.copy()
                best_dE = float(np.linalg.norm(dE))
                stalled = 0
            else:
                stalled += 1
            if (stalled >= 3 and niter >= 6
                    and np.abs(np.linalg.norm(dE)) <= e_conv):
                converged = True
                self.residual_floor = float(rnorms.max())
                log.warning(
                    "CCEOM: residual norms stalled at %.2e (> r_conv=%.1e) "
                    "for 3 iterations with energies converged — stopping "
                    "at the precision noise floor." % (rnorms.max(), r_conv))
                break
            if stalled >= 6 and niter >= 8:
                # hard floor stop (see the host loop): past the floor,
                # noise corrections leak intruder directions and the
                # Ritz values fall off the targeted roots
                self.residual_floor = float(best_r)
                E = best_E
                # see the host loop: converged only when the plateau is
                # consistent with the working-precision noise floor
                floor_est = np.sqrt(dim) * np.finfo(np.dtype(dtype)).eps
                converged = (best_dE <= max(e_conv, best_r)
                             and best_r <= max(r_conv, 30.0 * floor_est))
                log.warning(
                    "CCEOM: residual norms stopped improving (floor %.2e "
                    "> r_conv=%.1e); returning the best iterate "
                    "(|dE| was %.2e there)." % (best_r, r_conv, best_dE))
                break

            if M >= maxM:
                # collapse: Loewdin-orthonormalize the N Ritz vectors
                W, Gw = _dev_collapse_w(C, aT)
                w, U = np.linalg.eigh(np.asarray(Gw).astype(np.float64))
                w = np.maximum(w, 1e-12 * max(w.max(), 1.0))
                T = (U / np.sqrt(w)) @ U.T
                C = _dev_collapse_apply(C, W, jnp.asarray(T, dtype))
                S = _dev_zero(S)
                with timers.time("eom.sigma"):
                    for i in range(N):
                        S = self._srow(S, C, i)
                    jax.block_until_ready(S)
                M = N
                continue

            active = rnorms > r_conv  # converged roots are locked
            W, ns, d0s = _dev_gs(delta, C, jnp.asarray(active), 1e-4)
            ns_h = np.asarray(ns).astype(np.float64)
            d0_h = np.asarray(d0s).astype(np.float64)
            kept = [k for k in range(N)
                    if active[k] and ns_h[k] > 1e-4 * d0_h[k]]
            if not kept:
                converged = bool(np.all(rnorms <= r_conv))
                if not converged:
                    warnings.warn(
                        "CCEOM: correction space exhausted with max residual "
                        "norm %.2e > r_conv=%.1e" % (rnorms.max(), r_conv))
                break
            for j, k in enumerate(kept):
                C = _dev_append(C, W, k, M + j)
            with timers.time("eom.sigma"):
                for j in range(len(kept)):
                    S = self._srow(S, C, M + j)
                jax.block_until_ready(S)
            M += len(kept)

        self.converged = converged
        if ritz_out:
            # opt-in on the device path: downloads N full-length rows
            # (N x 67 MB at (32,128)) — solve_eom_mixed pays this once
            Gf = np.asarray(_dev_gram(C, S))[:M, :M].astype(np.float64)
            wR, aR = np.linalg.eig(Gf)
            idxR = np.real(wR).argsort()[:N]
            aTR = np.zeros((N, maxMp))
            aTR[:, :M] = np.real(aR[:, idxR]).T
            W, _ = _dev_collapse_w(C, jnp.asarray(aTR, dtype))
            self.ritz = np.asarray(W)
        if converged:
            log.info("\nCCEOM converged in %.3f seconds." % (time.time() - t_init))
            log.info("\nState     E_h           eV")
            for state in range(N):
                log.info("  %3d  %12.10f  %12.10f"
                      % (state, E[state], E[state] * HARTREE2EV))
        else:
            warnings.warn("CCEOM did NOT converge in %d iterations "
                          "(|dE|=%.2e)" % (maxiter, np.linalg.norm(E - E_old)))
        return E, np.asarray(C[:M])
