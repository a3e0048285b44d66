"""Native local-space CC solver (PNO/PAO/PNO++/CPNO++ amplitudes).

Counterpart of /root/reference/pycc/lccwfn.py:7-785.  Amplitudes live in the
truncated pair-local spaces (padded stacks t1: (no, D), t2: (no^2, D, D)).

CCD and CCSD use the genuinely local-scaling batched pair-space equations
(lccwfn_local.py): per-iteration cost depends on the truncated dimension D,
not nv.  CC2 also runs native local equations (residuals_cc2_local); a
dense-backend path remains as the cross-validation oracle
(canonical residual on back-transformed amplitudes, projected per pair).
Both match the reference's native solver and the `filter=True` simulation
path to machine precision (the cross-validation oracle of
test_032/test_033).
"""

import time
from functools import partial

import jax
import jax.numpy as jnp

from .models import ccsd as eqs
from .models.ccsd import slices
from .utils.log import logger as log


class lccwfn:
    def __init__(self, o, v, no, nv, H, local, model, eref, Local,
                 pair_cutoff=None, mesh=None):
        self.o, self.v = o, v
        self.no, self.nv = no, nv
        self.H = H
        self.local = local
        self.model = model
        self.eref = eref
        self.Local = Local
        self.pair_cutoff = pair_cutoff
        self.mesh = mesh

        # initial local amplitudes: t2[ij] = -ERIoovv_loc[ij](i,j)/denom
        # (lccwfn.py:63-78)
        QLp = Local.QLp  # (no^2, nv, D)
        no_ = no
        ii_idx = jnp.arange(no_) * no_ + jnp.arange(no_)
        eps = Local.epsp  # (no^2, D) padded with large sentinel
        Fdiag = jnp.diag(H.F)
        fo = Fdiag[:no_]
        pair_i = jnp.arange(no_ * no_) // no_
        pair_j = jnp.arange(no_ * no_) % no_

        ERIoovv = H.ERI[o, o, v, v]
        eri_loc = jnp.einsum("pva,pvw,pwb->pab", QLp,
                             ERIoovv.reshape(no_ * no_, nv, nv), QLp)
        Dloc = (eps[:, :, None] + eps[:, None, :]
                - fo[pair_i][:, None, None] - fo[pair_j][:, None, None])
        self.t2 = -eri_loc / Dloc
        self.t1 = jnp.zeros((no_, Local.D2), dtype=H.F.dtype)

        self._pair_i, self._pair_j, self._ii_idx = pair_i, pair_j, ii_idx
        self._Dloc = Dloc
        self._fo = fo

        residual_fn = {"CCD": eqs.residuals_ccd,
                       "CCSD": eqs.residuals_ccsd,
                       "CC2": eqs.residuals_cc2}[model]
        energy_fn = eqs.ccd_energy if model == "CCD" else eqs.cc_energy
        eps_ii = eps[ii_idx]

        # CCD/CCSD: genuinely local-scaling residual evaluation (the
        # per-iteration cost is independent of nv); CC2 uses the dense
        # backend for now.
        self._use_local_eqs = model in ("CCD", "CCSD", "CC2")
        if self._use_local_eqs:
            from . import lccwfn_local as leq
            D2 = Local.D2
            if model in ("CCD", "CCSD") and pair_cutoff is not None:
                # pair-screened compact stacks: P^2 D^2 memory instead of
                # no^4 D^2; weak pairs frozen at local MP2
                from . import lccwfn_screened as seq
                if model == "CCD":
                    self._pre = seq.precompute_ccd_screened(
                        H, Local, no, nv, pair_cutoff)
                    res_fn = lambda pre, t1r, t2r: (
                        None, seq.residuals_ccd_screened(pre, t2r))
                    en_fn = lambda pre, t1r, t2r: seq.energy_ccd_screened(
                        pre, t2r)
                else:
                    self._pre = seq.precompute_ccsd_screened(
                        H, Local, no, nv, pair_cutoff)
                    res_fn = lambda pre, t1r, t2r: \
                        seq.residuals_ccsd_screened(pre, t1r, t2r)
                    en_fn = lambda pre, t1r, t2r: \
                        seq.energy_ccsd_screened(pre, t1r, t2r)
                log.info("pair screening: %d of %d pairs strong "
                         "(cutoff %.1e)" % (self._pre["P"], no * no,
                                            pair_cutoff))
            elif model == "CCD":
                self._pre = leq.precompute_ccd(H, Local, no, nv)
                res_fn = lambda pre, t1r, t2r: (None,
                                                leq.residuals_ccd_local(pre, t2r))
                en_fn = lambda pre, t1r, t2r: leq.energy_ccd_local(pre, t2r)
            else:
                self._pre = leq.precompute_ccsd(H, Local, no, nv)
                _res = (leq.residuals_cc2_local if model == "CC2"
                        else leq.residuals_ccsd_local)
                res_fn = lambda pre, t1r, t2r: _res(pre, t1r, t2r)
                en_fn = lambda pre, t1r, t2r: leq.energy_ccsd_local(
                    pre, t1r, t2r)
            Dloc_r = Dloc.reshape(no, no, D2, D2)
            from .ops.diis import DIIS as _DIIS
            t2r0 = self.t2.reshape(no, no, D2, D2)
            diis_l = _DIIS((self.t1, t2r0), max_diis=8)
            self._diis_local = diis_l
            if mesh is not None:
                # pair-space sharding (SURVEY §7.11): the work-list stacks
                # carry the pair indices in their leading dims — shard
                # them over the mesh and let GSPMD gather the cross-pair
                # couplings (Sr-stitched m,n contractions).  The compact
                # screened stacks (leading P) shard over 'va' only.
                from .parallel import shard_pair_stacks
                self._pre = shard_pair_stacks(self._pre, mesh, no)
                Dloc_r = shard_pair_stacks({"d": Dloc_r}, mesh, no)["d"]
            pre = self._pre

            # pre enters as a jit ARGUMENT (keeps shardings first-class
            # and big closure constants out of the compiled program)
            @jax.jit
            def step_local(pre, t1r, t2r, state, do_extrap):
                r1, r2 = res_fn(pre, t1r, t2r)
                t1n = t1r if r1 is None else t1r + r1 / (fo[:, None] - eps_ii)
                t2n = t2r - r2 / Dloc_r
                rms = jnp.sqrt(jnp.sum(r2 ** 2)
                               + (0.0 if r1 is None else jnp.sum(r1 ** 2)))
                ecc = en_fn(pre, t1n, t2n)
                state = diis_l.push(state, (t1n, t2n), (t1r, t2r))
                t1e, t2e = jax.lax.cond(
                    do_extrap, lambda s: diis_l.extrapolate(s, (t1n, t2n)),
                    lambda s: (t1n, t2n), state)
                return t1e, t2e, state, ecc, rms

            self._step_local = partial(step_local, pre)

            @jax.jit
            def energy_local(t1r, t2r):
                return en_fn(pre, t1r, t2r)

            self._energy_local = energy_local

        def dense_amps(t1loc, t2loc):
            t1 = jnp.einsum("iva,ia->iv", QLp[ii_idx], t1loc)
            t2 = jnp.einsum("pva,pab,pwb->pvw", QLp, t2loc, QLp)
            return t1, t2.reshape(no_, no_, nv, nv)

        def project(r1, r2):
            r1loc = jnp.einsum("iva,iv->ia", QLp[ii_idx], r1)
            r2loc = jnp.einsum("pva,pvw,pwb->pab", QLp,
                               r2.reshape(no_ * no_, nv, nv), QLp)
            return r1loc, r2loc

        from .ops.diis import DIIS
        diis = DIIS((self.t1, self.t2), max_diis=8)
        self._diis = diis

        @jax.jit
        def step(F, ERI, L, t1loc, t2loc, state, do_extrap):
            t1, t2 = dense_amps(t1loc, t2loc)
            r1, r2 = residual_fn(F, ERI, L, t1, t2, no_)
            r1loc, r2loc = project(r1, r2)
            t1n = t1loc + r1loc / (fo[:, None] - eps_ii)
            t2n = t2loc - r2loc / Dloc
            rms = jnp.sqrt(jnp.sum(r1loc ** 2) + jnp.sum(r2loc ** 2))
            t1d, t2d = dense_amps(t1n, t2n)
            ecc = energy_fn(F, L, t1d, t2d, no_)
            # DIIS acceleration over the local amplitudes (the reference's
            # native solver has none, lccwfn.py:45)
            state = diis.push(state, (t1n, t2n), (t1loc, t2loc))
            t1e, t2e = jax.lax.cond(
                do_extrap, lambda s: diis.extrapolate(s, (t1n, t2n)),
                lambda s: (t1n, t2n), state)
            return t1e, t2e, state, ecc, rms

        self._step = step

        @jax.jit
        def energy(F, L, t1loc, t2loc):
            t1, t2 = dense_amps(t1loc, t2loc)
            return energy_fn(F, L, t1, t2, no_)

        self._energy = energy

    def lcc_energy(self, *args):
        if self._use_local_eqs:
            no, D2 = self.no, self.Local.D2
            return float(self._energy_local(self.t1,
                                            self.t2.reshape(no, no, D2, D2)))
        return float(self._energy(self.H.F, self.H.L, self.t1, self.t2))

    def solve_lcc(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                  start_diis=1):
        if self._use_local_eqs:
            return self._solve_lcc_local(e_conv, r_conv, maxiter, max_diis,
                                         start_diis)
        return self._solve_lcc_dense(e_conv, r_conv, maxiter, max_diis,
                                     start_diis)

    def _solve_lcc_local(self, e_conv, r_conv, maxiter, max_diis, start_diis):
        tstart = time.time()
        no, D2 = self.no, self.Local.D2
        t2r = self.t2.reshape(no, no, D2, D2)
        t1r = self.t1
        if self.mesh is not None:
            from .parallel import shard_pair_stacks
            t2r = shard_pair_stacks({"t": t2r}, self.mesh, no)["t"]
        elcc = float(self._energy_local(t1r, t2r))
        log.info("CC Iter %3d: lCC Ecorr = %.15f dE = % .5E MP2" % (0, elcc, -elcc))
        state = self._diis_local.init()
        for niter in range(1, maxiter + 1):
            elcc_last = elcc
            do_ext = (max_diis > 0) and (niter >= start_diis)
            t1r, t2r, state, ecc_j, rms = self._step_local(
                t1r, t2r, state, jnp.asarray(do_ext))
            elcc = float(jnp.real(ecc_j))
            rms = float(rms)
            ediff = elcc - elcc_last
            log.info("lCC Iter %3d: lCC Ecorr = %.15f  dE = % .5E  rms = % .5E"
                  % (niter, elcc, ediff, rms))
            if abs(ediff) < e_conv and rms < r_conv:
                self.t1 = t1r
                self.t2 = t2r.reshape(no * no, D2, D2)
                log.info("\nlCC has converged in %.3f seconds.\n"
                      % (time.time() - tstart))
                log.info("E(REF)  = %20.15f" % self.eref)
                log.info("E(%s) = %20.15f" % (self.local + "-" + self.model, elcc))
                log.info("E(TOT)  = %20.15f" % (elcc + self.eref))
                self.elcc = elcc
                return elcc
        self.t1 = t1r
        self.t2 = t2r.reshape(no * no, D2, D2)
        self.elcc = elcc
        return elcc

    def _solve_lcc_dense(self, e_conv=1e-7, r_conv=1e-7, maxiter=100,
                         max_diis=8, start_diis=1):
        tstart = time.time()
        H = self.H
        elcc = float(self._energy(self.H.F, self.H.L, self.t1, self.t2))
        log.info("CC Iter %3d: lCC Ecorr = %.15f dE = % .5E MP2" % (0, elcc, -elcc))
        state = self._diis.init()
        for niter in range(1, maxiter + 1):
            elcc_last = elcc
            do_ext = (max_diis > 0) and (niter >= start_diis)
            self.t1, self.t2, state, ecc_j, rms = self._step(
                H.F, H.ERI, H.L, self.t1, self.t2, state,
                jnp.asarray(do_ext))
            elcc = float(jnp.real(ecc_j))
            rms = float(rms)
            ediff = elcc - elcc_last
            log.info("lCC Iter %3d: lCC Ecorr = %.15f  dE = % .5E  rms = % .5E"
                  % (niter, elcc, ediff, rms))
            if abs(ediff) < e_conv and rms < r_conv:
                log.info("\nlCC has converged in %.3f seconds.\n"
                      % (time.time() - tstart))
                log.info("E(REF)  = %20.15f" % self.eref)
                log.info("E(%s) = %20.15f" % (self.local + "-" + self.model, elcc))
                log.info("E(TOT)  = %20.15f" % (elcc + self.eref))
                self.elcc = elcc
                return elcc
        self.elcc = elcc
        return elcc
