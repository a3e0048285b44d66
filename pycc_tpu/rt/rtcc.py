"""Real-time CC propagation driver.

Rebuild of /root/reference/pycc/rt/rtcc.py:13-556.  The ODE right-hand side
f(t, y) — T residuals, Lambda residuals (HBAR rebuilt under the
field-dressed Fock), and the phase quasienergy — is ONE jitted function of
(t, y); an RK step over it is therefore a handful of device dispatches
rather than the reference's per-contraction Python traffic.  f also remains
a plain numpy-compatible callable for scipy.integrate.complex_ode.

Checkpoint/restart mirrors the reference's pickle protocol (chk.pk /
output.pk / t_out.pk) so the test_016-style restart oracle carries over.
"""

import pickle as pk
from os.path import exists

import jax
import jax.numpy as jnp
import numpy as np

from ..cclambda import lambda_residuals_from_F
from ..ccdensity import (build_Doooo, build_Dooov, build_Doovv, build_Dovov,
                         build_Dvvvo, build_Dvvvv, onepdm)
from ..models.ccsd import build_tau, slices
from ..ops.contract import contract


class rtcc:
    """Real-time CC object providing data for an ODE propagator."""

    def __init__(self, ccwfn, cclambda, ccdensity, V, magnetic=False,
                 kick=None, ri_split=False, rhs_split=None):
        self.ccwfn = ccwfn
        self.cclambda = cclambda
        self.ccdensity = ccdensity
        self.V = V
        self.magnetic = bool(magnetic)
        # ri_split: carry the complex amplitudes as (re, im) real pairs so
        # the RHS runs on a backend without complex ops (ops/ctensor.py).  CCD/CC2/CCSD/CC3, canonical or local
        # (the pair-space filter projections are real-linear, so they
        # apply componentwise to the (re, im) pair).
        self.ri_split = bool(ri_split)

        self.mu = ccwfn.H.mu
        if kick:
            s_to_i = {"x": 0, "y": 1, "z": 2}
            self.mu_tot = self.mu[s_to_i[kick.lower()]]
        else:
            self.mu_tot = sum(self.mu) / np.sqrt(3.0)
        if magnetic:
            self.m = ccwfn.H.m

        no, nv = ccwfn.no, ccwfn.nv
        self.no, self.nv = no, nv
        H = ccwfn.H
        model = ccwfn.model
        mu_tot = self.mu_tot
        residual_fn = ccwfn._residual_fn
        use_filter = ccwfn.local is not None
        if use_filter:
            filter_res = ccwfn.Local.filter_res

        len1 = no * nv
        len2 = (no * nv) ** 2
        o, v = slices(no)

        # H enters every jitted function as an ARGUMENT (not a closure
        # constant baked into the compiled program); blocked storage passes the six Dirac blocks;
        # storage='df' passes the Cholesky factor blocks — RT at any
        # size the factors reach, with no four-index object anywhere
        blocked = getattr(ccwfn, "storage", "full") == "blocked"
        dfmode = getattr(ccwfn, "storage", "full") == "df"
        if dfmode:
            from ..cclambda import lambda_residuals_from_F_df
            from ..models.dfccsd import _eri_oooo, cc_energy_df
            from ..models.dfhbar import loovv_df
            if model not in ("CCD", "CC2", "CCSD", "CC3"):
                raise Exception("rtcc over storage='df' supports CCD/CC2/"
                                "CCSD/CC3 only (got %s)." % model)
            self._H_args = (ccwfn.dfb,)
            # the L[o,o,o,o] trace in the phase/lagrangian is
            # field-independent: precompute it from the (real) factors
            _e4 = _eri_oooo(ccwfn.dfb)
            loooo_tr = (2.0 * contract("ijij->", _e4)
                        - contract("ijji->", _e4))
            del _e4
        elif blocked:
            self._H_args = (ccwfn.blocks,)
        else:
            self._H_args = (jnp.asarray(H.ERI), jnp.asarray(H.L))
        Fj = jnp.asarray(H.F)

        def _views(Hargs):
            if blocked:
                from ..models.blocked import blocked_views
                return blocked_views(Hargs[0], no)
            return Hargs

        def _phase(F, t1, t2, L):
            eref = 2.0 * jnp.trace(F[o, o])
            eref -= (loooo_tr if dfmode
                     else contract("ijij->", L[o, o, o, o]))
            if model == "CCD":
                ecc = contract("ijab,ijab->", t2, L[o, o, v, v])
            else:
                ecc = 2.0 * contract("ia,ia->", F[o, v], t1)
                ecc += contract("ijab,ijab->", build_tau(t1, t2), L[o, o, v, v])
            return (eref + ecc) * (-1.0j)

        class _Lw:
            """Constant-slice L shim: the df phase/residual paths only
            ever take the oovv slice."""
            def __init__(self, x):
                self.x = x

            def __getitem__(self, key):
                return self.x

        def _f_core(t, y, *Hargs):
            if dfmode:
                ERI, L = None, _Lw(loovv_df(Hargs[0]))
            else:
                ERI, L = _views(Hargs)
            t1 = y[:len1].reshape(no, nv)
            t2 = y[len1:len1 + len2].reshape(no, no, nv, nv)
            l1 = y[len1 + len2:2 * len1 + len2].reshape(no, nv)
            l2 = y[2 * len1 + len2:-1].reshape(no, no, nv, nv)

            F = Fj.astype(y.dtype) + mu_tot.astype(y.dtype) * self.V(t)

            if dfmode:
                rt1, rt2 = ccwfn._df_residual_fn(F, Hargs[0], t1, t2, no)
            else:
                rt1, rt2 = residual_fn(F, ERI, L, t1, t2, no)
            rt1 = rt1 * (-1.0j)
            rt2 = rt2 * (-1.0j)
            if use_filter:
                rt1, rt2 = filter_res(rt1, rt2)

            if dfmode:
                rl1, rl2 = lambda_residuals_from_F_df(
                    model, F, Hargs[0], t1, t2, l1, l2, no,
                    real_time=ccwfn.real_time, F_ref=Fj)
            else:
                rl1, rl2 = lambda_residuals_from_F(model, F, ERI, L,
                                                   t1, t2, l1, l2, no,
                                                   real_time=ccwfn.real_time,
                                                   F_ref=Fj)
            rl1 = rl1 * (1.0j)
            rl2 = rl2 * (1.0j)
            if use_filter:
                rl1, rl2 = filter_res(rl1, rl2)

            ph = _phase(F, t1, t2, L)
            return jnp.concatenate([rt1.ravel(), rt2.ravel(), rl1.ravel(),
                                    rl2.ravel(), ph.reshape(1)])

        self._f_jit = jax.jit(_f_core)
        if dfmode:
            self._phase_fn = lambda F, t1, t2: _phase(
                F, t1, t2, _Lw(loovv_df(self._H_args[0])))
        else:
            self._phase_fn = lambda F, t1, t2: _phase(
                F, t1, t2, _views(self._H_args)[1])

        def _f_core_ri(t, yri, *Hargs):
            from ..ops.ctensor import CTensor
            if dfmode:
                ERI, L = None, _Lw(loovv_df(Hargs[0]))
            else:
                ERI, L = _views(Hargs)

            def amp(lo, hi, shape):
                return CTensor(yri[0, lo:hi].reshape(shape),
                               yri[1, lo:hi].reshape(shape))

            t1 = amp(0, len1, (no, nv))
            t2 = amp(len1, len1 + len2, (no, no, nv, nv))
            l1 = amp(len1 + len2, 2 * len1 + len2, (no, nv))
            l2 = amp(2 * len1 + len2, 2 * (len1 + len2), (no, no, nv, nv))

            F = Fj + mu_tot.real * self.V(t)  # the field stays real

            def ct_filter(r1, r2):
                fr1, fr2 = filter_res(r1.re, r2.re)
                fi1, fi2 = filter_res(r1.im, r2.im)
                return CTensor(fr1, fi1), CTensor(fr2, fi2)

            if dfmode:
                rt1, rt2 = ccwfn._df_residual_fn(F, Hargs[0], t1, t2, no)
            else:
                rt1, rt2 = residual_fn(F, ERI, L, t1, t2, no)
            rt1 = rt1 * (-1.0j)
            rt2 = rt2 * (-1.0j)
            if use_filter:
                rt1, rt2 = ct_filter(rt1, rt2)
            if dfmode:
                rl1, rl2 = lambda_residuals_from_F_df(
                    model, F, Hargs[0], t1, t2, l1, l2, no,
                    real_time=ccwfn.real_time, F_ref=Fj)
            else:
                rl1, rl2 = lambda_residuals_from_F(model, F, ERI, L,
                                                   t1, t2, l1, l2, no,
                                                   real_time=ccwfn.real_time,
                                                   F_ref=Fj)
            rl1 = rl1 * (1.0j)
            rl2 = rl2 * (1.0j)
            if use_filter:
                rl1, rl2 = ct_filter(rl1, rl2)
            ph = _phase(F, t1, t2, L)
            re = jnp.concatenate([rt1.re.ravel(), rt2.re.ravel(),
                                  rl1.re.ravel(), rl2.re.ravel(),
                                  ph.re.reshape(1)])
            im = jnp.concatenate([rt1.im.ravel(), rt2.im.ravel(),
                                  rl1.im.ravel(), rl2.im.ravel(),
                                  ph.im.reshape(1)])
            return jnp.stack([re, im])

        self._f_ri_jit = jax.jit(_f_core_ri)

        # Host-stepped CC3 RHS: the fused _f_core embeds the whole T3/L3
        # slab scan in ONE minutes-long device program at production
        # sizes.  This path splits the RHS into
        # per-occupied-row dispatches (residuals_cc3_rows +
        # cc3_lambda_extra_rows) around one jitted CCSD-part program.
        # Auto-selected at no^3 nv^3 > 2e8 (ccwfn.t3_scan forces on/off);
        # works for complex and ri_split/CTensor amplitudes.
        big = (no ** 3) * (nv ** 3) > 2e8
        self.host_stepped = (model == "CC3") and (
            big if ccwfn.t3_scan is None else bool(ccwfn.t3_scan))
        if self.host_stepped:
            from ..models.cc3 import (cc3_lambda_extra_rows,
                                      residuals_cc3_rows)

            @jax.jit
            def _f_ccsd_part(F, t1, t2, l1, l2, *Hargs):
                if dfmode:
                    from ..cclambda import lambda_residuals_from_F_df
                    Lv = _Lw(loovv_df(Hargs[0]))
                    rl1, rl2 = lambda_residuals_from_F_df(
                        "CCSD", F, Hargs[0], t1, t2, l1, l2, no)
                else:
                    ERIv, Lv = _views(Hargs)
                    rl1, rl2 = lambda_residuals_from_F("CCSD", F, ERIv, Lv,
                                                       t1, t2, l1, l2, no)
                return rl1, rl2, _phase(F, t1, t2, Lv)

            def _f_rows(t, F, t1, t2, l1, l2):
                kw = dict(real_time=ccwfn.real_time, F_ref=Fj)
                if dfmode:
                    dfb = self._H_args[0]
                    rt1, rt2 = residuals_cc3_rows(
                        F, None, None, t1, t2, no, dfb=dfb,
                        nblocks=getattr(ccwfn, "_df_nblocks", None), **kw)
                    Y1, Y2 = cc3_lambda_extra_rows(F, None, None, t1, t2,
                                                   l1, l2, no, dfb=dfb,
                                                   **kw)
                elif blocked:
                    bl = self._H_args[0]
                    rt1, rt2 = residuals_cc3_rows(F, None, None, t1, t2,
                                                  no, blocks=bl, **kw)
                    Y1, Y2 = cc3_lambda_extra_rows(F, None, None, t1, t2,
                                                   l1, l2, no, blocks=bl,
                                                   **kw)
                else:
                    ERIa, La = self._H_args
                    rt1, rt2 = residuals_cc3_rows(F, ERIa, La, t1, t2,
                                                  no, **kw)
                    Y1, Y2 = cc3_lambda_extra_rows(F, ERIa, La, t1, t2,
                                                   l1, l2, no, **kw)
                rl1, rl2, ph = _f_ccsd_part(F, t1, t2, l1, l2,
                                            *self._H_args)
                return rt1, rt2, rl1 + Y1, rl2 + Y2, ph

            self._f_rows = _f_rows

        # Host-split DF-CCSD RHS: the fused _f_core/_f_core_ri holds the
        # T residual's ~11 o^2v^2 temps AND the Lambda side's rebuilt
        # HBAR in ONE program — 26 GB requested at (32,256) naux=1024
        # ri_split (measured compile OOM).  Past ~100 MB of o^2v^2 the
        # RHS runs as host-sequenced programs instead: the seven-program
        # split CCSD residual (models/dfccsd.residuals_ccsd_df_split,
        # CTensor-polymorphic), the six-program on-the-fly Lambda split
        # (models/dfhbar.lambda_residuals_df_split), and a factor-
        # reassociated phase program.  rhs_split=True/False forces it.
        self.df_split = False
        if dfmode and model == "CCSD" and not self.host_stepped:
            o2v2 = (no * nv) ** 2 * jnp.dtype(ccwfn.t1.dtype).itemsize
            self.df_split = (o2v2 > 1e8 if rhs_split is None
                             else bool(rhs_split))

        if dfmode:
            @jax.jit
            def _phase_df_prog(F, t1, t2, dfb):
                """The _phase scalar with tau.Loovv RE-ASSOCIATED through
                the factors (largest temp (naux, o, v); the o^2v^2 Loovv
                assembly never exists)."""
                eref = 2.0 * jnp.trace(F[o, o]) - loooo_tr
                if model == "CCD":
                    tau, ecc = t2, 0.0
                else:
                    tau = build_tau(t1, t2)
                    ecc = 2.0 * contract("ia,ia->", F[o, v], t1)
                Y = contract("ijab,Pia->Pjb", tau, dfb.Bov)
                s1 = contract("Pjb,Pjb->", Y, dfb.Bov)
                Z = contract("ijab,Pib->Pja", tau, dfb.Bov)
                s2 = contract("Pja,Pja->", Z, dfb.Bov)
                ecc = ecc + 2.0 * s1 - s2
                return (eref + ecc) * (-1.0j)

            self._phase_df_prog = _phase_df_prog

        def _lagrangian(t, t1, t2, l1, l2, *Hargs):
            F = Fj.astype(t1.dtype) + mu_tot.astype(t1.dtype) * self.V(t)
            if dfmode:
                # factor-wise density energy (models/dfdensity.py): the
                # same scalar as the dense branch, no v^4/v^3o object
                from ..models.dfdensity import density_energy_df
                if model == "CC3":
                    # traceable factor-sourced CC3 one-pdm corrections
                    # (the dense branch adds them the same way below)
                    from types import SimpleNamespace
                    from ..models.cc3 import cc3_onepdm_scan
                    shim = SimpleNamespace(no=no, nv=nv, nact=ccwfn.nact,
                                           model="CC3", storage="df",
                                           dfb=Hargs[0],
                                           H=SimpleNamespace(F=Fj))
                    opdm, opdm_cc3 = cc3_onepdm_scan(shim, t1, t2, l1, l2)
                    opdm = opdm + opdm_cc3
                else:
                    opdm = onepdm(model, t1, t2, l1, l2, no, ccwfn.nact)
                eref = 2.0 * jnp.trace(F[o, o]) - loooo_tr
                eone = jnp.sum(F * opdm)
                _, etwo = density_energy_df(F, Hargs[0], t1, t2, l1, l2,
                                            no, model=model)
                return eref + eone + etwo
            ERIv, Lv = _views(Hargs)
            if model == "CC3":
                from ..models.cc3 import cc3_onepdm
                opdm, opdm_cc3 = cc3_onepdm(ccwfn, t1, t2, l1, l2)
                opdm = opdm + opdm_cc3
            else:
                opdm = onepdm(model, t1, t2, l1, l2, no, ccwfn.nact)
            eref = 2.0 * jnp.trace(F[o, o])
            eref -= contract("ijij->", Lv[o, o, o, o])
            eone = jnp.sum(F * opdm)
            ERI = ERIv
            etwo = 0.5 * contract("ijkl,ijkl->", ERI[o, o, o, o],
                                  build_Doooo(model, t1, t2, l2))
            etwo += 0.5 * contract("abcd,abcd->", ERI[v, v, v, v],
                                   build_Dvvvv(model, t1, t2, l2))
            etwo += contract("ijka,ijka->", ERI[o, o, o, v],
                             build_Dooov(model, t1, t2, l1, l2))
            etwo += contract("abci,abci->", ERI[v, v, v, o],
                             build_Dvvvo(model, t1, t2, l1, l2))
            etwo += contract("iajb,iajb->", ERI[o, v, o, v],
                             build_Dovov(model, t1, t2, l1, l2))
            etwo += 0.5 * contract("ijab,ijab->", ERI[o, o, v, v],
                                   build_Doovv(model, t1, t2, l1, l2))
            return eref + eone + etwo

        self._lagrangian_jit = jax.jit(_lagrangian)

        def _dipole(t1, t2, l1, l2, ints0, ints1, ints2):
            opdm = onepdm(model, t1, t2, l1, l2, no, ccwfn.nact)
            # promote (NOT cast to opdm.dtype): the magnetic-dipole integrals
            # are pure imaginary, and real ground-state amplitudes would
            # otherwise truncate them to zero
            dt = jnp.promote_types(opdm.dtype, ints0.dtype)
            return (jnp.sum(ints0.astype(dt) * opdm.astype(dt)),
                    jnp.sum(ints1.astype(dt) * opdm.astype(dt)),
                    jnp.sum(ints2.astype(dt) * opdm.astype(dt)))

        self._dipole_jit = jax.jit(_dipole)

    # ------------------------------------------------------------------
    def f(self, t, y):
        """ODE right-hand side; numpy-compatible for scipy.complex_ode."""
        if getattr(self, "host_stepped", False):
            return self._f_host(t, y)
        if getattr(self, "df_split", False):
            return self._f_host_df(t, y)
        if self.ri_split:
            y = np.asarray(y)
            yri = jnp.stack([jnp.asarray(y.real), jnp.asarray(y.imag)])
            out = np.asarray(self._f_ri_jit(jnp.asarray(t), yri,
                                            *self._H_args))
            return out[0] + 1.0j * out[1]
        return np.asarray(self._f_jit(jnp.asarray(t), jnp.asarray(y),
                                      *self._H_args))

    def _f_host(self, t, y):
        """Host-orchestrated CC3 RHS (per-row device dispatches)."""
        from ..ops.ctensor import CTensor
        no, nv = self.no, self.nv
        len1, len2 = no * nv, (no * nv) ** 2
        y = np.asarray(y)
        Fj = jnp.asarray(self.ccwfn.H.F)
        if self.ri_split:
            def amp(lo, hi, shape):
                blk = y[lo:hi].reshape(shape)
                return CTensor(jnp.asarray(blk.real), jnp.asarray(blk.imag))
            F = Fj + self.mu_tot.real * self.V(t)  # real field
        else:
            def amp(lo, hi, shape):
                return jnp.asarray(y[lo:hi].reshape(shape))
            F = Fj.astype(y.dtype) + self.mu_tot.astype(y.dtype) * self.V(t)
        t1 = amp(0, len1, (no, nv))
        t2 = amp(len1, len1 + len2, (no, no, nv, nv))
        l1 = amp(len1 + len2, 2 * len1 + len2, (no, nv))
        l2 = amp(2 * len1 + len2, 2 * (len1 + len2), (no, no, nv, nv))
        rt1, rt2, rl1, rl2, ph = self._f_rows(t, F, t1, t2, l1, l2)
        if self.ccwfn.local is not None:
            # the pair-space projection is real-linear, so it commutes with
            # the +-1j factors below and applies componentwise to CTensors
            filter_res = self.ccwfn.Local.filter_res
            if self.ri_split:
                def _filt(r1, r2):
                    fr1, fr2 = filter_res(r1.re, r2.re)
                    fi1, fi2 = filter_res(r1.im, r2.im)
                    return CTensor(fr1, fi1), CTensor(fr2, fi2)
            else:
                _filt = filter_res
            rt1, rt2 = _filt(rt1, rt2)
            rl1, rl2 = _filt(rl1, rl2)
        rt1, rt2 = rt1 * (-1.0j), rt2 * (-1.0j)
        rl1, rl2 = rl1 * (1.0j), rl2 * (1.0j)
        if self.ri_split:
            cx = lambda a: (np.asarray(a.re) + 1.0j * np.asarray(a.im)).ravel()
            return np.concatenate([cx(rt1), cx(rt2), cx(rl1), cx(rl2),
                                   cx(ph).reshape(1)])
        return np.concatenate([np.asarray(rt1).ravel(),
                               np.asarray(rt2).ravel(),
                               np.asarray(rl1).ravel(),
                               np.asarray(rl2).ravel(),
                               np.asarray(ph).reshape(1)])

    def _f_host_df(self, t, y):
        """Host-sequenced DF-CCSD RHS at scale (see __init__'s df_split
        note): ~14 short device programs, each <= ~4 o^2v^2 temps, with
        host syncs so no two programs' temps coexist in HBM."""
        from ..models.dfccsd import residuals_ccsd_df_split
        from ..models.dfhbar import lambda_residuals_df_split
        from ..ops.ctensor import CTensor
        no, nv = self.no, self.nv
        len1, len2 = no * nv, (no * nv) ** 2
        y = np.asarray(y)
        Fj = jnp.asarray(self.ccwfn.H.F)
        if self.ri_split:
            def amp(lo, hi, shape):
                blk = y[lo:hi].reshape(shape)
                return CTensor(jnp.asarray(blk.real), jnp.asarray(blk.imag))
            F = Fj + self.mu_tot.real * self.V(t)  # real field
        else:
            def amp(lo, hi, shape):
                return jnp.asarray(y[lo:hi].reshape(shape))
            F = Fj.astype(y.dtype) + self.mu_tot.astype(y.dtype) * self.V(t)
        t1 = amp(0, len1, (no, nv))
        t2 = amp(len1, len1 + len2, (no, no, nv, nv))
        l1 = amp(len1 + len2, 2 * len1 + len2, (no, nv))
        l2 = amp(2 * len1 + len2, 2 * (len1 + len2), (no, no, nv, nv))
        dfb = self._H_args[0]
        nblocks = getattr(self.ccwfn, "_df_nblocks", None)
        rt1, rt2 = residuals_ccsd_df_split(F, dfb, t1, t2, no,
                                           nblocks=nblocks)
        rl1, rl2 = lambda_residuals_df_split(F, dfb, t1, t2, l1, l2, no,
                                             nblocks=nblocks)
        ph = self._phase_df_prog(F, t1, t2, dfb)
        if self.ccwfn.local is not None:
            filter_res = self.ccwfn.Local.filter_res
            if self.ri_split:
                def _filt(r1, r2):
                    fr1, fr2 = filter_res(r1.re, r2.re)
                    fi1, fi2 = filter_res(r1.im, r2.im)
                    return CTensor(fr1, fi1), CTensor(fr2, fi2)
            else:
                _filt = filter_res
            rt1, rt2 = _filt(rt1, rt2)
            rl1, rl2 = _filt(rl1, rl2)
        rt1, rt2 = rt1 * (-1.0j), rt2 * (-1.0j)
        rl1, rl2 = rl1 * (1.0j), rl2 * (1.0j)
        if self.ri_split:
            cx = lambda a: (np.asarray(a.re) + 1.0j * np.asarray(a.im)).ravel()
            return np.concatenate([cx(rt1), cx(rt2), cx(rl1), cx(rl2),
                                   cx(ph).reshape(1)])
        return np.concatenate([np.asarray(rt1).ravel(),
                               np.asarray(rt2).ravel(),
                               np.asarray(rl1).ravel(),
                               np.asarray(rl2).ravel(),
                               np.asarray(ph).reshape(1)])

    def collect_amps(self, t1, t2, l1, l2, phase):
        dtype = "complex128" if self.ccwfn.precision == "DP" else "complex64"
        return np.concatenate((np.asarray(t1), np.asarray(t2),
                               np.asarray(l1), np.asarray(l2), phase),
                              axis=None).astype(dtype)

    def extract_amps(self, y):
        no, nv = self.no, self.nv
        len1 = no * nv
        len2 = (no * nv) ** 2
        y = np.asarray(y)
        t1 = y[:len1].reshape(no, nv)
        t2 = y[len1:len1 + len2].reshape(no, no, nv, nv)
        l1 = y[len1 + len2:2 * len1 + len2].reshape(no, nv)
        l2 = y[2 * len1 + len2:-1].reshape(no, no, nv, nv)
        phase = y[-1]
        return t1, t2, l1, l2, phase

    def dipole(self, t1, t2, l1, l2, magnetic=False, real_time=False):
        cc = self.ccwfn
        if cc.model == "CC3":
            from ..models.cc3 import cc3_onepdm, cc3_onepdm_rows
            big = cc.no ** 3 * cc.nv ** 3 > 2e8
            use_rows = big if cc.t3_scan is None else bool(cc.t3_scan)
            if getattr(cc, "storage", "full") == "df":
                use_rows = True  # the full-tensor path needs the dense ERI
            fn = cc3_onepdm_rows if use_rows else cc3_onepdm
            opdm, opdm_cc3 = fn(cc, jnp.asarray(t1), jnp.asarray(t2),
                                jnp.asarray(l1), jnp.asarray(l2),
                                real_time=real_time)
            ints = self.m if magnetic else self.mu
            from ..ccdensity import build_Moo, build_Mvv
            out = []
            no, nv = self.no, self.nv
            dt = jnp.promote_types(opdm.dtype, ints[0].dtype)
            opdm = opdm.astype(dt)
            opdm_cc3 = opdm_cc3.astype(dt)
            for ax in range(3):
                val = jnp.sum(ints[ax].astype(dt) * opdm)
                M = jnp.zeros_like(ints[ax]).astype(dt)
                M = M.at[:no, :no].set(build_Moo(no, nv, ints[ax], jnp.asarray(t1)))
                M = M.at[-nv:, -nv:].set(build_Mvv(no, nv, ints[ax], jnp.asarray(t1)))
                val += jnp.sum(M * opdm_cc3)
                out.append(complex(val))
            return tuple(out)
        ints = self.m if magnetic else self.mu
        x, y_, z = self._dipole_jit(jnp.asarray(t1), jnp.asarray(t2),
                                    jnp.asarray(l1), jnp.asarray(l2),
                                    ints[0], ints[1], ints[2])
        return complex(x), complex(y_), complex(z)

    def lagrangian(self, t, t1, t2, l1, l2):
        return complex(self._lagrangian_jit(jnp.asarray(t), jnp.asarray(t1),
                                            jnp.asarray(t2), jnp.asarray(l1),
                                            jnp.asarray(l2), *self._H_args))

    def phase(self, F, t1, t2):
        return complex(self._phase_fn(jnp.asarray(F), jnp.asarray(t1),
                                      jnp.asarray(t2)))

    def energy(self, t, t1, t2):
        cc = self.ccwfn
        F = jnp.asarray(cc.H.F).astype(jnp.complex128) + self.mu_tot * self.V(t)
        if getattr(cc, "storage", "full") == "df":
            from ..models.dfccsd import cc_energy_df
            return complex(cc_energy_df(F, cc.dfb, jnp.asarray(t1),
                                        jnp.asarray(t2), cc.no))
        if getattr(cc, "storage", "full") == "blocked":
            from ..models.blocked import blocked_views
            L = blocked_views(cc.blocks, cc.no)[1]
        else:
            L = cc.H.L
        return complex(cc._energy_fn(F, L, jnp.asarray(t1),
                                     jnp.asarray(t2), cc.no))

    def autocorrelation(self, y_left, y_right):
        t1_l, t2_l, l1_l, l2_l, phase_l = self.extract_amps(y_left)
        t1_r, t2_r, l1_r, l2_r, phase_r = self.extract_amps(y_right)
        c = np.einsum
        A = 1
        A += c("ia,ia->", l1_l, t1_r - t1_l)
        A += 0.5 * c("ijab,ijab->", l2_l, t2_r - t2_l)
        A += 0.5 * c("ijab,ia,jb->", l2_l, t1_l, t1_l)
        A += 0.5 * c("ijab,ia,jb->", l2_l, t1_r, t1_r)
        A -= c("ijab,ia,jb->", l2_l, t1_l, t1_r)
        A *= np.exp(-phase_l) * np.exp(phase_r)
        B = 1
        B -= c("ia,ia->", l1_r, t1_r - t1_l)
        B -= 0.5 * c("ijab,ijab->", l2_r, t2_r - t2_l)
        B += 0.5 * c("ijab,ia,jb->", l2_r, t1_r, t1_r)
        B += 0.5 * c("ijab,ia,jb->", l2_r, t1_l, t1_l)
        B -= c("ijab,ia,jb->", l2_r, t1_l, t1_r)
        B *= np.exp(-phase_r) * np.exp(phase_l)
        return 0.5 * A + 0.5 * np.conj(B)

    # ------------------------------------------------------------------
    def step(self, ODE, yi, t, ref=False):
        y = ODE(self.f, t, yi)
        ret = {}
        t1, t2, l1, l2, phase = self.extract_amps(y)
        ret["ecc"] = self.lagrangian(t, t1, t2, l1, l2)
        mu_x, mu_y, mu_z = self.dipole(t1, t2, l1, l2, magnetic=False)
        ret["mu_x"], ret["mu_y"], ret["mu_z"] = mu_x, mu_y, mu_z
        if self.magnetic:
            m_x, m_y, m_z = self.dipole(t1, t2, l1, l2, magnetic=True)
            ret["m_x"], ret["m_y"], ret["m_z"] = m_x, m_y, m_z
        return y, ret

    def propagate(self, ODE, yi, tf, ti=0, ref=False, chk=False, tchk=False,
                  ofile="output.pk", tfile="t_out.pk", cfile="chk.pk", k=2):
        point = 0
        key = "%.*f" % (k, ti)

        if chk:
            if exists(cfile):
                with open(cfile, "rb") as cf:
                    chkp = pk.load(cf)
            else:
                chkp = {}
                np.save("ref_wfn", np.asarray(self.ccwfn.ref.Ca()))
        if chk and exists(ofile):
            with open(ofile, "rb") as of:
                ret = pk.load(of)
        else:
            ret = {key: {}}

        if tchk is not False:
            save_t = True
            if chk and exists(tfile):
                with open(tfile, "rb") as ampf:
                    ret_t = pk.load(ampf)
            else:
                ret_t = {key: None}
            t1, t2, l1, l2, phase = self.extract_amps(yi)
            ret_t[key] = {"t1": t1, "t2": t2, "l1": l1, "l2": l2,
                          "phase": phase}
        else:
            save_t = False

        t1, t2, l1, l2, phase = self.extract_amps(yi)
        ret[key] = {}
        ret[key]["ecc"] = self.lagrangian(ti, t1, t2, l1, l2)
        mu_x, mu_y, mu_z = self.dipole(t1, t2, l1, l2, magnetic=False)
        ret[key]["mu_x"], ret[key]["mu_y"], ret[key]["mu_z"] = mu_x, mu_y, mu_z
        if self.magnetic:
            m_x, m_y, m_z = self.dipole(t1, t2, l1, l2, magnetic=True)
            ret[key]["m_x"], ret[key]["m_y"], ret[key]["m_z"] = m_x, m_y, m_z

        t = ti
        while t < tf:
            point += 1
            y, props = self.step(ODE, yi, t, ref)
            t += ODE.h
            key = "%.*f" % (k, t)
            ret[key] = props
            yi = y
            if chk:
                chkp["y"] = y
                chkp["time"] = t
                with open(ofile, "wb") as of:
                    pk.dump(ret, of, pk.HIGHEST_PROTOCOL)
                with open(cfile, "wb") as cf:
                    pk.dump(chkp, cf, pk.HIGHEST_PROTOCOL)
            if save_t and (point % tchk < 0.0001):
                t1, t2, l1, l2, phase = self.extract_amps(y)
                ret_t[key] = {"t1": t1, "t2": t2, "l1": l1, "l2": l2}
                with open(tfile, "wb") as ampf:
                    pk.dump(ret_t, ampf, pk.HIGHEST_PROTOCOL)

        if save_t:
            return ret, ret_t
        return ret
