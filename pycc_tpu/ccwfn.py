"""CC T-amplitude solver driver.

API parity with the reference ccwfn (/root/reference/pycc/ccwfn.py:19-329):
``ccwfn(scf_wfn, model=..., precision=..., local=...)`` then
``solve_cc(e_conv, r_conv, maxiter, max_diis, start_diis)``.

Internals: the Hamiltonian is an immutable pytree of device
arrays, the residual evaluation + Jacobi update + DIIS extrapolation are one
jitted XLA graph (one dispatch per iteration), and the model variant picks
the residual function at trace time.  There is no CPU/GPU split and no
per-contraction data migration.
"""

import os
import time
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .hamiltonian import Hamiltonian, build_hamiltonian
from .models import ccsd as eqs
from .ops.diis import DIIS
from .utils.timing import timers
from .utils.log import logger as log

_VALID_MODELS = ["CCD", "CC2", "CCSD", "CCSD(T)", "CC3"]

_RESIDUALS = {
    "CCD": eqs.residuals_ccd,
    "CC2": eqs.residuals_cc2,
    "CCSD": eqs.residuals_ccsd,
    "CCSD(T)": eqs.residuals_ccsd,
}

_ENERGY = {
    "CCD": eqs.ccd_energy,
    "CC2": eqs.cc_energy,
    "CCSD": eqs.cc_energy,
    "CCSD(T)": eqs.cc_energy,
    "CC3": eqs.cc_energy,
}


@partial(jax.jit, static_argnums=(2, 3, 4))
def _mp2_guess_fused(dfb, F, no, eri_oovv, dtype):
    """MP2 t2 guess from DF factors with the denominator broadcast fused
    into the divide — the t2-sized Dijab buffer never exists on device."""
    eps = jnp.diagonal(F).astype(dtype)
    d = (eps[:no, None, None, None] + eps[None, :no, None, None]
         - eps[None, None, no:, None] - eps[None, None, None, no:])
    return eri_oovv(dfb).astype(dtype) / d


def _mp2_guess_big64(dtype, no, nv):
    """True when the one-shot f64 guess would compile-OOM (see
    _mp2_guess_scan); the f32/bf16 one-shot form is always safe."""
    return dtype == np.float64 and no * no * nv * nv * 8 > 4e8


@partial(jax.jit, static_argnums=(2, 3))
def _mp2_guess_scan(dfb, F, no, dtype):
    """At-scale DP MP2 guess: assemble the oovv block in FLOAT32 and
    widen.  The guess only sets the solver's starting point — every
    stage iterates to a dtype-independent fixed point — so f64 assembly
    buys nothing, and on a backend that emulates f64 (widening every dot
    operand into several f32 copies) it cannot compile at scale.  The f32
    one-shot dot is always safe; the divide runs at
    the target dtype with the denominator broadcast fused (no resident
    Dijab).  (Name kept for the construction-site selection predicate;
    there is no scan any more.)"""
    from .models.dfccsd import _eri_oovv
    eps = jnp.diagonal(F).astype(dtype)

    @jax.jit
    def widen_divide(dfb32, eps):
        eri = _eri_oovv(dfb32).astype(dtype)
        d = (eps[:no, None, None, None] + eps[None, :no, None, None]
             - eps[None, None, no:, None] - eps[None, None, None, no:])
        return eri / d

    dfb32 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.float32), dfb)
    return widen_divide(dfb32, eps)


class ccwfn:
    """An RHF-CC wave function and energy object."""

    def __init__(self, scf_wfn, **kwargs):
        time_init = time.time()

        model = kwargs.pop("model", "CCSD").upper()
        if model not in _VALID_MODELS:
            raise Exception("%s is not an allowed CC model." % model)
        self.model = model
        self.make_t3_density = kwargs.pop("make_t3_density", False)
        # None = auto (per-(i,j) slab scan beyond no^3 nv^3 ~ 2e8);
        # True/False force the scan / full-tensor (T)-density path
        self.t3_scan = kwargs.pop("t3_scan", None)
        # storage='blocked' feeds the iterative solve the six unique Dirac
        # ERI blocks (models/blocked.py) instead of full ERI + L: ~5x less
        # device memory.  storage='df' goes further:
        # a pivoted-Cholesky factorization (ops/cholesky.py) replaces the
        # nact^4 tensors with naux*nact^2 three-index factors and the
        # residuals assemble everything on the fly (models/dfccsd.py) —
        # the route past the dense-ERI memory wall.  'full' is the default.
        storage = kwargs.pop("storage", "full").lower()
        if storage not in ("full", "blocked", "df"):
            raise Exception("%s is not an allowed storage mode." % storage)
        self.storage = storage
        self.df_tol = kwargs.pop("df_tol", 1e-8)
        self._df_nblocks = kwargs.pop("df_nblocks", None)
        # df_direct=True sources the Cholesky factors INTEGRAL-DIRECTLY
        # from AO shell-pair batches (scf/df.py) and never builds a dense
        # ERI on host or device; None = auto (on when the SCF wavefunction
        # carries AO factors, i.e. run_rhf(df=True))
        df_direct = kwargs.pop("df_direct", None)
        if storage == "df":
            if df_direct is None:
                df_direct = getattr(scf_wfn, "B_ao", None) is not None
            self.df_direct = bool(df_direct)
        else:
            self.df_direct = False
        self.real_time = kwargs.pop("real_time", False)
        # mesh: a jax.sharding.Mesh with ('va','vb') axes (parallel.make_mesh)
        # — shards the storage tensors and amplitudes so every jitted solver
        # step runs SPMD with XLA-inserted collectives (SURVEY §7.11)
        self.mesh = kwargs.pop("mesh", None)

        valid_local = [None, "PNO", "PAO", "CPNO++", "PNO++"]
        local = kwargs.pop("local", None)
        if local not in valid_local:
            raise Exception("%s is not an allowed local-CC model." % local)
        self.local = local
        self.local_cutoff = kwargs.pop("local_cutoff", 1e-5)
        # pair_cutoff (local CCD/CCSD): strong-pair screening threshold on
        # the local-MP2 pair energies; weak pairs are frozen at MP2 and the
        # pair-pair stacks compact to the strong list (lccwfn_screened.py)
        self.pair_cutoff = kwargs.pop("pair_cutoff", None)
        self.local_mos = kwargs.pop("local_mos", "PIPEK_MEZEY")
        self.it2_opt = kwargs.pop("it2_opt", True)
        self.filter = kwargs.pop("filter", False)
        if self.pair_cutoff is not None and (local is None
                                             or model not in ("CCD", "CCSD")
                                             or self.filter):
            raise Exception("pair_cutoff requires a native local CCD/CCSD "
                            "run (local=..., model='CCD'|'CCSD', "
                            "filter=False).")

        precision = kwargs.pop("precision", "DP").upper()
        if precision not in ("SP", "DP"):
            raise Exception("%s is not an allowed precision arithmetic." % precision)
        self.precision = precision
        # `device` kept for API parity; placement is governed by JAX/pjit.
        kwargs.pop("device", None)

        self.ref = scf_wfn
        self.eref = scf_wfn.energy()
        self.nfzc = scf_wfn.frzcpi()[0]
        self.no = scf_wfn.doccpi()[0] - self.nfzc
        self.nmo = scf_wfn.nmo()
        self.nv = self.nmo - self.no - self.nfzc
        self.nact = self.no + self.nv

        dtype = jnp.float64 if precision == "DP" else jnp.float32
        if local is not None:
            # localize the active occupied orbitals, then rebuild H in the
            # localized basis (reference flow: ccwfn.py:145-154)
            from .scf import integrals as ints
            from .scf.localize import boys, pipek_mezey
            C_act = np.array(scf_wfn.Ca_subset("AO", "ACTIVE"))
            if self.local_mos == "PIPEK_MEZEY":
                C_act[:, :self.no] = pipek_mezey(C_act[:, :self.no],
                                                 np.asarray(scf_wfn.S_ao),
                                                 scf_wfn.basisset())
            elif self.local_mos == "BOYS":
                dip = ints.dipole(scf_wfn.basisset())
                C_act[:, :self.no] = boys(C_act[:, :self.no], dip)
            else:
                raise Exception("%s is not an allowed MO localization method."
                                % self.local_mos)
            self.C = C_act
            self.H = build_hamiltonian(scf_wfn, C=C_act)
        else:
            # blocked/df storage keeps the dense nact^4 tensors on the host;
            # only the Dirac blocks / Cholesky factors go to the device.
            # df_direct skips the dense tensors ENTIRELY (ERI=L=None).
            self.H = build_hamiltonian(scf_wfn,
                                       host=(storage in ("blocked", "df")),
                                       eri=not self.df_direct)
        if precision == "SP":
            cast = lambda x: None if x is None else x.astype(dtype)
            self.H = Hamiltonian(F=jnp.asarray(self.H.F).astype(dtype),
                                 ERI=cast(self.H.ERI),
                                 L=cast(self.H.L),
                                 mu=self.H.mu, m=self.H.m, p=self.H.p,
                                 Q=self.H.Q, no=self.H.no)
        self.o = slice(0, self.no)
        self.v = slice(self.no, self.nact)

        o, v = self.o, self.v
        self.t1 = jnp.zeros((self.no, self.nv), dtype=dtype)
        if self.df_direct:
            # factors first (the only ERI representation in this mode),
            # then the MP2 guess from the factor-assembled oovv block.
            # Dia/Dijab are NOT materialized in this mode — the t2-sized
            # denominator is a significant device buffer at scale, and
            # every in-solve use fuses a diag(F) broadcast instead; the
            # post-convergence consumers get it lazily via __getattr__.
            self._setup_df_factors(scf_wfn, dtype)
            from .models.dfccsd import _eri_oovv
            if _mp2_guess_big64(np.dtype(dtype), self.no, self.nv):
                self.t2 = _mp2_guess_scan(self.dfb, jnp.asarray(self.H.F),
                                          self.no, dtype)
            else:
                self.t2 = _mp2_guess_fused(self.dfb, jnp.asarray(self.H.F),
                                           self.no, _eri_oovv, dtype)
        else:
            eps = jnp.diag(jnp.asarray(self.H.F))
            self.Dia = (eps[o, None] - eps[None, v]).astype(dtype)
            self.Dijab = (eps[o, None, None, None] + eps[None, o, None, None]
                          - eps[None, None, v, None] - eps[None, None, None, v]).astype(dtype)
            self.t2 = (self.H.ERI[o, o, v, v] / self.Dijab).astype(dtype)

        if local is not None:
            from .local import Local
            self.Local = Local(local, self.C, self.nfzc, self.no, self.nv,
                               self.H, self.local_cutoff, self.it2_opt,
                               wfn=scf_wfn)
            t1g = jnp.zeros((self.no, self.nv), dtype=dtype)
            self.t1, self.t2 = self.Local.filter_amps(t1g, self.H.ERI[o, o, v, v])
            if not self.filter:
                from .lccwfn import lccwfn as _lccwfn
                self.Local.trans_integrals(self.o, self.v)
                if self.pair_cutoff is None:
                    # full no^4 D^2 pair-pair overlap stack — only the
                    # unscreened padded equations index it; the screened
                    # path builds its compact (P,P,D,D) block itself
                    self.Local.overlaps()
                self.lccwfn = _lccwfn(self.o, self.v, self.no, self.nv,
                                      self.H, self.local, self.model,
                                      self.eref, self.Local,
                                      pair_cutoff=self.pair_cutoff,
                                      mesh=self.mesh)

        self._bind_residual_fns()

        if self.storage == "blocked":
            from .models.blocked import ERIBlocks, blocks_from_full
            blocks_np = blocks_from_full(np.asarray(self.H.ERI), self.no)
            self.blocks = ERIBlocks(*(jnp.asarray(b, dtype=dtype)
                                      for b in blocks_np))

        self._df_residual_fn = None
        if self.storage == "df":
            if self.local is not None:
                raise Exception("storage='df' supports canonical models "
                                "only (local correlation uses the "
                                "pair-space solver).")
            from .models import dfccsd as dfq
            if not self.df_direct:
                from .ops.cholesky import cholesky_factor_eri
                B = cholesky_factor_eri(np.asarray(self.H.ERI),
                                        tol=self.df_tol)
                self.naux = B.shape[0]
                self.dfb = dfq.df_blocks(jnp.asarray(B, dtype=dtype),
                                         self.no)
            self._df_residual_fn = self._make_df_residual_fn()
            self._maybe_split_df_residual(dtype)
            log.info("DF/Cholesky factors: naux = %d (tol %.1e%s)"
                  % (self.naux, self.df_tol,
                     ", integral-direct" if self.df_direct else ""))

        if self.mesh is not None:
            if self.local is not None:
                if self.filter or not hasattr(self, "lccwfn"):
                    raise Exception("mesh sharding with local models "
                                    "requires the native pair-space "
                                    "solver (filter=False); the filter-"
                                    "simulation path is dense.")
                # pair-space sharding was applied inside lccwfn
                # (parallel.shard_pair_stacks, SURVEY §7.11)
            else:
                self._apply_mesh(self.mesh)

        log.info("CCWFN object initialized in %.3f seconds." % (time.time() - time_init))

    def _apply_mesh(self, mesh):
        """Distribute the solver state over the device mesh: amplitudes
        and denominators on the t2 sharding, the storage representation
        (full tensors / Dirac blocks / DF factors) on its own layout
        (parallel/mesh.py).  Every subsequent jitted step — solve_cc,
        solve_cc_fused, HBAR, Lambda, EOM sigmas — then compiles SPMD."""
        from jax.sharding import PartitionSpec as P

        from .parallel import shard_amps, shard_blocks, shard_df
        from .parallel.mesh import _put, shard_hamiltonian

        self.t1, self.t2 = shard_amps(self.t1, self.t2, mesh)
        if "Dia" in self.__dict__:   # storage='df' keeps these lazy
            self.Dia = _put(self.Dia, mesh, P())
            self.Dijab = _put(self.Dijab, mesh, P(None, None, "va", "vb"))
        if self.storage == "blocked":
            self.blocks = shard_blocks(self.blocks, mesh)
        elif self.storage == "df":
            self.dfb = shard_df(self.dfb, mesh)
        elif self.H.ERI is not None:
            self.H = shard_hamiltonian(self.H, mesh)

    def _setup_df_factors(self, scf_wfn, dtype):
        """Integral-direct DF setup: AO Cholesky factors (reused from
        run_rhf(df=True) when available and tight enough), MO transform,
        and a second-stage recompression to active-space rank.  No
        four-index tensor exists at any point (contrast the reference,
        /root/reference/pycc/hamiltonian.py:36-39, and this framework's
        own dense-sourced route, ops/cholesky.cholesky_factor_eri)."""
        if self.local is not None:
            raise Exception("df_direct supports canonical models only "
                            "(no dense ERI exists for local=%s)."
                            % self.local)
        from .models import dfccsd as dfq
        from .ops.cholesky import recompress_factors
        from .scf.df import cholesky_factor_ao, factors_to_mo

        B_ao = getattr(scf_wfn, "B_ao", None)
        B_tol = getattr(scf_wfn, "B_tol", None)
        if B_ao is None or B_tol is None or B_tol > self.df_tol:
            B_ao = cholesky_factor_ao(scf_wfn.basisset(), tol=self.df_tol)
        C_act = np.asarray(scf_wfn.Ca_subset("AO", "ACTIVE"))
        B_mo = factors_to_mo(np.asarray(B_ao), C_act)
        B = recompress_factors(B_mo, tol=self.df_tol)
        self.naux = B.shape[0]
        self.dfb = dfq.df_blocks(jnp.asarray(B, dtype=dtype), self.no)

    @classmethod
    def from_df_factors(cls, B, F, no, escf=0.0, model="CCSD",
                        precision="DP", df_nblocks=None, mesh=None,
                        mu=None):
        """Construct a storage='df' solver directly from precomputed
        MO-basis Cholesky/DF factors B (naux, nact, nact) and the active-
        space MO Fock matrix (frozen core already dropped) — the device
        half of the prepare-on-host / solve-on-device pipeline
        (examples/prepare_df_molecule.py writes the .npz this reads).

        The reference cannot represent this state: its Hamiltonian
        requires the dense MO ERI (/root/reference/pycc/hamiltonian.py:36-39)."""
        from .models import dfccsd as dfq

        model = model.upper()
        if model not in ("CCD", "CC2", "CCSD", "CCSD(T)", "CC3"):
            raise Exception("from_df_factors supports canonical "
                            "CCD/CC2/CCSD/CCSD(T)/CC3 only (got %s)."
                            % model)
        precision = precision.upper()
        if precision not in ("SP", "DP"):
            raise Exception("%s is not an allowed precision arithmetic."
                            % precision)
        dtype = jnp.float64 if precision == "DP" else jnp.float32

        self = cls.__new__(cls)
        self.model = model
        self.storage = "df"
        self.df_direct = True
        self.df_tol = None
        self._df_nblocks = df_nblocks
        self.precision = precision
        self.real_time = False
        self.local = None
        self.filter = False
        self.make_t3_density = False
        self.t3_scan = None
        self.ref = None
        self.eref = float(escf)
        self.nfzc = 0
        if precision == "DP":
            # stash the f64 host masters NOW, while B/F are host arrays:
            # solve_cc_mixed's lazy _ensure_mixed_masters would otherwise
            # DOWNLOAD the device factors (4.4 GB at (40,360) naux=3411)
            Bh = np.asarray(B, dtype=np.float64)
            no_ = int(no)
            self._mixed_masters = dict(
                F=np.asarray(F, dtype=np.float64), ERI=None, L=None,
                blocks=None,
                dfb=dfq.DFERI(Boo=Bh[:, :no_, :no_],
                              Bov=Bh[:, :no_, no_:],
                              Bvv=Bh[:, no_:, no_:]),
                mu=(None if mu is None else np.asarray(mu)),
                m=None, p=None, Q=None)
        B = jnp.asarray(B, dtype=dtype)
        F = jnp.asarray(F, dtype=dtype)
        self.no = int(no)
        self.nact = F.shape[0]
        self.nmo = self.nact
        self.nv = self.nact - self.no
        self.naux = B.shape[0]
        # mu: optional (3, nact, nact) MO dipole integrals (response/RT
        # over factors; prepare_df_molecule.py saves them in the .npz)
        if mu is not None:
            mu = jnp.asarray(mu, dtype=dtype)
        self.H = Hamiltonian(F=F, ERI=None, L=None, mu=mu, m=None,
                             p=None, Q=None, no=self.no)
        self.o = slice(0, self.no)
        self.v = slice(self.no, self.nact)
        # no resident Dia/Dijab in DF mode (see __init__/__getattr__)
        self.dfb = dfq.df_blocks(B, self.no)
        self.t1 = jnp.zeros((self.no, self.nv), dtype=dtype)
        if _mp2_guess_big64(np.dtype(dtype), self.no, self.nv):
            self.t2 = _mp2_guess_scan(self.dfb, F, self.no, dtype)
        else:
            self.t2 = _mp2_guess_fused(self.dfb, F, self.no,
                                       dfq._eri_oovv, dtype)
        self._residual_fn = _RESIDUALS.get(self.model)
        self._energy_fn = _ENERGY[self.model]
        self._host_residual_fn = None
        if model == "CC3":
            from .models.cc3 import residuals_cc3_rows
            big = (self.no ** 3) * (self.nv ** 3) > 2e8
            if big:
                self._host_residual_fn = partial(
                    residuals_cc3_rows, real_time=False, F_ref=F,
                    nblocks=df_nblocks)
        self._df_residual_fn = self._make_df_residual_fn()
        self.mesh = mesh
        self._maybe_split_df_residual(dtype)
        if mesh is not None:
            self._apply_mesh(mesh)
        log.info("DF/Cholesky factors: naux = %d (precomputed, %s)"
              % (self.naux, precision))
        return self

    def _bind_residual_fns(self):
        """(Re)bind the model-dispatch residual functions to the CURRENT
        self.H — called at construction and again by solve_cc_mixed after
        each precision cast (the CC3 partials bake F_ref in, and a stale
        f64 F_ref inside an f32 stage would silently upcast the whole
        residual graph)."""
        self._residual_fn = _RESIDUALS.get(self.model)
        self._energy_fn = _ENERGY[self.model]
        self._host_residual_fn = None
        if self.model == "CC3":
            from .models.cc3 import (residuals_cc3, residuals_cc3_rows,
                                     residuals_cc3_scan)
            # pick the occupied-slab T3 path when the full (no^3 nv^3)
            # tensor would be large
            big = (self.no ** 3) * (self.nv ** 3) > 2e8
            fn = residuals_cc3_scan if big else residuals_cc3
            self._residual_fn = partial(fn, real_time=self.real_time,
                                        F_ref=self.H.F)
            # host-orchestrated per-row residual for solve_cc at big sizes
            # (short dispatches instead of one minutes-long program);
            # t3_scan=True/False forces it on/off
            use_rows = big if self.t3_scan is None else bool(self.t3_scan)
            if use_rows:
                self._host_residual_fn = partial(
                    residuals_cc3_rows, real_time=self.real_time,
                    F_ref=self.H.F,
                    nblocks=(self._df_nblocks if self.storage == "df"
                             else None))

    def _maybe_split_df_residual(self, dtype):
        """Past ~1 GB of o^2v^2 the ONE-program DF-CCSD residual compile-
        OOMs (~11 simultaneous o^2v^2 temps: 21.6 GB at (48,432) f32,
        17.7 GB at (32,512) f32 — measured); switch solve_cc to the
        host-sequenced seven-program split (models/dfccsd.py).  The
        (40,360) f32 and (32,512) bf16 steps fit fused and stay fused.
        Re-evaluated per precision stage by solve_cc_mixed (the o^2v^2
        byte count doubles between the f32 floor stage and the f64
        refinement), so a CCSD-family decision may be SET or CLEARED;
        CC3's host-rows binding is never touched (first guard)."""
        if self.model not in ("CCSD", "CCSD(T)"):
            return
        if self.mesh is not None:
            return
        from .models import dfccsd as dfq
        nbytes = (self.no * self.nv) ** 2 * jnp.dtype(dtype).itemsize
        bvv_big = (self.storage == "df" and self.dfb is not None
                   and self.dfb.Bvv.size * self.dfb.Bvv.dtype.itemsize
                   > dfq._GRID_LADDER_BYTES)
        if nbytes > 9e8 or getattr(self, "_force_split_df", False):
            if jnp.dtype(dtype) == jnp.float64 or bvv_big:
                # f64: a backend that emulates f64 widens every f64 dot
                # OPERAND and OUTPUT ~4x natural bytes, so the
                # seven-program split, whose every r2 term is an
                # o^2v^2-output dot, cannot compile there at scale.  Big Bvv (w14-class, > ~3.5 GB
                # even in f32): factors + t1/t2 + r2 leave no room for
                # any extra o^2v^2 coexistence, which the split's
                # programs all need.  The scan formulation keeps every
                # dot on slabs and at most one ring W resident.
                self._host_residual_fn = partial(
                    dfq.residuals_ccsd_df_scan_host)
            else:
                self._host_residual_fn = partial(
                    dfq.residuals_ccsd_df_split_host,
                    nblocks=self._df_nblocks)
        else:
            self._host_residual_fn = None

    def _make_df_residual_fn(self):
        """Model -> factor-residual dispatch for storage='df'.  CC3 uses
        the slab-scanned T3 path over factor-assembled dressed W's
        (models/cc3.residuals_cc3_scan_df) — the reference's CC3 exists
        only as far as the dense ERI reaches
        (/root/reference/pycc/ccwfn.py:371-404 via hamiltonian.py:36)."""
        from .models import dfccsd as dfq

        if self.model == "CC3":
            from .models.cc3 import residuals_cc3_scan_df
            return partial(residuals_cc3_scan_df, real_time=self.real_time,
                           F_ref=self.H.F, nblocks=self._df_nblocks)
        _df_map = {"CCD": dfq.residuals_ccd_df,
                   "CC2": dfq.residuals_cc2_df,
                   "CCSD": dfq.residuals_ccsd_df,
                   "CCSD(T)": dfq.residuals_ccsd_df}
        return partial(_df_map[self.model], nblocks=self._df_nblocks)

    def __getattr__(self, name):
        # storage='df' keeps no resident Dia/Dijab (an o^2v^2 buffer is
        # ~0.8 GB at (40,360) and the solve step fuses its denominators
        # from diag(F) instead).  Post-convergence consumers (Lambda,
        # response, the fused/mixed solvers) materialize them on first
        # touch; cached thereafter.
        if name in ("Dia", "Dijab") and "H" in self.__dict__:
            o, v = self.o, self.v
            dt = self.t1.dtype
            eps = jnp.diag(jnp.asarray(self.H.F))
            if name == "Dia":
                val = (eps[o, None] - eps[None, v]).astype(dt)
            else:
                val = (eps[o, None, None, None] + eps[None, o, None, None]
                       - eps[None, None, v, None]
                       - eps[None, None, None, v]).astype(dt)
            setattr(self, name, val)
            return val
        raise AttributeError(
            "'%s' object has no attribute '%s'" % (type(self).__name__, name))

    def _solver_H(self):
        """(ERI-arg, L-arg) for the jitted solve step: the full tensors,
        the ERIBlocks pytree (+ None) under storage='blocked', or the
        DFERI factor pytree (+ None) under storage='df'."""
        if self.storage == "blocked":
            return self.blocks, None
        if self.storage == "df":
            return self.dfb, None
        return self.H.ERI, self.H.L

    def _df_Loovv(self, dfb=None):
        """L[o,o,v,v] assembled from the Cholesky factors (trace inside
        jit; XLA CSEs it against the residual's own assembly)."""
        from .models.dfccsd import _eri_oovv
        e = _eri_oovv(self.dfb if dfb is None else dfb)
        return 2.0 * e - e.swapaxes(2, 3)

    # ------------------------------------------------------------------
    def residuals(self, F, t1, t2):
        """T1/T2 residuals r_mu = <mu|HBAR|0> for the current amplitudes."""
        if self.storage == "df":
            return self._df_residual_fn(F, self.dfb, t1, t2, self.no)
        return self._residual_fn(F, self.H.ERI, self.H.L, t1, t2, self.no)

    def cc_energy(self, t1, t2, F=None):
        F = self.H.F if F is None else F
        if self.storage == "blocked":
            # avoid staging the full host-side L through the device
            from .models.blocked import blocked_views
            _, bL = blocked_views(self.blocks, self.no)
            return self._energy_fn(jnp.asarray(F), bL, t1, t2, self.no)
        if self.storage == "df":
            nbytes = ((self.no * self.nv) ** 2
                      * jnp.asarray(t2).dtype.itemsize)
            if nbytes > 9e8:
                # at-scale (esp. f64): never assemble the o^2v^2 oovv
                # block (an emulated-f64 backend widens its operands)
                from .models.dfccsd import cc_energy_df_qf
                return jax.jit(cc_energy_df_qf, static_argnums=(4, 5))(
                    jnp.asarray(F), self.dfb, t1, t2, self.no,
                    self.model != "CCD")
            from .models.blocked import LoovvOnly
            return self._energy_fn(jnp.asarray(F),
                                   LoovvOnly(self._df_Loovv(), self.no),
                                   t1, t2, self.no)
        return self._energy_fn(F, self.H.L, t1, t2, self.no)

    # ------------------------------------------------------------------
    def solve_cc(self, e_conv=1e-7, r_conv=1e-7, maxiter=100, max_diis=8,
                 start_diis=1, bf16_until=0.0, stall_limit=10,
                 chk=None, chk_every=10, chk_ring=False, resume=False):
        """Iterate the CC amplitude equations to the requested tolerances.

        chk=<path.npz> auto-saves the solver state every `chk_every`
        iterations (atomically — a kill mid-write never corrupts the last
        good checkpoint); resume=True reloads it and continues from the
        saved iteration.  chk_ring=True also persists the DIIS ring, so a
        resumed solve retraces the uninterrupted trajectory EXACTLY (the
        checkpoint holds the post-extrapolation iterate the next step
        would have consumed); without the ring, DIIS re-warms from empty
        and reaches the same fixed point a few iterations later.  This
        generalizes the reference's RT-only pickle checkpoints
        (/root/reference/pycc/rt/rtcc.py:439-556) to the iterative
        solvers — survival infrastructure for hour-class at-scale runs
        on a runtime whose worker kills/crashes are routine (PERF.md).

        bf16_until > 0 (requires storage='blocked' or 'df', canonical
        CCD/CC2/CCSD) runs the residual contractions from bfloat16
        integral blocks (or bfloat16 Cholesky factors) while
        the amplitude update, DIIS, and energy stay in the working
        precision, switching to full-precision residuals once the residual
        rms drops below the threshold: cheaper early iterations with an
        unchanged fixed point (no reference
        counterpart; the reference's SP mode is all-or-nothing,
        ccwfn.py:177-196)."""
        tstart = time.time()
        no = self.no
        H = self.H
        # Dia/Dijab are only needed by the host-residual (CC3 rows) and
        # bf16 paths; the main device step rebuilds denominators from
        # diag(F) in-fusion.  Touching self.Dijab here would materialize
        # a t2-sized device buffer that storage='df' keeps lazy at scale.
        Dia = Dijab = None
        residual_fn = self._residual_fn
        energy_fn = self._energy_fn
        use_filter = self.local is not None
        if use_filter:
            filter_fn = self.Local.filter_amps

        # max_diis=0 disables DIIS ENTIRELY at trace time: no ring buffers
        # are allocated and no push enters the step graph.  At (48,432)
        # f32 even a depth-1 ring is 3.6 GB of HBM — plain damped Jacobi
        # converges (slower) where the ring does not fit.
        use_diis = max_diis > 0
        diis = DIIS((self.t1, self.t2), max_diis=max(max_diis, 1))
        blocked = self.storage == "blocked"
        host_res = None if use_filter else self._host_residual_fn
        # DF host-residual solves (the CC3-df rows and the split CCSD-df
        # programs) use a LEAN update: denominators rebuilt from diag(F)
        # in-jit and the energy assembled from the factors — no resident
        # Dia/Dijab/Loovv (3.4 GB of o^2v^2 buffers at (48,432) f32 that
        # the split-program temp budget cannot spare).
        lean_df = host_res is not None and self.storage == "df"
        if lean_df:
            from .models.dfccsd import cc_energy_df_qf
            # At f64 scale, keep the energy OUT of the update program:
            # its row-scan (a separate cached compile via cc_energy) is
            # probed to fit, while inlining it here adds the widened
            # per-trip buffers on top of four donated o^2v^2 pairs.
            energy_out = (jnp.dtype(self.t2.dtype) == jnp.float64
                          and (self.no * self.nv) ** 2 * 8 > 9e8)

            @partial(jax.jit, donate_argnums=(2, 3, 4, 5, 6))
            def apply_update_df(F, dfb, t1, t2, r1, r2, state, do_extrap):
                eps = jnp.diagonal(F).astype(t1.dtype)
                inc1 = r1 / (eps[:no, None] - eps[None, no:])
                inc2 = r2 / (eps[:no, None, None, None]
                             + eps[None, :no, None, None]
                             - eps[None, None, no:, None]
                             - eps[None, None, None, no:])
                t1n = t1 + inc1
                t2n = t2 + inc2
                rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                               + jnp.sum(jnp.abs(inc2) ** 2))
                # quadratic-form energy: no o^2v^2 oovv assembly
                # (models/dfccsd.cc_energy_df_qf)
                if energy_out:
                    ecc = jnp.zeros((), t1n.dtype)
                else:
                    ecc = cc_energy_df_qf(F, dfb, t1n, t2n, no,
                                          with_t1=(self.model != "CCD"))
                if not use_diis:
                    # return the pair ONCE: duplicated jit outputs get
                    # DISTINCT buffers (an extra t2-sized copy at scale -
                    # the measured w12 iteration-2 runtime OOM)
                    return t1n, t2n, state, ecc, rms
                state = diis.push(state, (t1n, t2n), (t1, t2))
                t1e, t2e = jax.lax.cond(
                    do_extrap,
                    lambda s: diis.extrapolate(s, (t1n, t2n)),
                    lambda s: (t1n, t2n),
                    state)
                return t1n, t2n, t1e, t2e, state, ecc, rms
        if host_res is not None and not lean_df:
            Dia, Dijab = self.Dia, self.Dijab
            from .models.blocked import LoovvOnly
            o_, v_ = self.o, self.v
            Loovv_f = jnp.asarray(np.asarray(self.H.L)[o_, o_, v_, v_])

            @jax.jit
            def apply_update(F, Loovv, Dia, Dijab, t1, t2, r1, r2, state,
                             do_extrap):
                inc1 = r1 / Dia
                inc2 = r2 / Dijab
                t1n = t1 + inc1
                t2n = t2 + inc2
                rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                               + jnp.sum(jnp.abs(inc2) ** 2))
                ecc = energy_fn(F, LoovvOnly(Loovv, no), t1n, t2n, no)
                if not use_diis:
                    # return the pair ONCE: duplicated jit outputs get
                    # DISTINCT buffers (an extra t2-sized copy at scale -
                    # the measured w12 iteration-2 runtime OOM)
                    return t1n, t2n, state, ecc, rms
                state = diis.push(state, (t1n, t2n), (t1, t2))
                t1e, t2e = jax.lax.cond(
                    do_extrap,
                    lambda s: diis.extrapolate(s, (t1n, t2n)),
                    lambda s: (t1n, t2n),
                    state)
                return t1n, t2n, t1e, t2e, state, ecc, rms
        df_mode = self.storage == "df"
        df_residual_fn = self._df_residual_fn
        use_bf16 = (bf16_until > 0 and (blocked or df_mode)
                    and not use_filter and self.model != "CC3")
        if bf16_until > 0 and not use_bf16:
            raise Exception("bf16_until requires storage='blocked' or "
                            "'df' and a canonical (non-local, non-CC3) "
                            "model.")
        if use_bf16:
            from .models.blocked import LoovvOnly, blocked_views
            if df_mode:
                # bf16 Cholesky factors: half the factor footprint, and
                # the residual/energy assemble everything from them
                if not hasattr(self, "_dfb16"):
                    self._dfb16 = jax.tree_util.tree_map(
                        lambda x: x.astype(jnp.bfloat16), self.dfb)
                H16 = self._dfb16
            else:
                if not hasattr(self, "_blocks16"):
                    self._blocks16 = jax.tree_util.tree_map(
                        lambda x: x.astype(jnp.bfloat16), self.blocks)
                H16 = self._blocks16

            Loovv32 = (None if df_mode
                       else self.H.L[self.o, self.o, self.v, self.v])

            # NOT donated: the noise-floor rollback below needs the
            # pre-step t1/t2/state buffers alive after the call.
            @jax.jit
            def step16(F, H16, Loovv, t1, t2, state, do_extrap):
                if df_mode:
                    F16 = F.astype(jnp.bfloat16)
                    r1, r2 = df_residual_fn(F16, H16,
                                            t1.astype(jnp.bfloat16),
                                            t2.astype(jnp.bfloat16), no)
                    L = LoovvOnly(self._df_Loovv(H16).astype(t2.dtype), no)
                else:
                    bE, bL = blocked_views(H16, no)
                    r1, r2 = residual_fn(F.astype(jnp.bfloat16), bE, bL,
                                         t1.astype(jnp.bfloat16),
                                         t2.astype(jnp.bfloat16), no)
                    L = LoovvOnly(Loovv, no)
                eps = jnp.diagonal(F).astype(t1.dtype)
                inc1 = r1.astype(t1.dtype) / (eps[:no, None]
                                              - eps[None, no:])
                inc2 = r2.astype(t2.dtype) / (eps[:no, None, None, None]
                                              + eps[None, :no, None, None]
                                              - eps[None, None, no:, None]
                                              - eps[None, None, None, no:])
                t1n = t1 + inc1
                t2n = t2 + inc2
                rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                               + jnp.sum(jnp.abs(inc2) ** 2))
                ecc = energy_fn(F, L, t1n, t2n, no)
                if not use_diis:
                    # return the pair ONCE: duplicated jit outputs get
                    # DISTINCT buffers (an extra t2-sized copy at scale -
                    # the measured w12 iteration-2 runtime OOM)
                    return t1n, t2n, state, ecc, rms
                state = diis.push(state, (t1n, t2n), (t1, t2))
                t1e, t2e = jax.lax.cond(
                    do_extrap,
                    lambda s: diis.extrapolate(s, (t1n, t2n)),
                    lambda s: (t1n, t2n),
                    state)
                return t1n, t2n, t1e, t2e, state, ecc, rms

        # Donate the amplitude/DIIS buffers: the new t1/t2/state outputs
        # alias the old ones in-place.  Without this the step's outputs
        # share 0 bytes with its arguments and the DIIS ring is held
        # TWICE — at (no,nv)=(40,360) f32 with max_diis=4 that is 7.8 GB
        # of avoidable device memory.
        # The t2-sized denominator is NOT an argument: it is rebuilt from
        # diag(F) in-step, where the broadcast fuses into the elementwise
        # divide (another o^2v^2 buffer that never exists on device).
        @partial(jax.jit, donate_argnums=(3, 4, 5))
        def step(F, ERI, L, t1, t2, state, do_extrap):
            if blocked:
                from .models.blocked import blocked_views
                ERI, L = blocked_views(ERI, no)
            if df_mode:
                from .models.blocked import LoovvOnly
                r1, r2 = df_residual_fn(F, ERI, t1, t2, no)
                L = LoovvOnly(self._df_Loovv(ERI), no)
            else:
                r1, r2 = residual_fn(F, ERI, L, t1, t2, no)
            if use_filter:
                inc1, inc2 = filter_fn(r1, r2)
            else:
                eps = jnp.diagonal(F).astype(t1.dtype)
                inc1 = r1 / (eps[:no, None] - eps[None, no:])
                inc2 = r2 / (eps[:no, None, None, None]
                             + eps[None, :no, None, None]
                             - eps[None, None, no:, None]
                             - eps[None, None, None, no:])
            t1n = t1 + inc1
            t2n = t2 + inc2
            rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                           + jnp.sum(jnp.abs(inc2) ** 2))
            ecc = energy_fn(F, L, t1n, t2n, no)
            if not use_diis:
                return t1n, t2n, state, ecc, rms
            # DIIS error = the Jacobi increment (new - the amplitudes this
            # iteration actually started from, i.e. post-extrapolation).
            state = diis.push(state, (t1n, t2n), (t1, t2))
            t1e, t2e = jax.lax.cond(
                do_extrap,
                lambda s: diis.extrapolate(s, (t1n, t2n)),
                lambda s: (t1n, t2n),
                state)
            return t1n, t2n, t1e, t2e, state, ecc, rms

        # checkpoint resume: reload the saved post-extrapolation iterate
        # (and, when present, the DIIS ring) and continue the counter
        niter0 = 0
        chk_state = None
        if resume and chk is not None and os.path.exists(chk):
            from .utils.checkpoint import load_amps
            d = load_amps(chk)
            wdt = self.t1.dtype
            self.t1 = d["t1"].astype(wdt)
            self.t2 = d["t2"].astype(wdt)
            niter0 = int(d["niter"])
            if "diis_amps" in d and use_diis:
                chk_state = d
            log.info("CCWFN resumed from %s at iteration %d%s"
                     % (chk, niter0,
                        " (with DIIS ring)" if chk_state else ""))

        # The first donated step call consumes the self.t1/self.t2 buffers
        # themselves (a defensive copy would be another t2-sized buffer at
        # scale); the attributes are rebound to the fresh outputs every
        # iteration below, so they stay valid across stalls and re-solves.
        t1, t2 = self.t1, self.t2
        # heartbeat BEFORE the first device dispatch: at scale the first
        # energy/step compiles queue server-side for many minutes — an
        # at-scale log that stops here is compiling, not wedged
        log.info("solve_cc: dispatching first energy/step programs "
                 "(compiles on a cold cache)...")
        ecc = float(jnp.real(self.cc_energy(t1, t2)))
        log.info("CC Iter %3d: CC Ecorr = %.15f  dE = % .5E  MP2" % (niter0, ecc, -ecc))
        # None is an empty pytree: with DIIS disabled the step functions
        # never touch it and no ring buffer ever reaches the device
        state = diis.init() if use_diis else None
        if chk_state is not None:
            from .ops.diis import DIISState
            if chk_state["diis_amps"].shape[0] != state.amps.shape[0]:
                # a checkpoint written with a different max_diis would
                # silently run at the old depth (or trip an opaque shape
                # error in the jitted step) — start from an empty ring
                log.warning(
                    "CCWFN resume: checkpoint DIIS ring depth %d != "
                    "current max_diis ring depth %d; starting with an "
                    "empty ring (amplitudes are restored)."
                    % (chk_state["diis_amps"].shape[0], state.amps.shape[0]))
            else:
                state = DIISState(
                    amps=jnp.asarray(chk_state["diis_amps"]).astype(state.amps.dtype),
                    errs=jnp.asarray(chk_state["diis_errs"]).astype(state.errs.dtype),
                    count=jnp.asarray(int(chk_state["diis_count"]), jnp.int32))
        rms = float("inf")
        bf16_active = use_bf16
        best_rms = float("inf")
        stalled = 0
        for niter in range(niter0 + 1, maxiter + 1):
          with timers.time("ccwfn.iteration"):
            ecc_last = ecc
            do_ext = (max_diis > 0) and (niter >= start_diis)
            if bf16_active and rms <= bf16_until:
                bf16_active = False
            if bf16_active:
                prev = (rms, t1, t2, state)
                if use_diis:
                    t1n, t2n, t1, t2, state, ecc_j, rms = step16(
                        H.F, H16, Loovv32, t1, t2, state,
                        jnp.asarray(do_ext))
                else:
                    t1n, t2n, state, ecc_j, rms = step16(
                        H.F, H16, Loovv32, t1, t2, state,
                        jnp.asarray(do_ext))
                    t1, t2 = t1n, t2n
                rms = float(rms)
                # bf16 noise floor: once the residual stops improving (or
                # goes non-finite), DIIS would be extrapolating on noise
                # and can diverge — roll back one step and hand over to
                # full precision permanently
                if not np.isfinite(rms) or rms >= prev[0]:
                    log.info("CC Iter %3d: bf16 stage hit its noise floor "
                          "(rms % .3E); switching to full precision"
                          % (niter, rms))
                    bf16_active = False
                    rms, t1, t2, state = prev
            if not bf16_active and host_res is not None:
                Fj = jnp.asarray(H.F)
                if df_mode:
                    r1, r2 = host_res(Fj, None, None, t1, t2, no,
                                      dfb=self.dfb)
                    if use_diis:
                        (t1n, t2n, t1, t2, state, ecc_j,
                         rms) = apply_update_df(Fj, self.dfb, t1, t2, r1,
                                                r2, state,
                                                jnp.asarray(do_ext))
                    else:
                        t1n, t2n, state, ecc_j, rms = apply_update_df(
                            Fj, self.dfb, t1, t2, r1, r2, state,
                            jnp.asarray(do_ext))
                        t1, t2 = t1n, t2n
                    if energy_out:
                        # separate cached row-scan energy program (the
                        # inlined form would OOM the update's compile
                        # at f64 scale)
                        ecc_j = self.cc_energy(t1n, t2n, F=Fj)
                elif blocked:
                    r1, r2 = host_res(Fj, None, None, t1, t2, no,
                                      blocks=self.blocks)
                    if use_diis:
                        t1n, t2n, t1, t2, state, ecc_j, rms = apply_update(
                            Fj, Loovv_f, Dia, Dijab, t1, t2, r1, r2, state,
                            jnp.asarray(do_ext))
                    else:
                        t1n, t2n, state, ecc_j, rms = apply_update(
                            Fj, Loovv_f, Dia, Dijab, t1, t2, r1, r2, state,
                            jnp.asarray(do_ext))
                        t1, t2 = t1n, t2n
                else:
                    r1, r2 = host_res(Fj, H.ERI, H.L, t1, t2, no)
                    if use_diis:
                        t1n, t2n, t1, t2, state, ecc_j, rms = apply_update(
                            Fj, Loovv_f, Dia, Dijab, t1, t2, r1, r2, state,
                            jnp.asarray(do_ext))
                    else:
                        t1n, t2n, state, ecc_j, rms = apply_update(
                            Fj, Loovv_f, Dia, Dijab, t1, t2, r1, r2, state,
                            jnp.asarray(do_ext))
                        t1, t2 = t1n, t2n
            elif not bf16_active:
                ERIa, La = self._solver_H()
                if use_diis:
                    t1n, t2n, t1, t2, state, ecc_j, rms = step(
                        H.F, ERIa, La, t1, t2, state, jnp.asarray(do_ext))
                else:
                    t1n, t2n, state, ecc_j, rms = step(
                        H.F, ERIa, La, t1, t2, state, jnp.asarray(do_ext))
                    t1, t2 = t1n, t2n
            ecc = float(jnp.real(ecc_j))
            rms = float(rms)
            self.t1, self.t2 = t1n, t2n
            ediff = ecc - ecc_last
            log.info("CC Iter %3d: CC Ecorr = %.15f  dE = % .5E  rms = % .5E"
                  % (niter, ecc, ediff, rms))
            if chk is not None and niter % chk_every == 0:
                from .utils.checkpoint import save_amps
                data = dict(t1=t1, t2=t2, niter=niter, ecc=ecc)
                if chk_ring and use_diis:
                    data.update(diis_amps=state.amps, diis_errs=state.errs,
                                diis_count=int(state.count))
                save_amps(chk, **data)
            # working-precision noise floor: when the residual rms stops
            # improving for `stall_limit` straight iterations (common for
            # SP runs on big systems, where the unnormalized rms over
            # ~1e8 elements bottoms out near 1e-3 even though the energy
            # is converged to its float32 limit), stop instead of
            # DIIS-wobbling to maxiter.  self.converged reports whether
            # the ENERGY change met e_conv at the floor.
            if rms < 0.98 * best_rms:
                best_rms = rms
                stalled = 0
            elif not bf16_active:
                stalled += 1
                if stall_limit and stalled >= stall_limit and rms >= r_conv:
                    self.t1, self.t2 = t1n, t2n
                    self.ecc = ecc
                    self.converged = abs(ediff) < e_conv
                    log.info("\nCCWFN hit the working-precision noise floor "
                          "(rms %.3E > r_conv %.1E, no improvement in %d "
                          "iterations); stopping with dE = %.3E.\n"
                          % (rms, r_conv, stall_limit, ediff))
                    log.info("E(REF)  = %20.15f" % self.eref)
                    log.info("E(%s) = %20.15f" % (self.model, ecc))
                    log.info("E(TOT)  = %20.15f" % (ecc + self.eref))
                    timers.report()
                    return ecc
            if abs(ediff) < e_conv and rms < r_conv:
                # converged amplitudes = pre-extrapolation update
                self.t1, self.t2 = t1n, t2n
                self.converged = True
                log.info("\nCCWFN converged in %.3f seconds.\n" % (time.time() - tstart))
                log.info("E(REF)  = %20.15f" % self.eref)
                if self.model == "CCSD(T)":
                    log.info("E(CCSD) = %20.15f" % ecc)
                    with timers.time("ccwfn.triples"):
                        if self.make_t3_density:
                            et = float(self.t3_density())
                        elif self.storage == "df":
                            # factor-assembled slices; no dense ERI exists
                            from .triples import t_vikings_scan
                            et = float(t_vikings_scan(self))
                        else:
                            from .triples import t_tjl
                            et = float(t_tjl(self))
                    log.info("E(T)    = %20.15f" % et)
                    ecc = ecc + et
                else:
                    log.info("E(%s) = %20.15f" % (self.model, ecc))
                self.ecc = ecc
                log.info("E(TOT)  = %20.15f" % (ecc + self.eref))
                timers.report()
                return ecc
        self.t1, self.t2 = t1, t2
        self.ecc = ecc
        self.converged = False
        warnings.warn("CCWFN did NOT converge in %d iterations "
                      "(dE=%.2e rms=%.2e)" % (maxiter, ediff, rms))
        return ecc

    def t3_density(self):
        from .triples import t3_density_energy
        return t3_density_energy(self)

    # ------------------------------------------------------------------
    def _ensure_mixed_masters(self):
        """Stash f64 host masters: the per-stage device copies are cast
        from these, and the device never holds both precisions at once."""
        if hasattr(self, "_mixed_masters"):
            return
        self._mixed_masters = dict(
            F=np.asarray(self.H.F),
            ERI=(np.asarray(self.H.ERI)
                 if self.storage == "full" else None),
            L=(np.asarray(self.H.L)
               if self.storage == "full" else None),
            blocks=(jax.tree_util.tree_map(np.asarray, self.blocks)
                    if self.storage == "blocked" else None),
            dfb=(jax.tree_util.tree_map(np.asarray, self.dfb)
                 if self.storage == "df" else None),
            # perturbation operators: the response stack contracts these
            # against stage-dtype amplitudes — an f64 mu would silently
            # promote the whole "f32" stage back to f64
            **{k: (None if getattr(self.H, k) is None
                   else np.asarray(getattr(self.H, k)))
               for k in ("mu", "m", "p", "Q")})

    def _cast_stage(self, dtype):
        """Re-point every solver-facing representation (F; and, per
        storage mode, the full ERI/L tensors, the Dirac blocks, or the
        Cholesky factors) at `dtype` device copies of the f64 host
        masters stashed by solve_cc_mixed, cast the amplitudes, purge the
        dtype-derived caches, and rebind the model partials.  The
        previous stage's device buffers drop their last reference here,
        so the two precisions never coexist in HBM (the f64 factors at
        (40,360) naux=2592 are 3.5 GB; holding them THROUGH the f32
        stage would waste a quarter of the chip)."""
        m = self._mixed_masters
        put = lambda x: None if x is None else jnp.asarray(x).astype(dtype)
        # complex operators (magnetic dipole) track the stage's width
        cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
        putp = lambda x: (None if x is None else jnp.asarray(x).astype(
            cdtype if np.iscomplexobj(x) else dtype))
        self.H = Hamiltonian(F=put(m["F"]),
                             ERI=(put(m["ERI"]) if self.storage == "full"
                                  else self.H.ERI),
                             L=(put(m["L"]) if self.storage == "full"
                                else self.H.L),
                             mu=putp(m["mu"]), m=putp(m["m"]),
                             p=putp(m["p"]), Q=putp(m["Q"]), no=self.H.no)
        if self.storage == "blocked":
            self.blocks = jax.tree_util.tree_map(put, m["blocks"])
        if self.storage == "df":
            self.dfb = jax.tree_util.tree_map(put, m["dfb"])
        self.t1 = self.t1.astype(dtype)
        self.t2 = self.t2.astype(dtype)
        # denominators rematerialize lazily at the new dtype (__getattr__);
        # the bf16 factor/block caches are derived from the stage buffers
        self.__dict__.pop("Dia", None)
        self.__dict__.pop("Dijab", None)
        self.__dict__.pop("_dfb16", None)
        self.__dict__.pop("_blocks16", None)
        # the (T)-Lambda triples sources are dtype-derived caches too
        # (set by cclambda.solve_lambda for model='CCSD(T)')
        self.__dict__.pop("S1", None)
        self.__dict__.pop("S2", None)
        self._bind_residual_fns()
        if self.storage == "df":
            self._df_residual_fn = self._make_df_residual_fn()
            self._maybe_split_df_residual(dtype)
        if self.mesh is not None:
            # the casts above rebuilt storage/amplitudes as unsharded
            # single-device arrays; re-distribute so a mesh-constructed
            # solver keeps its SPMD layout through a mixed-precision solve
            self._apply_mesh(self.mesh)

    def solve_cc_mixed(self, e_conv=1e-10, r_conv=1e-10, maxiter=100,
                       sp_conv=1e-6, sp_dtype=jnp.float32,
                       refine_maxiter=None, sp_kwargs=None,
                       refine_kwargs=None, chk=None, chk_every=20,
                       resume=False, **kw):
        """Mixed-precision solve for ANY canonical storage mode (full /
        blocked / df, incl. integral-direct factors): pre-converge the
        amplitudes in float32 — cheaper iterations — then
        refine in float64 to the requested tolerances.  The fixed point
        is dtype-independent, so the refined result equals a pure-f64
        solve; the f32 stage typically stops at its noise floor (the
        stall detector fires) and the f64 stage needs only a handful of
        iterations to pull the energy from the ~1e-5 f32 floor down to
        e_conv.  This is the at-scale accuracy-recovery path: the
        reference delivers 1e-11 double-precision energies on everything
        it can hold (/root/reference/pycc/ccwfn.py:177-196) and its SP
        mode is all-or-nothing; here the expensive iterations run f32
        and only the final ones pay for f64.

        sp_kwargs: extra solve_cc kwargs for the f32 stage only (e.g.
        bf16_until); refine_kwargs: extras for the f64 stage only — at
        scale pass max_diis=0 there: an f64 DIIS ring is max_diis
        amplitude+residual o^2v^2 pairs (13 GB at (40,360) depth 4,
        an HBM OOM on its own) and plain Jacobi from the f32-floor
        amplitudes converges in a handful of steps anyway; **kw goes to
        both stages.  Requires a DP-constructed solver (the f64 masters
        must exist)."""
        if self.local is not None:
            raise Exception("solve_cc_mixed supports canonical storage "
                            "modes (the local filters hold their own "
                            "f64 stacks).")
        if self.precision != "DP":
            raise Exception("solve_cc_mixed needs a precision='DP' "
                            "construction (the f64 masters are the "
                            "refinement-stage Hamiltonian).")
        self._ensure_mixed_masters()
        # chk=<base> checkpoints each stage separately (<base>.sp.npz /
        # <base>.rf.npz via solve_cc's own machinery) plus a floor-
        # completion record (<base>.floor.npz: the converged low-precision
        # amplitudes + e_sp_floor), so resume=True after an interruption
        # re-enters the correct STAGE: mid-floor resumes the f32 solve,
        # post-floor skips straight to (or back into) the f64 refinement.
        floor_chk = (str(chk) + ".floor.npz") if chk else None
        skip_sp = bool(resume and floor_chk and os.path.exists(floor_chk))
        if skip_sp:
            from .utils.checkpoint import load_amps
            d = load_amps(floor_chk)
            self.t1 = jnp.asarray(d["t1"])
            self.t2 = jnp.asarray(d["t2"])
            self.e_sp_floor = float(d["e_sp_floor"])
            log.info("CCWFN mixed resume: floor stage already complete "
                        "(%s, E_floor=%.10f); entering f64 refinement"
                        % (floor_chk, self.e_sp_floor))
        else:
            # ---- low-precision floor stage ----
            self._cast_stage(sp_dtype)
            kw_sp = dict(kw)
            kw_sp.update(sp_kwargs or {})
            if chk is not None:
                kw_sp.setdefault("chk", str(chk) + ".sp.npz")
                kw_sp.setdefault("chk_every", chk_every)
                kw_sp.setdefault("resume", resume)
            # e_sp_floor records where the low-precision stage stopped, so
            # at-scale runs can report the refinement gap it recovered
            self.e_sp_floor = float(self.solve_cc(sp_conv, sp_conv, maxiter,
                                                  **kw_sp))
            if floor_chk is not None:
                from .utils.checkpoint import save_amps
                save_amps(floor_chk, t1=self.t1, t2=self.t2,
                          e_sp_floor=self.e_sp_floor)
        # ---- f64 refinement from the floor amplitudes ----
        self._cast_stage(jnp.float64)
        kw_rf = dict(kw)
        kw_rf.update(refine_kwargs or {})
        if chk is not None:
            kw_rf.setdefault("chk", str(chk) + ".rf.npz")
            kw_rf.setdefault("chk_every", max(1, chk_every // 4))
            kw_rf.setdefault("resume", resume)
        ecc = self.solve_cc(e_conv, r_conv,
                            refine_maxiter if refine_maxiter else maxiter,
                            **kw_rf)
        return ecc

    # ------------------------------------------------------------------
    def solve_cc_fused(self, e_conv=1e-7, r_conv=1e-7, maxiter=100,
                       max_diis=8, start_diis=1):
        """Entire CC solve as ONE on-device lax.while_loop (no per-iteration
        host dispatch); same fixed point as
        solve_cc."""
        no = self.no
        H = self.H
        Dia, Dijab = self.Dia, self.Dijab
        residual_fn = self._residual_fn
        energy_fn = self._energy_fn
        use_filter = self.local is not None
        filter_fn = self.Local.filter_amps if use_filter else None
        diis = DIIS((self.t1, self.t2), max_diis=max(max_diis, 1))
        blocked = self.storage == "blocked"
        Fj = jnp.asarray(H.F)

        df_mode = self.storage == "df"
        df_residual_fn = self._df_residual_fn

        def body(carry, ERIc, Lc):
            t1, t2, state, niter, ecc, _rms, _done = carry
            if df_mode:
                r1, r2 = df_residual_fn(Fj, ERIc, t1, t2, no)
            else:
                r1, r2 = residual_fn(Fj, ERIc, Lc, t1, t2, no)
            if use_filter:
                inc1, inc2 = filter_fn(r1, r2)
            else:
                inc1 = r1 / Dia
                inc2 = r2 / Dijab
            t1n = t1 + inc1
            t2n = t2 + inc2
            rms = jnp.sqrt(jnp.sum(jnp.abs(inc1) ** 2)
                           + jnp.sum(jnp.abs(inc2) ** 2))
            ecc_new = jnp.real(energy_fn(Fj, Lc, t1n, t2n, no))
            done = (jnp.abs(ecc_new - ecc) < e_conv) & (rms < r_conv)
            state = diis.push(state, (t1n, t2n), (t1, t2))
            do_ext = (max_diis > 0) & (niter + 1 >= start_diis) & ~done
            t1e, t2e = jax.lax.cond(
                do_ext, lambda s: diis.extrapolate(s, (t1n, t2n)),
                lambda s: (t1n, t2n), state)
            return (t1e, t2e, state, niter + 1, ecc_new, rms, done)

        def cond(carry):
            niter, done = carry[3], carry[6]
            return (~done) & (niter < maxiter)

        # H enters as jit ARGUMENTS (closure constants are baked into the
        # compiled program)
        @jax.jit
        def run(t1, t2, ERIa, La):
            if blocked:
                from .models.blocked import blocked_views
                ERIc, Lc = blocked_views(ERIa, no)
            elif df_mode:
                from .models.blocked import LoovvOnly
                ERIc = ERIa
                Lc = LoovvOnly(self._df_Loovv(ERIa), no)
            else:
                ERIc, Lc = ERIa, La
            ecc0 = jnp.real(energy_fn(Fj, Lc, t1, t2, no))
            carry = (t1, t2, diis.init(), jnp.array(0), ecc0,
                     jnp.array(jnp.inf, dtype=ecc0.dtype), jnp.array(False))
            return jax.lax.while_loop(
                cond, lambda c: body(c, ERIc, Lc), carry)

        ERIa, La = self._solver_H()
        t1, t2, _state, niter, ecc, rms, done = run(self.t1, self.t2,
                                                    ERIa, La)
        self.t1, self.t2 = t1, t2
        self.ecc = float(ecc)
        log.info("CCWFN (fused) converged=%s in %d iterations: E(%s) = %.15f"
              % (bool(done), int(niter), self.model, self.ecc))
        if self.model == "CCSD(T)":
            if self.storage == "df":
                from .triples import t_vikings_scan
                et = float(t_vikings_scan(self))
            else:
                from .triples import t_tjl
                et = float(t_tjl(self))
            self.ecc += et
            log.info("E(T) = %.15f  E(total corr) = %.15f" % (et, self.ecc))
        return self.ecc
