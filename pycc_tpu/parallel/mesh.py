"""GSPMD mesh sharding for the CC tensors.

New first-class component with no reference counterpart (the reference's
only multi-device mechanism is a CPU<->GPU offload split,
/root/reference/pycc/ccwfn.py:205-229).  Here the O(v^4) ERI tensor and the
doubles amplitudes are sharded over a device mesh with named axes; the
jitted residual graphs then run SPMD with XLA-generated collectives
(all-gather / reduce-scatter over NVLink between cards, through NCCL),
never staging 4-index tensors through host.

Layout: a 2D mesh ('va', 'vb'), shaped by the algorithm (the two virtual
axes), not by the wiring: every card reaches every other at one rate.  ERI/L are sharded over their last two
(virtual-heavy) axes; t2/r2 over their two virtual axes; 2-index tensors and
o-space blocks are replicated.  With this layout the hot Hvvvv/Wabef-type
contractions ('ijef,abef->ijab') contract along replicated axes locally and
reduce-scatter onto the output shards.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hamiltonian import Hamiltonian


def make_mesh(n_devices=None, devices=None, shape=None):
    """Build a 2D ('va','vb') mesh over the given/available devices."""
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    n = len(devices)
    if shape is None:
        # most-square 2D factorization
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (a, n // a)
    dev_array = np.array(devices).reshape(shape)
    return Mesh(dev_array, axis_names=("va", "vb"))


def _put(x, mesh, spec):
    """device_put with the spec, dropping any mesh axis that does not
    divide its array dimension (device_put refuses uneven shards; tile-
    aligned production sizes always divide — odd test sizes degrade to
    partial sharding on the divisible axes only)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    parts = list(spec) + [None] * (x.ndim - len(spec))
    fixed = tuple(p if (p is None or x.shape[i] % sizes[p] == 0) else None
                  for i, p in enumerate(parts[:x.ndim]))
    return jax.device_put(x, NamedSharding(mesh, P(*fixed)))


def shard_hamiltonian(H, mesh):
    """Distribute the Hamiltonian pytree: 4-index tensors sharded over their
    last two axes, everything else replicated."""
    spec4 = P(None, None, "va", "vb")
    rep = P()
    tup = lambda ms: (None if ms is None
                      else tuple(_put(m, mesh, rep) for m in ms))
    return Hamiltonian(
        F=_put(H.F, mesh, rep),
        ERI=_put(H.ERI, mesh, spec4),
        L=_put(H.L, mesh, spec4),
        mu=tup(H.mu), m=tup(H.m), p=tup(H.p), Q=tup(H.Q),
        no=H.no)


def shard_amps(t1, t2, mesh):
    """Shard amplitudes: t1 replicated, t2 over its virtual axes."""
    return (_put(t1, mesh, P()),
            _put(t2, mesh, P(None, None, "va", "vb")))


def shard_df(dfb, mesh):
    """Distribute DF/Cholesky factors over the mesh.

    Bvv (the big factor, naux*v^2) shards over its two virtual axes; Bov
    over its virtual axis; Boo is replicated (tiny).  The ladder assembly
    (Pae,Pbf->abef) then contracts naux locally per shard pair and the
    application reduce-scatters onto the t2 sharding."""
    from ..models.dfccsd import DFERI
    return DFERI(
        Boo=_put(dfb.Boo, mesh, P()),
        Bov=_put(dfb.Bov, mesh, P(None, None, "vb")),
        Bvv=_put(dfb.Bvv, mesh, P(None, "va", "vb")),
    )


def shard_pair_stacks(pre, mesh, no):
    """Distribute the local pair work-list stacks (SURVEY §7.11).

    The pair dimension is the natural parallel axis of local correlation:
    stacks whose leading dims are (no, no) — pair row/column — shard over
    ('va', 'vb'); compact screened stacks (leading dim = the strong-pair
    count P) shard over 'va'; everything else replicates.  The jitted
    pair-space residuals then run SPMD, with GSPMD gathering the
    cross-pair (Sr-stitched m,n) couplings."""
    out = {}
    for k, x in pre.items():
        if not hasattr(x, "ndim"):
            out[k] = x
        elif (x.ndim >= 3 and x.shape[0] == no and x.shape[1] == no
              and any(d != no for d in x.shape[2:])):
            # pair-leading stack with local-virtual payload.  All-occupied
            # tensors (F_oo, ERI_oooo) stay REPLICATED: they are tiny, and
            # sharding the equal-sized oooo dims trips an XLA SPMD
            # partitioner miscompilation (observed: jitted residual off
            # by 4.5e-2 with ERI_oooo sharded, exact with it replicated —
            # eager mode is exact either way).
            out[k] = _put(x, mesh, P("va", "vb"))
        elif x.ndim >= 1 and x.shape[0] > no:
            out[k] = _put(x, mesh, P("va"))
        else:
            out[k] = _put(x, mesh, P())
    return out


def shard_hbar(hbar, mesh):
    """Distribute a built HBAR over the mesh.

    Dense HBar: every >=2-dim block sharded over its trailing two axes
    (the layout the dryrun's sharded sigma validated).  DFHBar: factors on
    the DF layout, the dressed vv factor like Bvv, explicit 4-index blocks
    on their trailing two axes."""
    from ..models.dfhbar import DFHBar

    if isinstance(hbar, DFHBar):
        return DFHBar(
            Hov=_put(hbar.Hov, mesh, P()),
            Hvv=_put(hbar.Hvv, mesh, P()),
            Hoo=_put(hbar.Hoo, mesh, P()),
            Hoooo=_put(hbar.Hoooo, mesh, P()),
            Hooov=_put(hbar.Hooov, mesh, P()),
            Hovvo=_put(hbar.Hovvo, mesh, P(None, None, "va", None)),
            Hovov=_put(hbar.Hovov, mesh, P(None, None, None, "vb")),
            Hovoo=_put(hbar.Hovoo, mesh, P()),
            df=shard_df(hbar.df, mesh),
            Bd_ae=_put(hbar.Bd_ae, mesh, P(None, "va", "vb")),
            Bd_mi=_put(hbar.Bd_mi, mesh, P()))
    return jax.tree_util.tree_map(
        lambda x: _put(x, mesh,
                       P(*([None] * (x.ndim - 2) + ["va", "vb"]))
                       if x.ndim >= 2 else P()),
        hbar)


def shard_blocks(blocks, mesh):
    """Distribute an ERIBlocks pytree over the mesh.

    The v^4 block shards over its leading two virtual axes and the ov^3
    block over its trailing two; o-heavy blocks are replicated (they are
    tiny).  Combined with blocked storage this is the full scaling
    configuration: per-device memory ~ (v^4 + o v^3)/n_devices + small
    replicated blocks, and XLA inserts the collectives for the ladder
    contractions."""
    from ..models.blocked import ERIBlocks
    return ERIBlocks(
        oooo=_put(blocks.oooo, mesh, P()),
        ooov=_put(blocks.ooov, mesh, P()),
        oovv=_put(blocks.oovv, mesh, P(None, None, "va", "vb")),
        ovov=_put(blocks.ovov, mesh, P(None, "va", None, "vb")),
        ovvv=_put(blocks.ovvv, mesh, P(None, None, "va", "vb")),
        vvvv=_put(blocks.vvvv, mesh, P("va", "vb", None, None)),
    )
