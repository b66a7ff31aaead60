"""Multi-chip structured fast path: the gather-free brick hierarchy
(solve/structured.py) sharded over a 1-D device mesh with one-plane
``ppermute`` halos.

This unifies the single-device structured hierarchy with the
distributed halo-ELL path (O(N/P) memory but gather-bound kernels).  A
Cartesian brick grid shards into x-slabs by construction, so every
operator at every level needs exactly a one-plane (fine) /
one-brick-layer (coarse) neighbor halo — the hypre ParCSR SpMV halo
semantics (SURVEY §2.3) realized as neighbor ``ppermute`` of
statically-sliced rows:

  - The fine level uses the Z-LANE layout (structured.py): an x-plane
    is exactly ``prow = NYn*nzp/128`` rows of the (rows, 128) haloed
    layout, so halo exchange is a static row-slice ppermute and the
    SAME stencil passes (ops/stencil.py) run unchanged per shard.
  - Each device stores its CLOSED slab (slab_planes+1 planes: the
    shared plane is replicated, like the reference's overlapped
    dof/truedof duality, aggregates.hpp:174); both owners compute
    bitwise-identical values for it, so no consistency traffic is
    needed beyond the per-pass halo fill.
  - Coarse (slot-major padded) vectors shard by brick-x layers —
    disjoint ownership, because every coarse dof belongs to exactly
    one master brick.  The BrickBlockOp matvec exchanges one brick
    shell (bs*BY*BZ values) per side.
  - The coarsest correction is psum-reduced (R1 column-sharded) and
    solved replicated — the tiny-by-construction global collective.

Reference counterparts: tg_cycle_atb (tg.cpp:91) under MPI/hypre
distribution; pmltest device-count invariance
(amg/CMakeLists.txt:198-203).

Dtype parity with the single-device path: the bf16 smoother twin
(smoother_dtype) and bf16 mid blocks are threaded through —
preconditioner passes stream the twin while the PCG matvec keeps the
f32 operator, matching the single-device configuration's traffic and
its results per shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from saamge_jax.ops.stencil import (LANES, ROW_ALIGN, StencilDIA,
                                    stencil_backend)
from saamge_jax.solve.structured import (HI, BrickBlockOp, BrickGeometry,
                                         StructuredHierarchy,
                                         assemble_P_pieces, extract_boxes)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class StructShardStatic:
    """Static (non-pytree) geometry of the sharded structured solve."""
    geo: BrickGeometry
    ndev: int
    nzp: int
    prow: int          # rows per x-plane
    sp1: int           # closed-slab planes per device (slab_planes + 1)
    real: int          # real rows per device (sp1 * prow)
    local_pad: int     # real rounded up to ROW_ALIGN
    hr_need: int       # halo rows each side the stencil actually reads
    offsets: tuple
    hr: int            # halo rows of the local haloed layout
    doffs: tuple       # brick offsets of the mid operator
    bs: int
    nb_loc: int        # bricks per device (BXloc * BY * BZ)
    n2: int            # coarsest size
    taus0: tuple       # python floats (1/tau)
    taus1: tuple
    # superbrick (structured) coarsest restriction, sharded by flat
    # superbrick chunks (see _mid_coarsest_sb): supers grid, level-2
    # block size, chunk width per device
    supers: Optional[tuple] = None
    bs2: int = 0
    nb2c: int = 0


@dataclasses.dataclass
class ShardedStructured:
    """Host container: per-device-stacked arrays (leading axis = dp)."""
    vals0: jnp.ndarray     # (P, k, local_pad, 128) f32 (PCG matvec)
    dinv0: jnp.ndarray     # (P, t_rows, 128) haloed layout
    rst: jnp.ndarray       # (P, bs, box, nb_loc)
    blocks1: jnp.ndarray   # (P, k1, bs, bs, nb_loc)
    dinv1: jnp.ndarray     # (P, bs * nb_loc)
    r1: jnp.ndarray        # (P, n2, bs * nb_loc)
    ainv: jnp.ndarray      # (n2, n2) replicated
    st: StructShardStatic
    mesh: Mesh
    # bf16 smoother twin of vals0 (the single-device smoother_dtype
    # configuration): preconditioner passes stream it; PCG matvec keeps
    # the f32 vals0
    vals0s: Optional[jnp.ndarray] = None
    # superbrick coarsest: the level-2 block-diagonal tent blocks
    # (bs2, win, NB2) sharded by flat superbrick chunks, so EVERY
    # mid-level object is O(N1/P) per device (the reference distributes
    # every level, tg.hpp:696-711); only the coarsest solve (Ainv,
    # n2^2) is replicated
    rst1: Optional[jnp.ndarray] = None
    fid2: Optional[jnp.ndarray] = None    # replicated flat_id2


jax.tree_util.register_pytree_node(
    ShardedStructured,
    lambda s: ((s.vals0, s.dinv0, s.rst, s.blocks1, s.dinv1, s.r1,
                s.ainv, s.vals0s, s.rst1, s.fid2), (s.st, s.mesh)),
    lambda aux, ch: ShardedStructured(*ch[:7], *aux, vals0s=ch[7],
                                      rst1=ch[8], fid2=ch[9]),
)


def shard_structured(h: StructuredHierarchy,
                     mesh: Mesh) -> ShardedStructured:
    """Slice a (zlane, brickblock) StructuredHierarchy into x-slabs.

    Requires ndev | BX and a 3-level hierarchy built with
    fine_layout='zlane' and mid_format='brickblock'.  Every level is
    distributed: fine slabs, mid blocks, dinv1 and the coarsest
    restriction (dense R1 columns or superbrick Rst1 chunks) all shard
    to O(N/P) per device; only the coarsest inverse is replicated."""
    ndev = mesh.devices.size
    geo = h.geo
    BX, BY, BZ = geo.bricks
    bx, by, bz = geo.brick_elems
    NXn, NYn, NZn = geo.nodes
    assert h.nzp > 0, "sharded structured path requires fine_layout='zlane'"
    assert isinstance(h.A1d, BrickBlockOp), \
        "distributed mid loop requires mid_format='brickblock'"
    assert h.R1 is not None or h.Rst1 is not None, \
        "distributed mid loop needs a dense or superbrick coarsest " \
        "restriction"
    assert BX % ndev == 0, (BX, ndev)
    nzp = h.nzp
    prow = NYn * nzp // LANES
    bxloc = BX // ndev
    slab = bxloc * bx
    sp1 = slab + 1
    real = sp1 * prow
    A0 = h.A0
    k = len(A0.offsets)
    local_pad = _round_up(real, ROW_ALIGN)
    # halo the stencil reads: max row reach of the offsets, one-sided
    hr_need = max(abs(divmod(int(o), LANES)[0]) for o in A0.offsets) + 1
    hr = A0.hr
    t_rows = local_pad + 2 * hr

    vals_np = np.asarray(A0.vals2)            # (k, n_rows_pad, 128)
    # dinv0h is already haloed global; recover the global flat rows
    dinv_glob = np.asarray(h.dinv0h).reshape(-1)[
        A0.hr * LANES:A0.hr * LANES + A0.n_rows_pad * LANES] \
        .reshape(A0.n_rows_pad, LANES)

    vals0 = np.zeros((ndev, k, local_pad, LANES), np.float32)
    dinv0 = np.zeros((ndev, t_rows, LANES), np.float32)
    for d in range(ndev):
        lo = d * slab * prow
        vals0[d, :, :real] = vals_np[:, lo:lo + real]
        dinv0[d, hr:hr + real] = dinv_glob[lo:lo + real]
    # bf16 smoother twin (smoother_dtype): preconditioner passes stream
    # it, matching the single-device configuration
    vals0s = None
    if h.A0s is not None:
        vs_np = np.asarray(h.A0s.vals2)
        vals0s = np.zeros((ndev, k, local_pad, LANES), vs_np.dtype)
        for d in range(ndev):
            lo = d * slab * prow
            vals0s[d, :, :real] = vs_np[:, lo:lo + real]

    bs = h.Rst.shape[0]
    box = h.Rst.shape[1]
    NB = geo.num_bricks
    nb_loc = bxloc * BY * BZ
    rst_np = np.asarray(h.Rst).reshape(bs, box, ndev, nb_loc)
    rst = np.ascontiguousarray(rst_np.transpose(2, 0, 1, 3))

    n2 = h.Ainv.shape[0]
    supers = bs2 = nb2c = None
    rst1_sh = fid2_rep = None
    blk = np.asarray(h.A1d.blocks)          # (k1, bs, bs, NB),
    # keeping the storage dtype (bf16 mid blocks stream half the bytes)
    k1 = blk.shape[0]
    blocks1 = np.ascontiguousarray(
        blk.reshape(k1, bs, bs, ndev, nb_loc).transpose(3, 0, 1, 2, 4))

    dinv1_np = np.asarray(h.dinv1).reshape(bs, ndev, nb_loc)
    dinv1 = np.ascontiguousarray(
        dinv1_np.transpose(1, 0, 2)).reshape(ndev, bs * nb_loc)
    if h.Rst1 is not None:
        # superbrick coarsest: shard the block-diagonal level-2 tent
        # blocks (bs2, win, NB2) by flat superbrick chunks — the
        # per-superbrick contractions are independent, so any disjoint
        # (padded-equal) partition distributes them
        rst1_np = np.asarray(h.Rst1)
        bs2, win, NB2 = rst1_np.shape
        nb2c = -(-NB2 // ndev)
        pad = ndev * nb2c - NB2
        rst1_p = np.pad(rst1_np, ((0, 0), (0, 0), (0, pad)))
        rst1_sh = np.ascontiguousarray(
            rst1_p.reshape(bs2, win, ndev, nb2c).transpose(2, 0, 1, 3))
        fid2_rep = h.flat_id2
        supers = h.supers
        r1 = np.zeros((ndev, 1), np.float32)
    else:
        r1_np = np.asarray(h.R1).reshape(n2, bs, ndev, nb_loc)
        r1 = np.ascontiguousarray(
            r1_np.transpose(2, 0, 1, 3)).reshape(ndev, n2, bs * nb_loc)

    st = StructShardStatic(
        geo=geo, ndev=ndev, nzp=nzp, prow=prow, sp1=sp1, real=real,
        local_pad=local_pad, hr_need=hr_need, offsets=A0.offsets, hr=hr,
        doffs=h.A1d.doffs,
        bs=bs, nb_loc=nb_loc, n2=n2,
        taus0=tuple(float(np.asarray(t)[0]) for t in h.taus0),
        taus1=tuple(float(np.asarray(t)[0]) for t in h.taus1),
        supers=supers, bs2=bs2 or 0, nb2c=nb2c or 0)

    shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    repl = NamedSharding(mesh, P())
    put = lambda a: jax.device_put(jnp.asarray(a), shard)  # noqa: E731
    return ShardedStructured(
        vals0=put(vals0), dinv0=put(dinv0), rst=put(rst),
        blocks1=put(blocks1), dinv1=put(dinv1), r1=put(r1),
        vals0s=None if vals0s is None else put(vals0s),
        ainv=jax.device_put(h.Ainv, repl), st=st, mesh=mesh,
        rst1=None if rst1_sh is None else put(rst1_sh),
        fid2=None if fid2_rep is None
        else jax.device_put(jnp.asarray(fid2_rep), repl))


def mid_bytes_per_device(hs: ShardedStructured) -> dict:
    """Per-device mid-level storage accounting (the O(N1/P) contract;
    reference anchor: every level's operator data is rank-local,
    tg.hpp:696-711).  ``replicated`` counts the bytes every device holds
    in full; ``sharded`` counts one device's shard."""
    sharded = 0
    replicated = int(hs.ainv.size * hs.ainv.dtype.itemsize)
    for a in (hs.blocks1, hs.dinv1, hs.r1, hs.rst1):
        if a is not None:
            sharded += int(a.size * a.dtype.itemsize) // hs.st.ndev
    if hs.fid2 is not None:
        replicated += int(hs.fid2.size * hs.fid2.dtype.itemsize)
    return {"sharded": sharded, "replicated": replicated,
            "per_device": sharded + replicated}


# ---------------------------------------------------------------------------
# vector scatter / gather (host <-> sharded layout)


def scatter_fine(hs: ShardedStructured, b: np.ndarray) -> jnp.ndarray:
    """original flat (n,) -> (P, real*128) closed-slab blocks."""
    st = hs.st
    NXn, NYn, NZn = st.geo.nodes
    z = np.zeros((NXn, NYn, st.nzp), np.float32)
    z[:, :, :NZn] = np.asarray(b, np.float32).reshape(NXn, NYn, NZn)
    zf = z.reshape(NXn, NYn * st.nzp)
    slab = st.sp1 - 1
    out = np.zeros((st.ndev, st.real * LANES), np.float32)
    for d in range(st.ndev):
        out[d] = zf[d * slab:d * slab + st.sp1].reshape(-1)
    return jax.device_put(
        out, NamedSharding(hs.mesh, P(hs.mesh.axis_names[0])))


def gather_fine(hs: ShardedStructured, xs) -> np.ndarray:
    """(P, real*128) -> original flat (n,) (host)."""
    st = hs.st
    NXn, NYn, NZn = st.geo.nodes
    xs = np.asarray(xs)
    slab = st.sp1 - 1
    zf = np.zeros((NXn, NYn * st.nzp), np.float32)
    for d in range(st.ndev):
        loc = xs[d].reshape(st.sp1, NYn * st.nzp)
        zf[d * slab:d * slab + st.sp1] = loc
    return zf.reshape(NXn, NYn, st.nzp)[:, :, :NZn].reshape(-1)


# ---------------------------------------------------------------------------
# shard_map kernels


def _halo_fill(st: StructShardStatic, xh, axis):
    """Refresh the neighbor halos of the local haloed vector.

    Left halo <- left neighbor's rows just below my plane 0 (its planes
    [slab-h, slab)); right fill at [hr+real, ...) <- right neighbor's
    rows just above my last plane (its planes [1, 1+h)).  Chain ends
    receive zeros (global Dirichlet exterior)."""
    hr = st.hr
    h = st.hr_need
    ndev = st.ndev
    i = jax.lax.axis_index(axis)
    right_of = [(d, (d + 1) % ndev) for d in range(ndev)]
    left_of = [(d, (d - 1) % ndev) for d in range(ndev)]
    left_src = jax.lax.slice_in_dim(
        xh, hr + st.real - st.prow - h, hr + st.real - st.prow, axis=0)
    right_src = jax.lax.slice_in_dim(
        xh, hr + st.prow, hr + st.prow + h, axis=0)
    left_halo = jax.lax.ppermute(left_src, axis, right_of)
    right_halo = jax.lax.ppermute(right_src, axis, left_of)
    left_halo = jnp.where(i == 0, 0.0, left_halo)
    right_halo = jnp.where(i == ndev - 1, 0.0, right_halo)
    xh = jax.lax.dynamic_update_slice_in_dim(xh, left_halo, hr - h, 0)
    xh = jax.lax.dynamic_update_slice_in_dim(xh, right_halo,
                                             hr + st.real, 0)
    return xh


def _local_op(st: StructShardStatic, vals) -> StencilDIA:
    """The device's slab operator (local values, shared geometry)."""
    n = st.real * LANES
    return StencilDIA(vals, st.offsets, (n, n), st.local_pad, st.hr,
                      stencil_backend())


def _pad_local(st, x_flat):
    """(real*128,) -> haloed (t_rows, 128)."""
    hr = st.hr
    t_rows = st.local_pad + 2 * hr
    xh = jnp.zeros((t_rows * LANES,), jnp.float32)
    xh = jax.lax.dynamic_update_slice(xh, x_flat, (hr * LANES,))
    return xh.reshape(t_rows, LANES)


def _unpad_local(st, xh):
    hr = st.hr
    return xh.reshape(-1)[hr * LANES:hr * LANES + st.real * LANES]


def _mid_matvec_blk(st, blocks, x, axis):
    """BrickBlockOp matvec on the brick-x-sharded slot-major layout."""
    BX, BY, BZ = st.geo.bricks
    bxl = st.nb_loc // (BY * BZ)
    bs = st.bs
    ndev = st.ndev
    i = jax.lax.axis_index(axis)
    x4 = x.reshape(bs, bxl, BY, BZ)
    right_of = [(d, (d + 1) % ndev) for d in range(ndev)]
    left_of = [(d, (d - 1) % ndev) for d in range(ndev)]
    lsh = jax.lax.ppermute(x4[:, -1:], axis, right_of)
    rsh = jax.lax.ppermute(x4[:, :1], axis, left_of)
    lsh = jnp.where(i == 0, 0.0, lsh)
    rsh = jnp.where(i == ndev - 1, 0.0, rsh)
    xp = jnp.concatenate([lsh, x4, rsh], axis=1)     # (bs, bxl+2, BY, BZ)
    xp = jnp.pad(xp, ((0, 0), (0, 0), (1, 1), (1, 1)))
    views = [
        jax.lax.slice(xp, (0, 1 + dx, 1 + dy, 1 + dz),
                      (bs, 1 + dx + bxl, 1 + dy + BY, 1 + dz + BZ))
        .reshape(bs, -1)
        for (dx, dy, dz) in st.doffs]
    xs = jnp.stack(views).astype(blocks.dtype)       # (k1, bs, nb_loc)
    # the round-trip through blocks.dtype matches the single-device
    # BrickBlockOp matvec bitwise when the mid blocks are bf16
    y = jnp.sum(blocks.astype(jnp.float32)
                * xs[:, None, :, :].astype(jnp.float32), axis=(0, 2))
    return y.reshape(-1)


def _apply_R_blk(st, rst, x_flat):
    """local coarse = R res on the closed slab: reshape+concat overlap
    extraction + multiply-reduce."""
    NXn, NYn, NZn = st.geo.nodes
    BX, BY, BZ = st.geo.bricks
    r3 = x_flat.reshape(st.sp1, NYn, st.nzp)[:, :, :NZn]
    bxl = st.nb_loc // (BY * BZ)
    boxes = extract_boxes(r3, st.geo.brick_elems, (bxl, BY, BZ))
    return jnp.sum(rst * boxes[None], axis=1).reshape(-1)


def _apply_P_blk(st, rst, xc, axis):
    """local fine = P xc (8-piece static-slice assembly), then one
    received plane: plane 0 on device d>0 is owned by the LEFT
    neighbor's last brick (upper-half-open tiling), whose assembled last
    plane arrives by ppermute."""
    NXn, NYn, NZn = st.geo.nodes
    BX, BY, BZ = st.geo.bricks
    bxl = st.nb_loc // (BY * BZ)
    ndev = st.ndev
    C = jnp.sum(rst * xc.reshape(st.bs, -1)[:, None, :], axis=0)
    y3 = assemble_P_pieces(C, st.geo.brick_elems, (bxl, BY, BZ),
                           (st.sp1, NYn, NZn))
    i = jax.lax.axis_index(axis)
    right_of = [(d, (d + 1) % ndev) for d in range(ndev)]
    recv = jax.lax.ppermute(y3[-1], axis, right_of)
    plane0 = jnp.where(i == 0, y3[0], recv)
    y3 = y3.at[0].set(plane0)
    yz = jnp.pad(y3, ((0, 0), (0, 0), (0, st.nzp - NZn)))
    return yz.reshape(-1)


def _pdot(st, a, b, axis):
    """psum dot with the shared-plane overlap counted once (it belongs
    to the right neighbor except on the last device)."""
    cut = (st.sp1 - 1) * st.prow * LANES
    i = jax.lax.axis_index(axis)
    own = jnp.vdot(a[:cut], b[:cut], precision=HI)
    last = jnp.where(i == st.ndev - 1,
                     jnp.vdot(a[cut:st.real * LANES],
                              b[cut:st.real * LANES], precision=HI), 0.0)
    return jax.lax.psum(own + last, axis)


def _mid_coarsest_sb(st, rst1, ainv, fid2, r1_loc, axis):
    """Distributed superbrick coarsest correction on the mid residual.

    Mirrors the single-device mid_apply_R1/P1 + Ainv sequence
    (solve/structured.py:721-755) with the level-2 tent blocks sharded
    by flat superbrick chunks: the per-superbrick window contractions
    are independent (block-diagonal restriction), so each device
    contracts its chunk of the all-gathered mid residual; the coarsest
    vector (n2-sized, tiny) is all-gathered and the replicated dense
    solve applied; the adjoint contraction produces the local chunk of
    window values, gathered and sliced back to the device's bricks.
    Identical arithmetic per superbrick to the single-device path (same
    reduce orders), so parity is exact."""
    bs = st.bs
    BX, BY, BZ = st.geo.bricks
    SX, SY, SZ = st.supers
    sx, sy, sz = BX // SX, BY // SY, BZ // SZ
    NB2 = SX * SY * SZ
    bxl = st.nb_loc // (BY * BZ)
    bs2, nb2c = st.bs2, st.nb2c
    i = jax.lax.axis_index(axis)

    loc = r1_loc.reshape(bs, st.nb_loc)
    g = jax.lax.all_gather(loc, axis)             # (P, bs, nb_loc)
    r1f = jnp.transpose(g, (1, 0, 2)).reshape(bs, SX, sx, SY, sy, SZ, sz)
    W = r1f.transpose(0, 2, 4, 6, 1, 3, 5) \
        .reshape(bs * sx * sy * sz, NB2)
    Wp = jnp.pad(W, ((0, 0), (0, st.ndev * nb2c - NB2)))
    Wl = jax.lax.dynamic_slice_in_dim(Wp, i * nb2c, nb2c, 1)
    rc2l = jnp.sum(rst1.astype(jnp.float32) * Wl[None].astype(jnp.float32),
                   axis=1)                        # (bs2, nb2c)
    rc2 = jnp.transpose(jax.lax.all_gather(rc2l, axis),
                        (1, 0, 2)).reshape(bs2, -1)[:, :NB2].reshape(-1)
    y2 = jnp.dot(ainv, rc2[fid2], precision=HI)
    y2p = jnp.zeros_like(rc2).at[fid2].set(y2).reshape(bs2, NB2)
    y2pp = jnp.pad(y2p, ((0, 0), (0, st.ndev * nb2c - NB2)))
    y2l = jax.lax.dynamic_slice_in_dim(y2pp, i * nb2c, nb2c, 1)
    Wl_out = jnp.sum(rst1.astype(jnp.float32)
                     * y2l[:, None, :].astype(jnp.float32),
                     axis=0)                      # (win, nb2c)
    Wf = jnp.transpose(jax.lax.all_gather(Wl_out, axis),
                       (1, 0, 2)).reshape(W.shape[0], -1)[:, :NB2]
    xf = Wf.reshape(bs, sx, sy, sz, SX, SY, SZ) \
        .transpose(0, 4, 1, 5, 2, 6, 3).reshape(bs, BX, BY, BZ)
    return jax.lax.dynamic_slice_in_dim(xf, i * bxl, bxl, 1) \
        .reshape(-1)


def _vcycle_blk(st, vals0, dinv0, rst, blocks1, dinv1, r1, ainv,
                b_flat, x_flat, axis, vals0s=None, rst1=None, fid2=None):
    """One V-cycle on the local closed-slab blocks.  ``vals0s``: bf16
    smoother twin streamed by the preconditioner passes (the PCG matvec
    outside this function keeps the f32 vals0).  ``rst1``/``fid2``:
    superbrick-chunked coarsest restriction."""
    A = _local_op(st, vals0 if vals0s is None else vals0s)
    bh = _pad_local(st, b_flat)
    xh = _pad_local(st, x_flat)

    def smooth0(xh):
        for tau in st.taus0:
            xh = A.root_h(jnp.asarray([tau], jnp.float32), bh, dinv0,
                          _halo_fill(st, xh, axis))
        return xh

    xh = smooth0(xh)
    res = _unpad_local(st, A.residual_h(bh, _halo_fill(st, xh, axis)))
    b1 = _apply_R_blk(st, rst, res)

    # distributed mid level smoother + coarsest: every object O(N1/P)
    # per device, one brick-shell ppermute per root
    def mid_smooth(x1):
        for tau in st.taus1:
            x1 = x1 + dinv1 * (b1 - _mid_matvec_blk(st, blocks1, x1,
                                                    axis)) * tau
        return x1

    x1 = mid_smooth(jnp.zeros_like(b1))
    r1v = b1 - _mid_matvec_blk(st, blocks1, x1, axis)
    if rst1 is not None:
        x1 = x1 + _mid_coarsest_sb(st, rst1, ainv, fid2, r1v, axis)
    else:
        r1f = r1.astype(jnp.float32)
        y2 = jnp.dot(ainv, jax.lax.psum(jnp.dot(r1f, r1v, precision=HI),
                                        axis), precision=HI)
        x1 = x1 + jnp.dot(r1f.T, y2, precision=HI)
    x1 = mid_smooth(x1)

    xh = xh + _pad_local(st, _apply_P_blk(st, rst, x1, axis))
    return _unpad_local(st, smooth0(xh))


def _local_args(hs: ShardedStructured):
    return (hs.vals0, hs.dinv0, hs.rst, hs.blocks1, hs.dinv1, hs.r1,
            hs.ainv, hs.vals0s, hs.rst1, hs.fid2)


def _local_specs(axis):
    rp = P()
    return (P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), rp,
            P(axis), P(axis), rp)


def _unstack(vals0, dinv0, rst, blocks1, dinv1, r1, ainv, vals0s, rst1,
             fid2):
    """Per-device views of the stacked shards (leading axis of size 1
    under shard_map); replicated operands pass through."""
    one = lambda a: None if a is None else a[0]  # noqa: E731
    return dict(vals0=vals0[0], dinv0=dinv0[0], rst=rst[0],
                blocks1=blocks1[0], dinv1=dinv1[0], r1=r1[0], ainv=ainv,
                vals0s=one(vals0s), rst1=one(rst1), fid2=fid2)


def make_struct_sharded_vcycle(hs: ShardedStructured):
    """jitted z = B^{-1} b on (P, real*128) sharded blocks."""
    axis = hs.mesh.axis_names[0]
    st = hs.st
    from jax import shard_map

    def body(*args):
        *ops, b = args
        z = _vcycle_blk(st, **_unstack(*ops), b_flat=b[0],
                        x_flat=jnp.zeros_like(b[0]), axis=axis)
        return z[None]

    smapped = shard_map(
        body, mesh=hs.mesh, in_specs=_local_specs(axis) + (P(axis),),
        out_specs=P(axis), check_vma=False)
    return jax.jit(lambda b: smapped(*_local_args(hs), b))


def make_struct_sharded_pcg(hs: ShardedStructured, rel_tol: float = 1e-6,
                            max_iter: int = 200):
    """Fully-jitted sharded PCG (MFEM CGSolver semantics): local dots +
    psum, one XLA computation."""
    axis = hs.mesh.axis_names[0]
    st = hs.st
    from jax import shard_map

    def body(*args):
        *ops, b, rtol2 = args
        loc = _unstack(*ops)
        b = b[0]
        A = _local_op(st, loc["vals0"])

        def vc(r):
            return _vcycle_blk(st, **loc, b_flat=r,
                               x_flat=jnp.zeros_like(r), axis=axis)

        def spmv(x):
            xh = _halo_fill(st, _pad_local(st, x), axis)
            return _unpad_local(st, A.matvec_h(xh))

        def pdot(a, c):
            return _pdot(st, a, c, axis)

        z = vc(b)
        nom0 = pdot(z, b)
        # rtol2 is a traced operand: changing the tolerance through the
        # returned solver does NOT retrace (struct_pcg_solve's
        # no-retrace-per-tolerance contract, solve/structured.py)
        lim = nom0 * rtol2

        def cond(stt):
            x, r, d, Ad, nom, it = stt
            return jnp.logical_and(nom > lim, it < max_iter)

        def itbody(stt):
            x, r, d, Ad, nom, it = stt
            alpha = nom / pdot(d, Ad)
            x = x + alpha * d
            r = r - alpha * Ad
            z = vc(r)
            betanom = pdot(r, z)
            d = z + (betanom / nom) * d
            return (x, r, d, spmv(d), betanom, it + 1)

        stt = (jnp.zeros_like(b), b, z, spmv(z), nom0, jnp.int32(0))
        x, r, d, Ad, nom, it = jax.lax.while_loop(cond, itbody, stt)
        return x[None], it

    smapped = shard_map(
        body, mesh=hs.mesh,
        in_specs=_local_specs(axis) + (P(axis), P()),
        out_specs=(P(axis), P()), check_vma=False)
    jitted = jax.jit(lambda b, rtol2: smapped(*_local_args(hs), b, rtol2))

    def solve(b, rel_tol_override=None):
        rt = rel_tol if rel_tol_override is None else rel_tol_override
        return jitted(b, jnp.float32(rt * rt))

    return solve
