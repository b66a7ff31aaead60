"""Device-side Galerkin triple product for the structured (brick/tent)
setup: Ac = P^T A P as batched XLA window contractions on the device
instead of the host scipy SpGEMM chain.

The reference computes the coarse operator with hypre's distributed
RAP (tg.hpp:696, interp.cpp:177-228).  The single-controller analog
here exploits the same structure the structured solve path uses
(solve/structured.py): with a Cartesian brick partitioning and a tent
P, every column of P lives in its master brick's closed dof box and
the fine A is a <=27-point stencil, so

  1. AP is brick-local with an EXTENDED window: for t in the
     (b+3)^3 box around brick q (global node u = q*b + t - 1),
       APq[s', t, q] = sum_e a_e[u] * Rst[s', t-1+e, q]
     where a_e[u] = A[u, u+e] are the DIA diagonals of A — 27
     elementwise multiply-adds over statically-sliced windows;
  2. Ac couples only neighbor bricks (|d|_inf <= 1):
       Ac_d[s, s', p] = sum_w Rst[s, w, p] * APq[s', w - d*b + 1, p+d]
     — 27 einsum contractions over the static window overlaps.

Everything runs in one jit (f32 accumulation with precision='highest'
on the contraction); the resulting per-offset blocks are fetched and
scattered into a scipy CSR for the rest of the (host, f64) setup.
Relative error vs the f64 host RAP is at the f32 representation level
(~1e-6); the device RAP is therefore OPT-IN (rap_override) for the
large-scale device-setup pipeline, where the spectral cut is already
computed in mixed precision (the --device-rap flag of
run_scale_setup).

The same contraction shards over an x-slab mesh with a one-brick-layer
halo of APq (sharded_structured_rap) — the distributed-RAP analog of
hypre's ParCSR RAP, device-count invariant by construction.
"""

from __future__ import annotations

from typing import Tuple

from functools import lru_cache

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from saamge_jax.ops.sparse import DeviceDIA
from saamge_jax.utils.logging import TIMERS, sa_print


def _expand_ext(x, axis, b, nb):
    """(…, nb*b+pad, …) -> (…, nb, b+3, …): window [p*b-1, p*b+b+1]
    per brick p along one axis (the grid must be pre-padded by 1 zero
    in front and >= b+2 zeros behind along this axis).  Plane k of
    brick p sits at padded index p*b + k, k = 0..b+2 — one strided
    slice per k, stacked."""
    cols = []
    for k in range(b + 3):
        s = jax.lax.slice_in_dim(x, k, k + (nb - 1) * b + 1, stride=b,
                                 axis=axis)
        cols.append(s)
    return jnp.stack(cols, axis=axis + 1)        # (…, nb, b+3, …)


def _neighbor_shift(blk, d, bricks):
    """blk (…, BX, BY, BZ) -> values of brick p+d at index p (zero
    beyond the grid): static slice + pad per axis."""
    out = blk
    for ax, (dd, Bn) in enumerate(zip(d, bricks)):
        axis = out.ndim - 3 + ax
        if dd == 0:
            continue
        if dd == 1:
            s = jax.lax.slice_in_dim(out, 1, Bn, axis=axis)
            pad = [(0, 0)] * out.ndim
            pad[axis] = (0, 1)
        else:
            s = jax.lax.slice_in_dim(out, 0, Bn - 1, axis=axis)
            pad = [(0, 0)] * out.ndim
            pad[axis] = (1, 0)
        out = jnp.pad(s, pad)
    return out


def _ranges(dd: int, b: int) -> Tuple[int, int, int]:
    """Per-axis overlap of w in [0,b] with t' = w - dd*b + 1 in
    [0, b+2]: returns (w_lo, w_hi_inclusive, t_lo)."""
    if dd == 0:
        return 0, b, 1
    if dd == 1:
        return b - 1, b, 0
    return 0, 1, b + 1


def _compute_ap(vals3x, rst6, be, offsets3, x_prehaloed=False):
    """APq (bs, bx+3, by+3, bz+3, BXl, BY, BZ) from DIA diagonal node
    grids.  With ``x_prehaloed`` the x axis of vals3x already carries
    the one-node halo planes (sharded slabs); y/z are padded here."""
    bx, by, bz = be
    bs = rst6.shape[0]
    BXl, BY, BZ = rst6.shape[-3:]
    ap = jnp.zeros((bs, bx + 3, by + 3, bz + 3, BXl, BY, BZ),
                   jnp.float32)

    def tr(e, b):
        # inclusive t range with w = t - 1 + e in [0, b]; for
        # e in {-1,0,1} the w range is always the full window
        return max(0, 1 - e), min(b + 2, b + 1 - e)

    xpad = (0, 2) if x_prehaloed else (1, bx + 2)
    for j, (ex, ey, ez) in enumerate(offsets3):
        g = jnp.pad(vals3x[j], (xpad, (1, by + 2), (1, bz + 2)))
        X = _expand_ext(g, 0, bx, BXl)
        X = _expand_ext(X, 2, by, BY)
        X = _expand_ext(X, 4, bz, BZ)
        exw = X.transpose(1, 3, 5, 0, 2, 4)
        ax0, ax1 = tr(ex, bx)
        ay0, ay1 = tr(ey, by)
        az0, az1 = tr(ez, bz)
        t_sl = (slice(None), slice(ax0, ax1 + 1),
                slice(ay0, ay1 + 1), slice(az0, az1 + 1))
        ap = ap.at[t_sl].add(exw[t_sl[1:]] * rst6)
    return ap


def _rap_blocks(ap_ext, rst6, be):
    """27 neighbor-offset coarse blocks from the x-EXTENDED AP
    (bs, bx+3, by+3, bz+3, BXl+2, BY, BZ): the x-neighbor columns come
    from the two extra brick layers (zero or halo-exchanged), y/z from
    in-grid shifts."""
    bx, by, bz = be
    bs = rst6.shape[0]
    BXl, BY, BZ = rst6.shape[-3:]
    blocks = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                wx0, wx1, tx0 = _ranges(dx, bx)
                wy0, wy1, ty0 = _ranges(dy, by)
                wz0, wz1, tz0 = _ranges(dz, bz)
                r_sl = (slice(None), slice(wx0, wx1 + 1),
                        slice(wy0, wy1 + 1), slice(wz0, wz1 + 1))
                t_sl = (slice(None),
                        slice(tx0, tx0 + wx1 - wx0 + 1),
                        slice(ty0, ty0 + wy1 - wy0 + 1),
                        slice(tz0, tz0 + wz1 - wz0 + 1))
                apn = ap_ext[t_sl][..., 1 + dx:1 + dx + BXl, :, :]
                apn = _neighbor_shift(apn, (0, dy, dz),
                                      (BXl, BY, BZ))
                blocks.append(jnp.einsum(
                    "swn,zwn->szn",
                    rst6[r_sl].reshape(bs, -1, BXl * BY * BZ),
                    apn.reshape(bs, -1, BXl * BY * BZ),
                    precision="highest"))
    return jnp.stack(blocks)              # (27, bs, bs, NB_loc)


def _rap_jit(be, bricks, offsets3):
    def run(vals3, rst6):
        # vals3: (k, NXn, NYn, NZn) DIA diagonals as node grids
        # rst6: (bs, bx+1, by+1, bz+1, BX, BY, BZ)
        ap = _compute_ap(vals3, rst6, be, offsets3)
        ap_ext = jnp.pad(ap, [(0, 0)] * 4 + [(1, 1), (0, 0), (0, 0)])
        return _rap_blocks(ap_ext, rst6, be)

    return jax.jit(run)


def structured_rap(A: sp.csr_matrix, rels, tent_interp: sp.csr_matrix,
                   mis_numcoarsedof, geo) -> sp.csr_matrix:
    """Ac = P^T A P on device for a brick-structured tent P.

    ``geo``: solve.structured.BrickGeometry of the partitioning."""
    from saamge_jax.solve.structured import build_structured_interp
    with TIMERS.phase("setup.rap_device"):
        be, bricks = geo.brick_elems, geo.bricks
        bx, by, bz = be
        BX, BY, BZ = bricks
        nodes = geo.nodes
        dia = DeviceDIA.try_from_csr(A, jnp.float32, max_diags=64)
        assert dia is not None, "A is not stencil-structured"
        offsets3 = _offsets3(dia.offsets, nodes)
        vals3 = jnp.asarray(np.asarray(dia.vals).reshape(
            len(offsets3), *nodes))

        Rst_bm, cd_brick, slot, bs = build_structured_interp(
            rels, tent_interp, mis_numcoarsedof, geo)
        rst6 = jnp.asarray(
            np.ascontiguousarray(
                Rst_bm.transpose(1, 2, 0)).reshape(
                bs, bx + 1, by + 1, bz + 1, BX, BY, BZ), jnp.float32)

        fn = _rap_scan_jit(be, bricks)
        offs = jnp.asarray(np.asarray(offsets3, np.int32))
        blocks = np.asarray(fn(vals3, offs, rst6))  # (27, bs, bs, NB)
        return _assemble_csr(blocks, cd_brick, slot, bs, geo)


def _assemble_csr(blocks: np.ndarray, cd_brick, slot, bs: int,
                  geo) -> sp.csr_matrix:
    """(27, bs, bs, NB) neighbor-offset blocks -> coarse CSR on the
    real (unpadded) coarse dof numbering."""
    BX, BY, BZ = geo.bricks
    NB = geo.num_bricks
    # coarse id of (p, s): invert (cd_brick, slot)
    cid = np.full((NB, bs), -1, np.int64)
    cid[cd_brick, slot] = np.arange(len(cd_brick))
    rows, cols, vals = [], [], []
    d_list = [(dx, dy, dz) for dx in (-1, 0, 1)
              for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    p3 = np.arange(NB)
    px, r = divmod(p3, BY * BZ)
    py, pz = divmod(r, BZ)
    s_i, s_j = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
    for di, (dx, dy, dz) in enumerate(d_list):
        qx, qy, qz = px + dx, py + dy, pz + dz
        ok = ((qx >= 0) & (qx < BX) & (qy >= 0) & (qy < BY)
              & (qz >= 0) & (qz < BZ))
        p_ok = p3[ok]
        q_ok = (qx[ok] * BY + qy[ok]) * BZ + qz[ok]
        blk = blocks[di][:, :, p_ok]              # (bs, bs, m)
        ri = cid[p_ok][:, s_i.ravel()]            # (m, bs*bs)
        cj = cid[q_ok][:, s_j.ravel()]
        vv = blk.reshape(bs * bs, -1).T           # (m, bs*bs)
        keep = (ri >= 0) & (cj >= 0)
        rows.append(ri[keep])
        cols.append(cj[keep])
        vals.append(vv[keep])
    nc = len(cd_brick)
    Ac = sp.coo_matrix(
        (np.concatenate(vals).astype(np.float64),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(nc, nc)).tocsr()
    Ac.sum_duplicates()
    # drop explicit zeros from the padded blocks
    Ac.eliminate_zeros()
    sa_print(4, "device RAP: nc=%d nnz=%d", nc, Ac.nnz)
    return Ac


def make_structured_rap_override(geo):
    """rap_override for ml_produce_data: device RAP on the finest
    coarsening (where the brick/tent structure holds), host scipy
    product elsewhere."""
    def override(A, tg, rels, level):
        if level != 0 or tg.smooth_interp:
            return None                   # fall back to host RAP
        try:
            return structured_rap(A, rels, tg.tent_interp,
                                  tg.interp_data.mis_numcoarsedof, geo)
        except AssertionError as e:       # not stencil/brick structured
            sa_print(3, "device RAP fallback to host: %s", e)
            return None
    return override


def sharded_structured_rap(A: sp.csr_matrix, rels,
                           tent_interp: sp.csr_matrix,
                           mis_numcoarsedof, geo, mesh) -> sp.csr_matrix:
    """Distributed Ac = P^T A P over an x-slab device mesh — the
    hypre ParCSR RAP analog (interp.cpp:177-228): each shard computes
    the AP window blocks of its own bricks from its node slab (the
    one-node overlap planes are part of the slab, like overlapped
    dofs), exchanges ONE brick layer of AP with each x neighbor by
    ``ppermute`` (the interface data of the product), and contracts
    its own 27 coarse blocks.  Device-count invariant by construction;
    single-controller assembly of the CSR from the gathered blocks."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from saamge_jax.solve.structured import build_structured_interp

    with TIMERS.phase("setup.rap_device"):
        be = geo.brick_elems
        bx, by, bz = be
        BX, BY, BZ = geo.bricks
        NB = geo.num_bricks
        nodes = geo.nodes
        ndev = mesh.devices.size
        assert BX % ndev == 0, (BX, ndev)
        BXl = BX // ndev
        slab = BXl * bx

        dia = DeviceDIA.try_from_csr(A, jnp.float32, max_diags=64)
        assert dia is not None, "A is not stencil-structured"
        offsets3 = _offsets3(dia.offsets, nodes)
        vals_np = np.asarray(dia.vals).reshape(len(offsets3), *nodes)
        # per-shard node slabs WITH the one-node ext-window halo:
        # x planes [d*slab - 1, (d+1)*slab + 1] (zeros beyond the grid)
        k = len(offsets3)
        vals_sh = np.zeros((ndev, k, slab + 3, nodes[1], nodes[2]),
                           np.float32)
        for d in range(ndev):
            lo = d * slab - 1
            s0 = max(0, lo)
            s1 = min(nodes[0], lo + slab + 3)
            vals_sh[d, :, s0 - lo:s1 - lo] = vals_np[:, s0:s1]

        Rst_bm, cd_brick, slot, bs = build_structured_interp(
            rels, tent_interp, mis_numcoarsedof, geo)
        rst6 = np.ascontiguousarray(
            Rst_bm.transpose(1, 2, 0)).reshape(
            bs, bx + 1, by + 1, bz + 1, BX, BY, BZ)
        rst_sh = np.ascontiguousarray(
            rst6.reshape(bs, bx + 1, by + 1, bz + 1, ndev, BXl, BY, BZ)
            .transpose(4, 0, 1, 2, 3, 5, 6, 7))

        axis = mesh.axis_names[0]

        def body(vals_l, rst_l):
            vals_l, rst_l = vals_l[0], rst_l[0]
            ap = _compute_ap(vals_l, rst_l, be, tuple(offsets3),
                             x_prehaloed=True)
            # one-brick-layer AP halo exchange (the product's
            # interface data)
            i = jax.lax.axis_index(axis)
            right_of = [(d, (d + 1) % ndev) for d in range(ndev)]
            left_of = [(d, (d - 1) % ndev) for d in range(ndev)]
            from_left = jax.lax.ppermute(ap[..., -1:, :, :], axis,
                                         right_of)
            from_right = jax.lax.ppermute(ap[..., :1, :, :], axis,
                                          left_of)
            from_left = jnp.where(i == 0, 0.0, from_left)
            from_right = jnp.where(i == ndev - 1, 0.0, from_right)
            ap_ext = jnp.concatenate([from_left, ap, from_right],
                                     axis=-3)
            return _rap_blocks(ap_ext, rst_l, be)[None]

        smapped = shard_map(
            body, mesh=mesh, in_specs=(P(axis), P(axis)),
            out_specs=P(axis), check_vma=False)
        put = lambda a: jax.device_put(  # noqa: E731
            jnp.asarray(a), NamedSharding(mesh, P(axis)))
        blocks_sh = np.asarray(jax.jit(smapped)(
            put(vals_sh), put(rst_sh)))   # (ndev, 27, bs, bs, NB_loc)
        blocks = np.concatenate(
            [blocks_sh[d].reshape(27, bs, bs, BXl, BY, BZ)
             for d in range(ndev)], axis=3).reshape(27, bs, bs, NB)
        return _assemble_csr(blocks, cd_brick, slot, bs, geo)


def _offsets3(offsets, nodes):
    """DIA offsets -> (dx, dy, dz) stencil triples (|d|_inf <= 1)."""
    NYn, NZn = nodes[1], nodes[2]
    out = []
    for o in offsets:
        o = int(o)
        ex, r = divmod(o + NYn * NZn + NZn + 1, NYn * NZn)
        ey, ez = divmod(r, NZn)
        tri = (ex - 1, ey - 1, ez - 1)
        assert tri[0] * NYn * NZn + tri[1] * NZn + tri[2] == o \
            and max(abs(t) for t in tri) <= 1, o
        out.append(tri)
    return out


# ---------------------------------------------------------------------------
# compile-light scan formulation


@lru_cache(maxsize=8)
def _rap_scan_jit(be, bricks):
    """The same RAP as _rap_jit but with the 27-way stencil and
    neighbor loops as ``lax.scan`` bodies (program ~27x smaller, so
    it compiles much faster than the unrolled version).

    Dynamic shifts use the roll-and-mask identity: placing C[w] at
    t = w + 1 - e is a static (1,1) zero-pad followed by roll(-e) —
    the cyclic wrap lands only on the zero pad planes, so no masking
    is needed for the AP build; the neighbor-offset contraction rolls
    AP by d*b - 1 per t axis (reading t' = w - d*b + 1) and by -d per
    brick axis, masking the w overlap and the grid boundary."""
    bx, by, bz = be
    BX, BY, BZ = bricks
    bvec = (bx, by, bz)

    def run(vals3, offs, rst6):
        # vals3 (k, NXn, NYn, NZn); offs (k, 3) int32; rst6 as in _rap_jit
        bs = rst6.shape[0]

        def ap_body(ap, inp):
            g, e = inp
            gp = jnp.pad(g, ((1, bx + 2), (1, by + 2), (1, bz + 2)))
            X = _expand_ext(gp, 0, bx, BX)
            X = _expand_ext(X, 2, by, BY)
            X = _expand_ext(X, 4, bz, BZ)
            exw = X.transpose(1, 3, 5, 0, 2, 4)   # (bx+3,by+3,bz+3,B..)
            # window values at t = w + 1 - e: slice exw at the e-shifted
            # w window via roll (wrap hits only out-of-window planes)
            w_exw = exw
            for ax in range(3):
                w_exw = jnp.roll(w_exw, -(1 - e[ax]), axis=ax)
            w_exw = w_exw[:bx + 1, :by + 1, :bz + 1]
            C = w_exw * rst6                      # (bs, bx+1, .., B..)
            D = jnp.pad(C, [(0, 0)] + [(1, 1)] * 3 + [(0, 0)] * 3)
            for ax in range(3):
                D = jnp.roll(D, -e[ax], axis=1 + ax)
            return ap + D, None

        ap0 = jnp.zeros((bs, bx + 3, by + 3, bz + 3, BX, BY, BZ),
                        jnp.float32)
        ap, _ = jax.lax.scan(ap_body, ap0, (vals3, offs))

        d_list = jnp.asarray(
            [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
             for dz in (-1, 0, 1)], jnp.int32)

        def blk_body(_, d):
            B = ap
            for ax in range(3):
                b_ax = bvec[ax]
                # t' = w - d*b + 1  ->  roll by d*b - 1, keep [0, b]
                B = jnp.roll(B, d[ax] * b_ax - 1, axis=1 + ax)
            B = B[:, :bx + 1, :by + 1, :bz + 1]
            # w-overlap mask per axis (only face windows couple at d!=0)
            for ax, Bn in enumerate((BX, BY, BZ)):
                b_ax = bvec[ax]
                w = jax.lax.iota(jnp.int32, b_ax + 1)
                lo = jnp.where(d[ax] == 1, b_ax - 1, 0)
                hi = jnp.where(d[ax] == -1, 1, b_ax)
                m = ((w >= lo) & (w <= hi)).astype(jnp.float32)
                B = B * m.reshape((1,) + (1,) * ax + (b_ax + 1,)
                                  + (1,) * (2 - ax) + (1, 1, 1))
                # neighbor brick p+d with zero beyond the grid
                B = jnp.roll(B, -d[ax], axis=4 + ax)
                p = jax.lax.iota(jnp.int32, Bn)
                pm = ((p + d[ax] >= 0) & (p + d[ax] < Bn)) \
                    .astype(jnp.float32)
                B = B * pm.reshape((1, 1, 1, 1) + (1,) * ax + (Bn,)
                                   + (1,) * (2 - ax))
            blk = jnp.einsum(
                "swn,zwn->szn",
                rst6.reshape(bs, -1, BX * BY * BZ),
                B.reshape(bs, -1, BX * BY * BZ),
                precision="highest")
            return None, blk

        _, blocks = jax.lax.scan(blk_body, None, d_list)
        return blocks                      # (27, bs, bs, NB)

    return jax.jit(run)
