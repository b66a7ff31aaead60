"""Gather-free structured hierarchy: the device solve path for
structured hex meshes with brick agglomeration.

With a Cartesian brick partitioning (topology/part.py
partition_cartesian_3d) the whole solve phase needs no gathers: every
operator is a stencil, a strided window or a batch of dense blocks, so
each pass streams its operands once.

 - FINE level: 27-point stencil -> haloed DIA passes (ops/stencil.py).
 - TENTATIVE P/R: every MIS is a face/edge/corner/interior box of the
   brick grid and lies inside its MASTER brick's closed dof box (master =
   lowest containing AE, the reference's lowest-owner-rank rule,
   aggregates.cpp:271-299).  Restriction is therefore
   strided-window extraction (axis-by-axis reshape+concat overlap
   decomposition, extract_boxes: pure strided copies) + one batched
   dense contraction per brick;
   prolongation is the transposed contraction + an 8-piece static-slice
   overlap assembly (upper-half-open tiling: dof plane g = k*b belongs to
   brick k-1, so pieces are disjoint static slices — no scatter).
 - COARSE dofs live in a brick-major PADDED layout: brick p's coarse dofs
   occupy slots [p*bs, p*bs + count_p), zero-padded to a common bs.  The
   Galerkin operator couples brick p only to its <=27 brick neighbors
   (tent P supports live in closed brick boxes; the fine stencil reaches
   one node), so it is stored as a BRICK-BLOCK operator: one dense
   (NB, bs, bs) block array per nonzero brick offset, applied as one
   batched multiply-reduce against 27 statically-shifted views of the
   padded coarse vector — gather-free, and far less traffic than the
   dense operator it replaces.
 - COARSEST: dense inverse applied as a matvec (one streamed GEMV instead
   of two serial triangular solves; exactness only affects
   preconditioner quality, cf. the reference's UMFPACK/BoomerAMG coarse
   solve, tg.cpp:991-1012).

Every f32 x f32 product on this path asks for HIGHEST precision: the
GPU would otherwise run it in TF32 (about three decimal digits).

Reference counterparts: tg_cycle_atb (tg.cpp:91), interp tent blocks
(contrib.cpp:551-716), coarse Dof_TrueDof block offsets
(aggregates.cpp:1693-1702).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from saamge_jax.ops.sparse import DeviceDIA
from saamge_jax.ops.stencil import StencilDIA, inv_tau_arrays

HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# host-side builders


@dataclasses.dataclass
class BrickGeometry:
    """Static geometry of a brick-partitioned structured hex mesh.

    Nodes per dim are (BX*bx+1, BY*by+1, BZ*bz+1); fine dof id is
    x-major lexicographic (fem/mesh.py hex_mesh vid)."""

    bricks: Tuple[int, int, int]      # (BX, BY, BZ)
    brick_elems: Tuple[int, int, int]  # (bx, by, bz)

    @property
    def nodes(self):
        (BX, BY, BZ), (bx, by, bz) = self.bricks, self.brick_elems
        return (BX * bx + 1, BY * by + 1, BZ * bz + 1)

    @property
    def num_bricks(self):
        return int(np.prod(self.bricks))

    @property
    def box(self):
        bx, by, bz = self.brick_elems
        return (bx + 1) * (by + 1) * (bz + 1)


def coarse_brick_numbering(rels, mis_numcoarsedof: np.ndarray):
    """Group coarse dofs by the master brick of their MIS (master = min
    containing AE) and assign slots; returns (brick, slot, bs) per coarse
    dof plus counts.  This is the coarse Dof_TrueDof block structure of
    the reference (aggregates.cpp:1610-1730) specialized to bricks."""
    nm = rels.num_mises
    ncd = np.asarray(mis_numcoarsedof, dtype=np.int64)
    # master AE per MIS = min of the containing AEs
    m2a = rels.mis_to_AE
    sizes = m2a.row_sizes()
    master = np.full(nm, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(master, np.repeat(np.arange(nm), sizes), m2a.indices)
    cd_mis = np.repeat(np.arange(nm), ncd)
    cd_brick = master[cd_mis]
    counts = np.bincount(cd_brick, minlength=rels.nparts)
    bs = int(counts.max())
    # slot = position within brick, coarse dofs in ascending c order
    order = np.argsort(cd_brick, kind="stable")
    slot = np.empty(len(cd_mis), dtype=np.int64)
    starts = np.zeros(rels.nparts + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot[order] = np.arange(len(cd_mis)) - starts[cd_brick[order]]
    return cd_brick, slot, bs, counts


def build_structured_interp(rels, P: sp.csr_matrix,
                            mis_numcoarsedof: np.ndarray,
                            geo: BrickGeometry):
    """Dense per-brick tentative interpolation blocks.

    Returns (Rst, cd_brick, slot, bs): Rst (NB, bs, box) with
    Rst[p, s, boxpos] = P[fine dof at boxpos of brick p's closed box,
    coarse dof (p, s)] — the per-MIS tent interps regrouped by master
    brick (contrib.cpp mis_tent_interps)."""
    (BX, BY, BZ) = geo.bricks
    (bx, by, bz) = geo.brick_elems
    NXn, NYn, NZn = geo.nodes
    NB, box = geo.num_bricks, geo.box
    cd_brick, slot, bs, _ = coarse_brick_numbering(rels, mis_numcoarsedof)

    Pc = P.tocsc()
    n_c = Pc.shape[1]
    assert len(cd_brick) == n_c, (len(cd_brick), n_c)
    rows = Pc.indices
    vals = Pc.data
    col_of = np.repeat(np.arange(n_c), np.diff(Pc.indptr))
    # fine dof -> grid coords (x-major lex: ix*NYn*NZn + iy*NZn + iz)
    ix, rem = np.divmod(rows, NYn * NZn)
    iy, iz = np.divmod(rem, NZn)
    pb = cd_brick[col_of]
    pz = pb % BZ
    py = (pb // BZ) % BY
    px = pb // (BY * BZ)
    u = ix - px * bx
    v = iy - py * by
    w = iz - pz * bz
    ok = ((u >= 0) & (u <= bx) & (v >= 0) & (v <= by)
          & (w >= 0) & (w <= bz))
    if not np.all(ok):
        raise ValueError(
            "tent column escapes its master brick's closed box — "
            "partitioning is not brick-structured")
    boxpos = (u * (by + 1) + v) * (bz + 1) + w
    Rst = np.zeros((NB, bs, box), dtype=np.float32)
    Rst[pb, slot[col_of], boxpos] = vals
    return Rst, cd_brick, slot, bs


def build_structured_interp2(rels1, P1: sp.csr_matrix,
                             mis_numcoarsedof1: np.ndarray,
                             geo: BrickGeometry, supers,
                             cd_brick: np.ndarray, slot: np.ndarray,
                             bs: int):
    """Block-diagonal level-2 tent restriction blocks over superbricks.

    In the slot-major master-brick layout every level-2 tent column is
    supported on level-1 dofs whose MASTER brick lies inside the
    column's master superbrick: a dof with master brick p in superbrick
    S' belongs to AE2 S' (its MIS1 is contained in brick p), so its
    MIS2 signature-min is <= S' — a master-S MIS2 can only hold dofs
    with master bricks in S.  Hence R1 is BLOCK-DIAGONAL over
    superbricks (no window overlap, unlike the node-grid fine level)
    and applies as a reshape/transpose + one batched contraction —
    replacing the dense (n2, n_flat) restriction (7 GB/cycle at 8.12M
    dofs) with the ~NB2*bs2*win tent blocks.

    Returns (Rst1 (bs2, win, NB2), cd2_brick, slot2, bs2) with
    win = bs*sx*sy*sz and window position ((s*sx+lx)*sy+ly)*sz+lz
    (matching apply_R1's reshape/transpose).  Reference counterpart:
    coarse-level Dof_TrueDof blocks, aggregates.cpp:1610-1730."""
    (BX, BY, BZ) = geo.bricks
    SX, SY, SZ = supers
    if BX % SX or BY % SY or BZ % SZ:
        raise ValueError("supers must divide the brick grid evenly")
    sx, sy, sz = BX // SX, BY // SY, BZ // SZ
    cd2_brick, slot2, bs2, _ = coarse_brick_numbering(
        rels1, mis_numcoarsedof1)
    NB2 = SX * SY * SZ
    win = bs * sx * sy * sz
    Pc = P1.tocsc()
    n2 = Pc.shape[1]
    assert len(cd2_brick) == n2, (len(cd2_brick), n2)
    rows = Pc.indices                       # level-1 coarse dof ids
    vals = Pc.data
    col_of = np.repeat(np.arange(n2), np.diff(Pc.indptr))
    p = cd_brick[rows]
    s = slot[rows]
    pz = p % BZ
    py = (p // BZ) % BY
    px = p // (BY * BZ)
    S = cd2_brick[col_of]
    Sz = S % SZ
    Sy = (S // SZ) % SY
    Sx = S // (SY * SZ)
    lx, ly, lz = px - Sx * sx, py - Sy * sy, pz - Sz * sz
    ok = ((lx >= 0) & (lx < sx) & (ly >= 0) & (ly < sy)
          & (lz >= 0) & (lz < sz))
    if not np.all(ok):
        raise ValueError(
            "level-2 tent column escapes its master superbrick — "
            "the 3rd-level partitioning is not superbrick-structured")
    winpos = ((s * sx + lx) * sy + ly) * sz + lz
    Rst1 = np.zeros((bs2, win, NB2), dtype=np.float32)
    Rst1[slot2[col_of], winpos, S] = vals
    return Rst1, cd2_brick, slot2, bs2


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BrickBlockOp:
    """Mid-level Galerkin operator in the SLOT-MAJOR padded brick layout
    (coarse dof (brick p, slot s) lives at flat id s*NB + p).

    blocks[k, s1, s2, p] = Ac[(p, s1), (p + doffs[k], s2)] over the <=27
    nonzero brick offsets.  Slot-major puts the large brick axis last
    (contiguous), so the matvec is an elementwise multiply-reduce
    streaming the blocks once instead of a batch of tiny bs x bs GEMVs.
    Neighbor values come from <=27 statically-shifted views of the
    brick-shell-padded vector — no gathers; traffic = k * NB * bs^2 *
    itemsize per pass (vs n_c^2 dense; the coarse Dof_TrueDof block
    structure of the reference, aggregates.cpp:1610-1730, specialized to
    bricks)."""

    blocks: jnp.ndarray      # (k, bs, bs, NB), f32 or bf16
    doffs: tuple             # k static (dx, dy, dz) brick offsets
    bricks: tuple            # (BX, BY, BZ) static
    bs: int                  # static
    # per-offset used-slot rectangles (r1_k, r2_k): slot pairs beyond
    # the rectangle are structurally zero (far brick offsets couple
    # only low slots), so the matvec slices them away — 2.4x less
    # HBM traffic at n=256 (4564 of 27*20^2 slot pairs read) with the
    # dense storage layout (and hence the sharded path) unchanged.
    # None = dense rectangles (legacy behavior).
    rects: Optional[tuple] = None
    # symmetry-halved streaming: the operator is symmetric (a Galerkin
    # product), so B_{-d}[s2, s1, p + d] = B_{+d}[s1, s2, p]; the rect
    # matvec then reads only the lexicographically non-negative offsets
    # and applies each slice both ways (forward + transposed-shifted),
    # halving the HBM block stream.  Storage stays full so the sharded
    # path (which never calls this matvec) is unchanged.
    sym_stream: bool = False

    def tree_flatten(self):
        return (self.blocks,), (self.doffs, self.bricks, self.bs,
                                self.rects, self.sym_stream)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @property
    def nbytes(self):
        return self.blocks.size * self.blocks.dtype.itemsize

    def _sym_keep(self):
        return _sym_keep(self.doffs)

    @property
    def traffic_bytes(self):
        """Bytes the matvec actually streams (rect slices when the
        rect path is active, else the full blocks)."""
        NB = int(np.prod(self.bricks))
        it = self.blocks.dtype.itemsize
        if self.rects is None or self.nbytes < self.RECT_MIN_BYTES:
            return self.blocks.size * it
        keep = self._sym_keep() if self.sym_stream \
            else range(len(self.doffs))
        return sum(self.rects[i][0] * self.rects[i][1]
                   for i in keep) * NB * it

    # Below this blocks size ONE fused multiply-reduce over all offsets
    # runs (per-op launch cost dominates small operators); above it the
    # per-offset rectangle slices skip the structurally-zero slot pairs.
    # The crossover has not been measured on the GPU yet.
    RECT_MIN_BYTES = 96 * 1024 * 1024

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        (BX, BY, BZ), bs = self.bricks, self.bs
        NB = BX * BY * BZ
        x4 = x.reshape(bs, BX, BY, BZ)
        xp = jnp.pad(x4, ((0, 0), (1, 1), (1, 1), (1, 1)))
        use_rect = (self.rects is not None
                    and self.nbytes >= self.RECT_MIN_BYTES)
        if not use_rect:
            views = [
                jax.lax.slice(xp, (0, 1 + dx, 1 + dy, 1 + dz),
                              (bs, 1 + dx + BX, 1 + dy + BY, 1 + dz + BZ))
                .reshape(bs, -1)
                for (dx, dy, dz) in self.doffs]
            xs = jnp.stack(views).astype(self.blocks.dtype)  # (k, bs, NB)
            y = jnp.sum(self.blocks.astype(jnp.float32)
                        * xs[:, None, :, :].astype(jnp.float32),
                        axis=(0, 2))
            return y.reshape(-1)
        # per-offset multiply-reduce over the used-slot rectangle only;
        # f32 accumulation, one stream over the sliced blocks.  With
        # sym_stream only the non-negative offsets are read; each slice
        # additionally contributes the -d coupling as a transposed
        # product shifted by +d (exact — same values, reassociated)
        keep = self._sym_keep() if self.sym_stream \
            else range(len(self.doffs))
        y = jnp.zeros((bs, NB), jnp.float32)
        for i in keep:
            dx, dy, dz = self.doffs[i]
            r1, r2 = self.rects[i]
            view = jax.lax.slice(
                xp, (0, 1 + dx, 1 + dy, 1 + dz),
                (r2, 1 + dx + BX, 1 + dy + BY, 1 + dz + BZ)
            ).reshape(r2, NB).astype(self.blocks.dtype)
            Bk = jax.lax.slice(self.blocks, (i, 0, 0, 0),
                               (i + 1, r1, r2, NB))[0]
            Bf = Bk.astype(jnp.float32)
            part = jnp.sum(Bf * view[None].astype(jnp.float32), axis=1)
            y = y.at[:r1].add(part)
            if self.sym_stream and (dx, dy, dz) != (0, 0, 0):
                # W[s2, p] = sum_s1 B[s1, s2, p] x[s1, p], scattered to
                # brick p + d via a pad-and-slice shift (out-of-grid
                # targets are dropped; B[:, :, p] is zero there anyway)
                x1 = jax.lax.slice(
                    x4, (0, 0, 0, 0), (r1, BX, BY, BZ)
                ).reshape(r1, NB).astype(self.blocks.dtype)
                W = jnp.sum(Bf * x1[:, None].astype(jnp.float32),
                            axis=0)
                W4 = jnp.pad(W.reshape(r2, BX, BY, BZ),
                             ((0, 0), (1, 1), (1, 1), (1, 1)))
                sh = jax.lax.slice(
                    W4, (0, 1 - dx, 1 - dy, 1 - dz),
                    (r2, 1 - dx + BX, 1 - dy + BY, 1 - dz + BZ))
                y = y.at[:r2].add(sh.reshape(r2, NB))
        return y.reshape(-1)

    @staticmethod
    def from_csr(Ac: sp.csr_matrix, cd_brick: np.ndarray,
                 slot: np.ndarray, bs: int, bricks: Tuple[int, int, int],
                 dtype=jnp.float32) -> "BrickBlockOp":
        BX, BY, BZ = bricks
        coo = Ac.tocoo()
        p, q = cd_brick[coo.row], cd_brick[coo.col]
        pz, qz = p % BZ, q % BZ
        py, qy = (p // BZ) % BY, (q // BZ) % BY
        px, qx = p // (BY * BZ), q // (BY * BZ)
        dx, dy, dz = qx - px, qy - py, qz - pz
        if max(np.abs(dx).max(), np.abs(dy).max(), np.abs(dz).max()) > 1:
            raise ValueError(
                "coarse coupling beyond brick neighbors — partitioning "
                "is not brick-structured")
        dkey = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)
        used = np.unique(dkey)
        kmap = np.full(27, -1, dtype=np.int64)
        kmap[used] = np.arange(len(used))
        NB = BX * BY * BZ
        blocks = np.zeros((len(used), bs, bs, NB), dtype=np.float64)
        np.add.at(blocks, (kmap[dkey], slot[coo.row], slot[coo.col], p),
                  coo.data)
        doffs = tuple((int(u) // 9 - 1, (int(u) // 3) % 3 - 1,
                       int(u) % 3 - 1) for u in used)
        # used-slot rectangle per offset (see class docstring)
        ki = kmap[dkey]
        s1a, s2a = slot[coo.row], slot[coo.col]
        rects = []
        for j in range(len(used)):
            m = ki == j
            rects.append((int(s1a[m].max()) + 1, int(s2a[m].max()) + 1))
        # direction-symmetrize the rectangles (rect of -d := transpose
        # of rect of +d): a fp-level cancellation in the host RAP could
        # otherwise make the pattern one-sided, breaking the symmetric
        # halving paths' structural assumption
        dmap = {d: j for j, d in enumerate(doffs)}
        for j, d in enumerate(doffs):
            nd = (-d[0], -d[1], -d[2])
            if nd in dmap:
                jn = dmap[nd]
                r1, r2 = rects[j]
                rects[j] = (max(r1, rects[jn][1]), max(r2, rects[jn][0]))
        return BrickBlockOp(jnp.asarray(blocks, dtype), doffs,
                            (BX, BY, BZ), bs, rects=tuple(rects))


def _sym_keep(doffs):
    """Indices of the lexicographically non-negative brick offsets.

    The coarse Galerkin operator is symmetric, so the block of offset
    -d is the slot-transpose of the block of +d shifted by d:
    B_{-d}[s2, s1, p + d] = B_{+d}[s1, s2, p].  Streaming only the kept
    half and applying each block both ways halves the block stream.

    Raises on any ONE-SIDED nonzero offset: a dropped negative offset
    with no kept mirror would lose that coupling silently, and a kept
    positive offset with no stored mirror would fabricate one."""
    have = {tuple(d) for d in doffs}
    for td in have:
        if td != (0, 0, 0) and (-td[0], -td[1], -td[2]) not in have:
            raise ValueError(
                "one-sided brick offset %s has no mirror: the operator "
                "is not offset-symmetric and symmetry halving would "
                "silently mis-apply this coupling" % (td,))
    return tuple(i for i, d in enumerate(doffs)
                 if tuple(d) >= (0, 0, 0))


def extract_boxes(r3: jnp.ndarray, brick_elems, bricks) -> jnp.ndarray:
    """Node grid -> (box, NB) overlapping closed-brick windows
    p[(dx,dy,dz), (i,j,k)] = r3[bx*i+dx, by*j+dy, bz*k+dz].

    Axis-by-axis overlap decomposition instead of
    conv_general_dilated_patches: the dx<b rows come from the plain
    non-overlapping reshape and the dx=b row is the next brick's first
    plane (one strided slice) — 3 reshape+concat passes of pure strided
    copies.  Requires r3.shape[d] == bricks[d]*brick_elems[d] + 1."""
    def expand(x, axis, b, nb):
        main = jax.lax.slice_in_dim(x, 0, nb * b, axis=axis)
        main = main.reshape(x.shape[:axis] + (nb, b)
                            + x.shape[axis + 1:])
        extra = jax.lax.slice_in_dim(x, b, nb * b + 1, stride=b,
                                     axis=axis)
        extra = extra.reshape(x.shape[:axis] + (nb, 1)
                              + x.shape[axis + 1:])
        return jnp.concatenate([main, extra], axis=axis + 1)

    (BX, BY, BZ) = bricks
    (bx, by, bz) = brick_elems
    X = expand(r3, 0, bx, BX)          # (BX, bx+1, NYn, NZn)
    X = expand(X, 2, by, BY)           # (BX, bx+1, BY, by+1, NZn)
    X = expand(X, 4, bz, BZ)
    box = (bx + 1) * (by + 1) * (bz + 1)
    return X.transpose(1, 3, 5, 0, 2, 4).reshape(box, -1)


def assemble_P_pieces(C: jnp.ndarray, brick_elems, bricks,
                      nodes) -> jnp.ndarray:
    """(box, NB) per-brick prolongation values -> node grid: 8-piece
    static-slice overlap assembly (pieces are disjoint because dof plane
    g = k*b belongs to brick k-1 — the master/minimum rule)."""
    (BX, BY, BZ) = bricks
    (bx, by, bz) = brick_elems
    C = C.reshape(bx + 1, by + 1, bz + 1, BX, BY, BZ) \
        .transpose(3, 4, 5, 0, 1, 2)
    y3 = jnp.zeros(nodes, dtype=jnp.float32)

    def interleave(piece, dims):
        # piece (B_d..., b_d...) -> transpose to (B,b) pairs, flatten
        nd = len(dims)
        permute = []
        for d in range(nd):
            permute += [d, nd + d]
        out = piece.transpose(permute)
        return out.reshape([piece.shape[d] * piece.shape[nd + d]
                            for d in range(nd)])

    # S = set of dims pinned at global plane 0
    y3 = y3.at[1:, 1:, 1:].set(
        interleave(C[:, :, :, 1:, 1:, 1:], (0, 1, 2)))
    y3 = y3.at[0, 1:, 1:].set(
        interleave(C[0, :, :, 0, 1:, 1:], (0, 1)))
    y3 = y3.at[1:, 0, 1:].set(
        interleave(C[:, 0, :, 1:, 0, 1:], (0, 1)))
    y3 = y3.at[1:, 1:, 0].set(
        interleave(C[:, :, 0, 1:, 1:, 0], (0, 1)))
    y3 = y3.at[0, 0, 1:].set(interleave(C[0, 0, :, 0, 0, 1:], (0,)))
    y3 = y3.at[0, 1:, 0].set(interleave(C[0, :, 0, 0, 1:, 0], (0,)))
    y3 = y3.at[1:, 0, 0].set(interleave(C[:, 0, 0, 1:, 0, 0], (0,)))
    y3 = y3.at[0, 0, 0].set(C[0, 0, 0, 0, 0, 0])
    return y3


# ---------------------------------------------------------------------------
# device-side structured hierarchy


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StructuredHierarchy:
    """3-level (or 2-level) gather-free hierarchy.

    Level 0: haloed stencil passes, optionally in the Z-LANE layout
    (``nzp`` > 0): dof (ix, iy, iz) lives at (ix*NYn + iy)*nzp + iz with
    nzp = NZn rounded up to 128, so an x-plane is a whole number of
    128-wide rows.  That is what the SHARDED path
    (parallel/structured_sharded.py) needs: its halo exchange is then a
    static row-slice ppermute.  Single-device, zlane streams nzp/NZn
    more padded diagonal bytes than the flat layout.

    Level 1 (optional): BrickBlockOp on the SLOT-MAJOR padded coarse
    layout (flat id = slot*NB + brick), or a dense (n_c, n_c) operator
    on the unpadded coarse dofs bridged via ``flat_id``.  Coarsest:
    dense inverse matvec."""

    A0: StencilDIA
    dinv0h: jnp.ndarray
    taus0: tuple                  # (1,) f32 device scalars (1/tau)
    Rst: jnp.ndarray              # (bs, box, NB) — slot-major SoA
    # level 1 (None for two-level).
    A1d: Optional[object]
    dinv1: Optional[jnp.ndarray]  # (n_c,) or (n_flat,) f32
    taus1: Optional[tuple]
    R1: Optional[jnp.ndarray]     # (n2, n_c) or (n2, n_flat) dense restr
    Ainv: jnp.ndarray             # dense inverse of the coarsest operator
    geo: BrickGeometry            # static
    n_fine: int                   # static
    n_flat: int                   # static (NB * bs)
    # real (non-padding) slot ids: padded layout <-> unpadded coarse dofs
    flat_id: Optional[jnp.ndarray] = None
    nzp: int = 0                  # static; 0 = flat layout
    # optional bf16-valued twin of A0 (same halo layout) used by the
    # smoother and residual passes INSIDE the preconditioner; matvec0
    # (the PCG operator) always applies the f32 A0
    A0s: Optional[StencilDIA] = None
    # structured coarsest restriction (replaces the dense R1): per-
    # superbrick tent blocks (bs2, win, NB2), the superbrick grid, and
    # the padded->real level-2 dof bridge (build_structured_interp2)
    Rst1: Optional[jnp.ndarray] = None
    supers: Optional[tuple] = None          # static (SX, SY, SZ)
    flat_id2: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        return ((self.A0, self.dinv0h, self.taus0, self.Rst, self.A1d,
                 self.dinv1, self.taus1, self.R1, self.Ainv,
                 self.flat_id, self.A0s, self.Rst1, self.flat_id2),
                (self.geo, self.n_fine, self.n_flat, self.nzp,
                 self.supers))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:9], aux[0], aux[1], aux[2],
                   flat_id=children[9], nzp=aux[3], A0s=children[10],
                   Rst1=children[11], supers=aux[4],
                   flat_id2=children[12])

    # -- fine-level layout plumbing --------------------------------------
    def _to_zlane(self, x):
        NXn, NYn, NZn = self.geo.nodes
        x3 = x.reshape(NXn, NYn, NZn)
        return jnp.pad(x3, ((0, 0), (0, 0), (0, self.nzp - NZn))) \
            .reshape(-1)

    def _from_zlane3(self, xz):
        """z-lane flat -> (NXn, NYn, NZn) grid."""
        NXn, NYn, NZn = self.geo.nodes
        return xz.reshape(NXn, NYn, self.nzp)[:, :, :NZn]

    def pad0(self, x):
        """original flat (n,) -> haloed layout."""
        return self.A0.pad(self._to_zlane(x) if self.nzp else x)

    def unpad0(self, xh, dtype=jnp.float32):
        """haloed layout -> original flat (n,)."""
        if not self.nzp:
            return self.A0.unpad(xh, dtype)
        return self._from_zlane3(self.A0.unpad(xh, dtype)) \
            .reshape(-1)

    def matvec0(self, x):
        """y = A x on original-layout flat vectors (the PCG operator)."""
        return self.unpad0(self.A0.matvec_h(self.pad0(x)), x.dtype)

    # -- structured tentative P/R apply ---------------------------------
    def apply_R(self, res_flat: jnp.ndarray) -> jnp.ndarray:
        """coarse = R res: strided window extraction + slot-major
        multiply-reduce; output in the slot-major padded layout."""
        r3 = res_flat.reshape(self.geo.nodes)
        boxes = extract_boxes(r3, self.geo.brick_elems,
                              self.geo.bricks)    # (box, NB)
        yc = jnp.sum(self.Rst * boxes[None], axis=1)   # (bs, NB)
        return yc.reshape(-1)

    def apply_P(self, xc_flat: jnp.ndarray) -> jnp.ndarray:
        """fine = P xc: slot-major multiply-reduce + static-slice
        overlap assembly."""
        xc = xc_flat.reshape(self.bs, -1)              # (bs, NB)
        C = jnp.sum(self.Rst * xc[:, None, :], axis=0)  # (box, NB)
        return assemble_P_pieces(C, self.geo.brick_elems, self.geo.bricks,
                                 self.geo.nodes).reshape(-1)

    @property
    def bs(self) -> int:
        return self.Rst.shape[0]

    # -- structured coarsest R1/P1 (block-diagonal over superbricks) ----
    def apply_R1(self, rc_flat: jnp.ndarray) -> jnp.ndarray:
        return mid_apply_R1(self, rc_flat)

    def apply_P1(self, y2: jnp.ndarray) -> jnp.ndarray:
        return mid_apply_P1(self, y2)

    def _coarsest_correct(self, r1: jnp.ndarray) -> jnp.ndarray:
        return mid_coarsest_correct(self, r1)

    # -- cycle ----------------------------------------------------------
    def _mid_matvec(self, x):
        return mid_matvec(self, x)

    def vcycle(self, b: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """tg_cycle_atb (tg.cpp:91) on the structured formats."""
        A0 = self.A0s if self.A0s is not None else self.A0
        bh, xh = self.pad0(b), self.pad0(x)
        for it in self.taus0:
            xh = A0.root_h(it, bh, self.dinv0h, xh)
        rc = self.apply_R(self.unpad0(A0.residual_h(bh, xh)))
        if self.A1d is not None:
            xc = mid_correct(self, rc)
        else:
            yc = jnp.dot(self.Ainv, rc[self.flat_id], precision=HI)
            xc = jnp.zeros_like(rc).at[self.flat_id].set(yc)
        xh = xh + self.pad0(self.apply_P(xc))
        for it in self.taus0:
            xh = A0.root_h(it, bh, self.dinv0h, xh)
        return self.unpad0(xh)


# ---------------------------------------------------------------------------
# mid-level + coarsest correction.  Every function takes the hierarchy
# ``m`` and reads only its mid/coarsest fields.


def _mid_super_dims(m):
    (BX, BY, BZ), (SX, SY, SZ) = m.geo.bricks, m.supers
    return (SX, SY, SZ), (BX // SX, BY // SY, BZ // SZ)


def mid_apply_R1(m, rc_flat: jnp.ndarray) -> jnp.ndarray:
    """level-2 restriction on the slot-major padded level-1 vector:
    regroup bricks by superbrick (a small reshape/transpose) + one
    batched contraction of the block-diagonal tent blocks."""
    (SX, SY, SZ), (sx, sy, sz) = _mid_super_dims(m)
    bs = m.bs
    W = rc_flat.reshape(bs, SX, sx, SY, sy, SZ, sz) \
        .transpose(0, 2, 4, 6, 1, 3, 5) \
        .reshape(bs * sx * sy * sz, SX * SY * SZ)
    return jnp.sum(m.Rst1.astype(jnp.float32)
                   * W[None].astype(jnp.float32), axis=1)  # (bs2,NB2)


def mid_apply_P1(m, y2: jnp.ndarray) -> jnp.ndarray:
    """adjoint of mid_apply_R1: (bs2, NB2) -> slot-major (n_flat,)."""
    (SX, SY, SZ), (sx, sy, sz) = _mid_super_dims(m)
    bs = m.bs
    W = jnp.sum(m.Rst1.astype(jnp.float32)
                * y2[:, None, :].astype(jnp.float32), axis=0)
    return W.reshape(bs, sx, sy, sz, SX, SY, SZ) \
        .transpose(0, 4, 1, 5, 2, 6, 3) \
        .reshape(-1)


def mid_coarsest_correct(m, r1: jnp.ndarray) -> jnp.ndarray:
    """x1 += P1 Ainv R1 r1 term of the cycle on the padded mid
    layout; dense-R1 or structured per what compile built."""
    if m.Rst1 is not None:
        rc2 = mid_apply_R1(m, r1).reshape(-1)
        y2 = jnp.dot(m.Ainv, rc2[m.flat_id2], precision=HI)
        y2p = jnp.zeros_like(rc2).at[m.flat_id2].set(y2)
        nb2 = m.Rst1.shape[2]
        return mid_apply_P1(m, y2p.reshape(-1, nb2))
    # a bf16 R1 is upcast (exactly) to f32 before the product
    R1 = m.R1.astype(jnp.float32)
    y2 = jnp.dot(m.Ainv, jnp.dot(R1, r1, precision=HI), precision=HI)
    return jnp.dot(R1.T, y2, precision=HI)


def mid_matvec(m, x):
    if isinstance(m.A1d, BrickBlockOp):
        return m.A1d.matvec(x)
    return jnp.dot(m.A1d, x.astype(m.A1d.dtype), precision=HI,
                   preferred_element_type=jnp.float32)


def poly_chain(matvec, taus, dinv, b, x):
    """The smpr root chain (smpr_compute_poly, smpr.hpp:319-339):
    x += dinv (b - A x) / tau for each root, in order."""
    for it in taus:
        x = x + dinv * (b - matvec(x)) * it[0]
    return x


def mid_correct(m, rc: jnp.ndarray) -> jnp.ndarray:
    """The whole coarse correction from the restricted residual ``rc``
    (slot-major padded layout): pre mid-chain, coarsest correction,
    post mid-chain (tg_cycle_atb's recursive coarse solve, tg.cpp:126,
    at the mid level)."""
    padded_mid = isinstance(m.A1d, BrickBlockOp)
    b1 = rc if padded_mid else rc[m.flat_id]
    mv = partial(mid_matvec, m)
    x1 = poly_chain(mv, m.taus1, m.dinv1, b1, jnp.zeros_like(b1))
    x1 = x1 + mid_coarsest_correct(m, b1 - mv(x1))
    x1 = poly_chain(mv, m.taus1, m.dinv1, b1, x1)
    return x1 if padded_mid \
        else jnp.zeros_like(rc).at[m.flat_id].set(x1)


@jax.jit
def struct_vcycle_apply(h: StructuredHierarchy, b: jnp.ndarray):
    return h.vcycle(b, jnp.zeros_like(b))


def struct_pcg_solve(h: StructuredHierarchy, b: jnp.ndarray,
                     rel_tol: float = 1e-6, abs_tol: float = 0.0,
                     max_iter: int = 200):
    """MFEM-CGSolver-semantics PCG on the structured hierarchy; the
    tolerances become device scalars (no retrace per tolerance)."""
    return _struct_pcg(h, b, jnp.asarray(rel_tol, b.dtype),
                       jnp.asarray(abs_tol, b.dtype), max_iter)


@partial(jax.jit, static_argnames=("max_iter",))
def _struct_pcg(h: StructuredHierarchy, b: jnp.ndarray,
                rel_tol, abs_tol, max_iter: int):
    dot = partial(jnp.dot, precision=HI)
    z = h.vcycle(b, jnp.zeros_like(b))
    nom0 = dot(z, b)
    lim = jnp.maximum(nom0 * rel_tol * rel_tol, abs_tol * abs_tol)
    Ad0 = h.matvec0(z)

    def cond(state):
        x, r, d, Ad, nom, it = state
        return jnp.logical_and(nom > lim, it < max_iter)

    def body(state):
        x, r, d, Ad, nom, it = state
        alpha = nom / dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = h.vcycle(r, jnp.zeros_like(r))
        betanom = dot(r, z)
        d = z + (betanom / nom) * d
        return (x, r, d, h.matvec0(d), betanom, it + 1)

    state = (jnp.zeros_like(b), b, z, Ad0, nom0, jnp.int32(0))
    x, r, d, Ad, nom, it = jax.lax.while_loop(cond, body, state)
    return x, it, nom


# ---------------------------------------------------------------------------
# compiler: host MLData -> StructuredHierarchy


def _zlane_csr(A: sp.csr_matrix, nodes, nzp: int) -> sp.csr_matrix:
    """Permute a stencil operator into the z-lane numbering
    (ix, iy, iz) -> (ix*NYn + iy)*nzp + iz (empty pad rows)."""
    NXn, NYn, NZn = nodes
    old = np.arange(A.shape[0])
    iz = old % NZn
    iy = (old // NZn) % NYn
    ix = old // (NZn * NYn)
    newid = (ix * NYn + iy) * nzp + iz
    coo = A.tocoo()
    n_new = NXn * NYn * nzp
    return sp.coo_matrix(
        (coo.data, (newid[coo.row], newid[coo.col])),
        shape=(n_new, n_new)).tocsr()


def compile_structured(ml, geo: BrickGeometry,
                       mid_dtype=jnp.float32,
                       mid_format: str = "brickblock",
                       fine_layout: str = "flat",
                       smoother_dtype=None,
                       rp_dtype=jnp.float32,
                       super_bricks: Optional[Tuple[int, int, int]] = None,
                       backend: Optional[str] = None,
                       ) -> StructuredHierarchy:
    """Build the structured device hierarchy from a host setup product.

    ``ml`` must come from a brick partitioning (partition_cartesian_3d)
    with an unsmoothed tentative P on the finest coarsening; supports 2
    or 3 host levels (3rd-level partitioning may be unstructured — its
    operator only appears through the dense R1/coarsest inverse).

    ``mid_dtype``: storage dtype of the mid-level operator.
    jnp.bfloat16 halves its matvec traffic; the smoother then relaxes a
    ~1e-2-perturbed operator, which only perturbs preconditioner quality
    (the reference's coarse solve is itself one approximate BoomerAMG
    V-cycle, tg.hpp:724-730).

    ``mid_format``: 'brickblock' (default — per-brick-offset dense
    blocks in the slot-major padded layout, ~n_c^2/(27*NB*bs^2)x less
    traffic than dense) or 'dense'.

    ``fine_layout``: 'flat' (default) or 'zlane' (x-planes are whole
    128-wide rows, see StructuredHierarchy — REQUIRED by the sharded
    path).

    ``smoother_dtype``: when set (jnp.bfloat16), the smoother and
    residual passes inside the preconditioner stream a bf16-valued twin
    of the fine operator (halving the dominant diagonal traffic);
    matvec0 — the PCG operator — keeps the f32 values.

    ``rp_dtype``: storage dtype of the structured tent blocks Rst
    (P and R share the array, so the preconditioner stays symmetric).

    ``super_bricks``: (SX, SY, SZ) superbrick grid of the 3rd-level
    partitioning (topology.part.partition_cartesian_bricks passed as
    ``coarse_part_override(1)`` at setup).  Replaces the dense
    coarsest restriction with the block-diagonal per-superbrick tent
    blocks (build_structured_interp2): the dense R1 grows as n2 * n1,
    the blocks as n1.  Requires mid_format='brickblock' and an
    unsmoothed P1.

    ``backend``: fine-level stencil pass implementation (ops/stencil.py;
    None = stencil_backend())."""
    lv0 = ml.levels[0]
    tg0 = lv0.tg_data
    assert not tg0.smooth_interp, "structured path needs the tent P"

    dinv_np = np.asarray(tg0.poly_data.dinv, np.float64)
    if fine_layout == "zlane":
        NXn, NYn, NZn = geo.nodes
        nzp = -(-NZn // 128) * 128
        A0csr = _zlane_csr(lv0.A, geo.nodes, nzp)
        dz = np.zeros(NXn * NYn * nzp)
        dz.reshape(NXn, NYn, nzp)[:, :, :NZn] = \
            dinv_np.reshape(NXn, NYn, NZn)
        dinv_np = dz
    else:
        nzp = 0
        A0csr = lv0.A
    dia0 = DeviceDIA.try_from_csr(A0csr, jnp.float32, max_diags=64)
    assert dia0 is not None, "finest operator is not stencil-structured"
    A0 = StencilDIA.from_dia(dia0, backend=backend)
    del dia0
    A0s = None
    if smoother_dtype is not None and smoother_dtype != jnp.float32:
        A0s = A0.astype(smoother_dtype)
    dinv0h = A0.pad(jnp.asarray(dinv_np, jnp.float32))
    pd0 = tg0.poly_data
    assert pd0.roots2 is None or len(pd0.roots2) == 0, \
        "structured path implements single-chain root families only " \
        "(use the compiled/sharded paths for invx)"
    taus0 = inv_tau_arrays(pd0.roots)

    Rst_bm, cd_brick, slot, bs = build_structured_interp(
        lv0.rels, tg0.tent_interp, tg0.interp_data.mis_numcoarsedof, geo)
    # slot-major SoA: (NB, bs, box) -> (bs, box, NB)
    Rst = jnp.asarray(np.ascontiguousarray(Rst_bm.transpose(1, 2, 0)),
                      rp_dtype)
    NB = geo.num_bricks
    n_flat = NB * bs
    flat_id = jnp.asarray(slot * NB + cd_brick, jnp.int32)
    common = dict(geo=geo, n_fine=lv0.A.shape[0], n_flat=n_flat,
                  flat_id=flat_id, nzp=nzp, A0s=A0s)

    Ac1 = tg0.Ac.tocsr()
    if len(ml.levels) < 2:
        # two-level: coarsest inverse stored UNPADDED (n_c x n_c)
        return StructuredHierarchy(
            A0, dinv0h, taus0, Rst, None, None, None, None,
            _device_spd_inverse(np.asarray(Ac1.todense())), **common)

    tg1 = ml.levels[1].tg_data
    pd1 = tg1.poly_data
    dinv1_np = np.asarray(pd1.dinv, np.float64)
    n2 = tg1.restr.shape[0]
    R1 = Rst1_dev = flat_id2 = None
    if mid_format == "brickblock":
        A1d = BrickBlockOp.from_csr(Ac1, cd_brick, slot, bs,
                                    geo.bricks, mid_dtype)
        # Galerkin => symmetric: halve the streaming-rect matvec's
        # block reads (no effect below RECT_MIN_BYTES or on the
        # sharded path, which shards the full blocks itself)
        A1d = dataclasses.replace(A1d, sym_stream=True)
        # padded-layout companions (padding slots: dinv 0 so the
        # smoother leaves them untouched; R1 columns 0)
        dinv1p = np.zeros(n_flat)
        dinv1p[np.asarray(flat_id)] = dinv1_np
        dinv1 = jnp.asarray(dinv1p, jnp.float32)
        if super_bricks is not None:
            assert not tg1.smooth_interp, \
                "structured coarsest restriction needs the tent P1"
            Rst1_np, cd2_brick, slot2, bs2 = build_structured_interp2(
                ml.levels[1].rels, tg1.tent_interp,
                tg1.interp_data.mis_numcoarsedof, geo, super_bricks,
                cd_brick, slot, bs)
            NB2 = int(np.prod(super_bricks))
            Rst1_dev = jnp.asarray(Rst1_np, rp_dtype)
            flat_id2 = jnp.asarray(slot2 * NB2 + cd2_brick, jnp.int32)
        else:
            R1p = np.zeros((n2, n_flat))
            R1p[:, np.asarray(flat_id)] = np.asarray(
                tg1.restr.todense(), dtype=np.float64)
            # rp_dtype (bf16 in the bench config) halves the dense
            # coarsest-restriction stream; applies upcast to f32
            R1 = jnp.asarray(R1p, rp_dtype)
    else:
        A1d = jnp.asarray(np.asarray(Ac1.todense()), mid_dtype)
        dinv1 = jnp.asarray(dinv1_np, jnp.float32)
        R1 = jnp.asarray(np.asarray(tg1.restr.todense(),
                                    dtype=np.float64), rp_dtype)
    taus1 = inv_tau_arrays(pd1.roots)
    Ainv = _device_spd_inverse(np.asarray(tg1.Ac.todense(),
                                          dtype=np.float64))
    return StructuredHierarchy(
        A0, dinv0h, taus0, Rst, A1d, dinv1, taus1, R1, Ainv,
        Rst1=Rst1_dev, supers=super_bricks, flat_id2=flat_id2, **common)


def _device_spd_inverse(Ac: np.ndarray) -> jnp.ndarray:
    """Explicit SPD inverse, computed on device (Cholesky + triangular
    solves against I).  At coarse sizes (5-20k) a host LAPACK inverse
    takes minutes on few cores; the device factorize-and-solve is
    seconds, and the inverse is consumed on device anyway.  f32 accuracy
    only perturbs the coarse solve of a preconditioner (exactness is not
    required — the reference's default coarse solve is ONE BoomerAMG
    V-cycle, tg.hpp:724-730)."""
    n = Ac.shape[0]
    if n <= 4096:
        return jnp.asarray(np.linalg.inv(Ac), jnp.float32)
    with jax.default_matmul_precision("highest"):
        A_dev = jnp.asarray(Ac, jnp.float32)
        C = jax.scipy.linalg.cho_factor(A_dev, lower=True)
        del A_dev
        # solve against I in column chunks: one full-width cho_solve
        # materializes O(n^2)-sized temps per block step
        cols = []
        step = 2048
        eye = np.eye(n, dtype=np.float32)
        for j in range(0, n, step):
            cols.append(jax.scipy.linalg.cho_solve(
                C, jnp.asarray(eye[:, j:j + step])))
        out = jnp.concatenate(cols, axis=1)
    del C, cols
    return out
