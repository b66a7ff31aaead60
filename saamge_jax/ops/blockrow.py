"""Block-row device format for coarse Galerkin operators.

Coarse dofs are numbered MIS-contiguously (mis_coarsedofoffsets,
aggregates.cpp:1693-1702), and Ac's sparsity couples whole MIS blocks
(two MISes interact iff they share an agglomerate), so Ac is naturally a
block matrix with DENSE row blocks: all rows of one MIS share one column
set.  Storing each MIS row-block densely over its column union turns the
SpMV into

    x_g   = take(x, col_union_g)          (one small gather per block row)
    y_g   = Block_g @ x_g                 (batched dense)

with the gather volume divided by the block height versus ELL (every row
of the block reuses the same gathered columns).  Blocks are bucketed by
padded (rows, cols) to keep a handful of static shapes.

This is the device replacement for hypre ParCSR storage of the coarse
operators (SURVEY §2.3, §7: "blocked formats with precomputed sparsity").
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

HI = jax.lax.Precision.HIGHEST

def _pow2_at_least(x: int, lo: int) -> int:
    m = lo
    while m < x:
        m *= 2
    return m


def _quantize(x: int, lo: int, step: int = 4) -> int:
    """Pad to the next power of `step`: coarser classes mean fewer buckets
    — each bucket is a separate gather+einsum op and small ops pay a fixed
    per-op latency, so fewer-but-fuller buckets win."""
    m = lo
    while m < x:
        m *= step
    return m


@dataclasses.dataclass
class _Bucket:
    blocks: jnp.ndarray      # (B, r, c)
    colidx: jnp.ndarray      # (B, c) int32; padding points at n (zero slot)
    row0: jnp.ndarray        # (B,) int32 first row of each block
    r: int
    c: int


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceBlockRow:
    buckets: List[_Bucket]
    gather_rows: jnp.ndarray   # (n,) int32: flat position of row i's value
    shape: tuple

    def tree_flatten(self):
        leaves = []
        aux = []
        for b in self.buckets:
            leaves.extend([b.blocks, b.colidx, b.row0])
            aux.append((b.r, b.c))
        leaves.append(self.gather_rows)
        return leaves, (aux, self.shape)

    @classmethod
    def tree_unflatten(cls, aux_data, leaves):
        aux, shape = aux_data
        buckets = []
        for i, (r, c) in enumerate(aux):
            buckets.append(_Bucket(leaves[3 * i], leaves[3 * i + 1],
                                   leaves[3 * i + 2], r, c))
        return cls(buckets, leaves[-1], shape)

    @staticmethod
    def from_csr(A: sp.spmatrix, group_offsets: np.ndarray,
                 dtype=jnp.float32) -> "DeviceBlockRow":
        """group_offsets: (G+1,) row-group boundaries (rows of one group
        are contiguous and share their column set by construction)."""
        A = A.tocsr()
        n, m = A.shape
        assert group_offsets[0] == 0 and group_offsets[-1] == n
        G = len(group_offsets) - 1
        raw = []          # (rows0, nrows, cols array, dense block)
        for g in range(G):
            r0, r1 = int(group_offsets[g]), int(group_offsets[g + 1])
            if r1 == r0:
                continue
            sub = A[r0:r1]
            cols = np.unique(sub.indices)
            dense = np.asarray(sub[:, cols].todense())
            raw.append((r0, r1 - r0, cols, dense))

        # bucket by padded (rows, cols)
        # padding classes: rows to multiples of 8, columns to multiples
        # of 16 (fill volume dominates; per-bucket op latency is
        # secondary)
        groups = {}
        for r0, nr, cols, dense in raw:
            key = (-(-nr // 8) * 8, -(-max(len(cols), 1) // 16) * 16)
            groups.setdefault(key, []).append((r0, nr, cols, dense))

        buckets = []
        flat_pos = np.zeros(n, dtype=np.int64)
        flat_base = 0
        for (rpad, cpad), items in sorted(groups.items()):
            B = len(items)
            blocks = np.zeros((B, rpad, cpad))
            colidx = np.full((B, cpad), m, dtype=np.int32)  # zero slot
            row0 = np.zeros(B, dtype=np.int32)
            for k, (r0, nr, cols, dense) in enumerate(items):
                blocks[k, :nr, :len(cols)] = dense
                colidx[k, :len(cols)] = cols
                row0[k] = r0
                flat_pos[r0:r0 + nr] = flat_base + k * rpad + np.arange(nr)
            flat_base += B * rpad
            buckets.append(_Bucket(
                jnp.asarray(blocks, dtype=dtype), jnp.asarray(colidx),
                jnp.asarray(row0), rpad, cpad))
        return DeviceBlockRow(buckets, jnp.asarray(flat_pos, dtype=np.int32),
                              (n, m))

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        xp = jnp.concatenate([x, jnp.zeros(1, dtype=x.dtype)])
        parts = []
        for b in self.buckets:
            xg = jnp.take(xp, b.colidx, axis=0)          # (B, c)
            yg = jnp.einsum("brc,bc->br", b.blocks, xg,
                            precision=HI)               # (B, r)
            parts.append(yg.reshape(-1))
        flat = jnp.concatenate(parts)
        return jnp.take(flat, self.gather_rows, axis=0)

    def rmatvec(self, y: jnp.ndarray) -> jnp.ndarray:
        """x = A^T y using the same block storage: per block, gather the
        (contiguous) rows of y, contract with the transposed block, and
        scatter-add into the column positions.  With MIS-blocked tentative
        restrictions this is the prolongator application (column sets
        partition the fine dofs, so the scatter has unique indices)."""
        n, m = self.shape
        out = jnp.zeros(m + 1, dtype=y.dtype)            # + zero slot
        yp = jnp.concatenate([y, jnp.zeros(1, dtype=y.dtype)])
        for b in self.buckets:
            ridx = b.row0[:, None] + jnp.arange(b.r)[None, :]
            ridx = jnp.where(ridx < n, ridx, n)          # pad rows -> 0
            yg = jnp.take(yp, ridx, axis=0)              # (B, r)
            xg = jnp.einsum("brc,br->bc", b.blocks, yg,
                            precision=HI)               # (B, c)
            out = out.at[b.colidx.reshape(-1)].add(xg.reshape(-1))
        return out[:m]

    def nbytes(self) -> int:
        return sum(int(b.blocks.size) * 4 + int(b.colidx.size) * 4
                   for b in self.buckets)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class TransposedBlockRow:
    """A^T view sharing the block storage (prolongator = restriction^T)."""

    base: DeviceBlockRow

    def tree_flatten(self):
        return (self.base,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    @property
    def shape(self):
        n, m = self.base.shape
        return (m, n)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.base.rmatvec(x)
