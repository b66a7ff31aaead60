"""Device sparse-matrix formats for the solve phase.

Replaces hypre ParCSR (the reference's global operator container) with
static-shape formats XLA compiles into fused device loops:

  - ELL: rows padded to a common nnz/row; SpMV = k gathers + fma.  General
    fallback for any operator (A, P, R, Ac).
  - DIA: diagonal storage for stencil-structured operators (3D Poisson on
    structured hexes has 27 distinct column offsets); SpMV = k contiguous
    shifted reads — no gather at all.

Products that may lower to matrix units ask for HIGHEST precision (a
float32 product may otherwise run in TF32 on the GPU).

Conversion happens once on host after setup; the jitted V-cycle only ever
sees fixed-shape jnp arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

HI = jax.lax.Precision.HIGHEST

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceELL:
    """Padded ELLPACK: cols (n, k) int32, vals (n, k).  Padding entries
    point at column 0 with value 0."""

    cols: jnp.ndarray
    vals: jnp.ndarray
    shape: tuple

    def tree_flatten(self):
        return (self.cols, self.vals), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)

    @staticmethod
    def from_csr(A: sp.csr_matrix, dtype=jnp.float32,
                 pad_to_multiple: int = 1) -> "DeviceELL":
        A = A.tocsr()
        A.sum_duplicates()
        n, m = A.shape
        row_nnz = np.diff(A.indptr)
        k = int(row_nnz.max()) if n else 0
        k = max(k, 1)
        if pad_to_multiple > 1:
            k = ((k + pad_to_multiple - 1) // pad_to_multiple) \
                * pad_to_multiple
        cols = np.zeros((n, k), dtype=np.int32)
        vals = np.zeros((n, k), dtype=np.float64)
        rows = np.repeat(np.arange(n), row_nnz)
        pos = np.arange(len(A.data)) - np.repeat(A.indptr[:-1], row_nnz)
        cols[rows, pos] = A.indices
        vals[rows, pos] = A.data
        return DeviceELL(jnp.asarray(cols), jnp.asarray(vals, dtype=dtype),
                         (n, m))

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return ell_spmv(self, x)


def ell_spmv(A: DeviceELL, x: jnp.ndarray) -> jnp.ndarray:
    """y_i = sum_k vals[i,k] * x[cols[i,k]]."""
    return jnp.einsum("nk,nk->n", A.vals, jnp.take(x, A.cols, axis=0,
                                                   indices_are_sorted=False),
                      precision=HI)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceDIA:
    """Diagonal (stencil) storage: offsets (k,) static, vals (k, n).

    SpMV reads x at n contiguous positions per diagonal — gather-free."""

    vals: jnp.ndarray        # (k, n)
    offsets: tuple           # static python ints
    shape: tuple

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @staticmethod
    def try_from_csr(A: sp.csr_matrix, dtype=jnp.float32,
                     max_diags: int = 40) -> Optional["DeviceDIA"]:
        """Returns None if A has too many distinct diagonals."""
        n, m = A.shape
        if n != m or n == 0:
            return None
        A = A.tocsr()
        A.sum_duplicates()
        coo = A.tocoo()
        d = coo.col - coo.row
        offs = np.unique(d)
        if len(offs) > max_diags:
            return None
        # row-aligned storage built directly: out[k, i] = A[i, i + off]
        # (scipy's todia mis-sizes its data array on matrices with empty
        # trailing rows, e.g. the z-lane-padded stencil numbering)
        kidx = np.searchsorted(offs, d)
        row_vals = np.zeros((len(offs), n))
        row_vals[kidx, coo.row] = coo.data
        offsets = tuple(int(o) for o in offs)
        return DeviceDIA(jnp.asarray(row_vals, dtype=dtype), offsets, (n, m))

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return dia_spmv(self, x)


def dia_spmv(A: DeviceDIA, x: jnp.ndarray) -> jnp.ndarray:
    n = A.shape[0]
    maxoff = max(max(abs(o) for o in A.offsets), 1)
    xp = jnp.pad(x, (maxoff, maxoff))
    y = jnp.zeros_like(x)
    for k, off in enumerate(A.offsets):
        xs = jax.lax.dynamic_slice(xp, (maxoff + off,), (n,))
        y = y + A.vals[k] * xs
    return y


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceBanded:
    """Dense band storage applied with strided window patches — the
    gather-free format for unstructured square operators after an RCM
    reordering (coarse Galerkin operators, algebraic-mode matrices).

    Rows are processed in groups of G=8; row i reads x[i-lo : i+hi+1], so a
    row group reads the contiguous window x[g*G-lo : g*G+G-1+hi+1].  The
    windows are materialized with lax.conv_general_dilated_patches (strided
    copies, no gather) and contracted against the (RG, G, W) band blocks on
    the vector units.  It trades gathers for streamed band fill, which
    pays while the fill stays within a small multiple of the nnz."""

    blocks: jnp.ndarray     # (RG, G, W) band values
    lo: int                 # left bandwidth
    shape: tuple

    G = 8

    def tree_flatten(self):
        return (self.blocks,), (self.lo, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    @staticmethod
    def try_from_csr(A: sp.csr_matrix, dtype=jnp.float32,
                     max_fill: float = 8.0) -> Optional["DeviceBanded"]:
        A = A.tocsr()
        n, m = A.shape
        if n != m or n == 0:
            return None
        coo = A.tocoo()
        d = coo.col - coo.row
        lo, hi = int(-d.min()) if len(d) else 0, int(d.max()) if len(d) else 0
        G = DeviceBanded.G
        W = lo + hi + G
        RG = -(-n // G)
        fill = RG * G * W / max(A.nnz, 1)
        if fill > max_fill:
            return None
        blocks = np.zeros((RG, G, W), dtype=np.float64)
        g = coo.row // G
        r = coo.row - g * G
        # column offset inside the window starting at g*G - lo
        w = coo.col - (g * G - lo)
        blocks[g, r, w] = coo.data
        return DeviceBanded(jnp.asarray(blocks, dtype=dtype), lo, (n, m))

    @property
    def fill(self) -> float:
        return float(self.blocks.size)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return banded_spmv(self, x)


def banded_spmv(A: DeviceBanded, x: jnp.ndarray) -> jnp.ndarray:
    n = A.shape[0]
    RG, G, W = A.blocks.shape
    lo = A.lo
    # pad so every window is in range: window g covers
    # [g*G - lo, g*G - lo + W)
    xp = jnp.zeros(lo + RG * G + (W - lo - G), dtype=x.dtype)
    xp = xp.at[lo:lo + n].set(x)
    # patches[g, :] = xp[g*G : g*G + W]  (strided copy, gather-free)
    patches = jax.lax.conv_general_dilated_patches(
        xp[None, None, :], filter_shape=(W,), window_strides=(G,),
        padding="VALID")[0].T                  # (RG, W)
    y = jnp.einsum("giw,gw->gi", A.blocks, patches, precision=HI)
    return y.reshape(-1)[:n]


DeviceMatrix = Union[DeviceELL, DeviceDIA, DeviceBanded]


def device_matrix(A: sp.csr_matrix, dtype=jnp.float32,
                  prefer_dia: bool = True,
                  banded_max_fill: float = 8.0) -> DeviceMatrix:
    """Pick the fastest device format: structured DIA (stencils) >
    dense-band (bandable, gather-free) > padded ELL (gather fallback)."""
    if prefer_dia:
        dia = DeviceDIA.try_from_csr(A, dtype)
        if dia is not None:
            return dia
        band = DeviceBanded.try_from_csr(A, dtype, banded_max_fill)
        if band is not None:
            return band
    return DeviceELL.from_csr(A, dtype)


def rcm_permutation(A: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (band-minimizing)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(A.tocsr()), dtype=np.int64)
