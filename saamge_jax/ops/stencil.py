"""Haloed DIA stencil operator: the fine-level format of the structured
path and of the general path's DIA levels.

The solve-phase hot loop streams the operator's diagonals once per
smoother root / SpMV (smpr_compute_poly, reference smpr.hpp:319-339;
tg_cycle_atb residual, tg.cpp:115); that traffic (k diagonals x n x
itemsize) is the floor of every pass.

Vectors live as (T, 128) rows in a HALOED layout: ``hr`` zero rows above
and below the ``n_rows_pad`` data rows.  Passes consume and produce the
haloed layout, so chained root passes need no pad/slice glue between
them, and the sharded path (parallel/structured_sharded.py) refreshes
the halo rows with neighbour ``ppermute`` of whole rows.  A flat stencil
offset ``s`` reads ``x[i + s]``; the halo covers the largest row reach.

Pass modes: 'spmv' (y = A x), 'residual' (y = b - A x) and 'root'
(y = x + dinv (b - A x) / tau, the smpr root step).  Each pass is the
27-term shifted-slice multiply-add that XLA fuses into one loop kernel
(``backend="xla"``), or a Pallas kernel through Triton
(``backend="triton"``, ``_triton_pass``) that makes the same reads from
one program per 1024-element block.  ``stencil_backend`` is the one
place that chooses between them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

LANES = 128
# data and halo rows are padded to whole Triton blocks of
# ROW_ALIGN * LANES elements
ROW_ALIGN = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stencil_backend() -> str:
    """The stencil pass implementation for the default device: the
    Pallas-Triton pass on a GPU (it ran the n=96 root pass and the whole
    V-cycle faster than XLA's fusion of the same reads on an H100, see
    PERF.md), the XLA fusion elsewhere.  A Triton pass that fails to
    compile raises; nothing falls back."""
    return "triton" if jax.devices()[0].platform == "gpu" else "xla"


def halo_rows(offsets) -> int:
    """Halo rows on each side: the largest row reach of the offsets plus
    one (a lane shift can cross into the next row), row-aligned."""
    need = max(abs(divmod(int(o), LANES)[0]) for o in offsets) + 1
    return _round_up(need, ROW_ALIGN)


def padded_rows(n: int) -> int:
    """Data rows for n values, row-aligned."""
    return _round_up(_round_up(n, LANES) // LANES, ROW_ALIGN)


def _emit(mode, ax, xc, b, dinv, inv_tau):
    if mode == "spmv":
        return ax
    if mode == "residual":
        return b - ax
    return xc + dinv * (b - ax) * inv_tau


def _xla_pass(mode, offsets, hr, vals, xh, bh, dinvh, inv_tau):
    """One pass as a shifted-slice multiply-add over the data rows; the
    halo rows of the result are zero."""
    k, n_rows_pad, _ = vals.shape
    m = n_rows_pad * LANES
    base = hr * LANES
    xf = xh.reshape(-1)
    ax = jnp.zeros((m,), jnp.float32)
    for d, off in enumerate(offsets):
        xs = jax.lax.slice(xf, (base + off,), (base + off + m,))
        ax = ax + vals[d].reshape(-1).astype(jnp.float32) * xs
    inner = lambda v: jax.lax.slice(v.reshape(-1), (base,),  # noqa: E731
                                    (base + m,))
    y = _emit(mode, ax,
              inner(xh) if mode == "root" else None,
              None if mode == "spmv" else inner(bh),
              inner(dinvh) if mode == "root" else None,
              None if inv_tau is None else inv_tau[0])
    return jnp.pad(y, (base, base)).reshape(-1, LANES)


@lru_cache(maxsize=128)
def _triton_pass(mode: str, offsets: Tuple[int, ...], n_rows_pad: int,
                 hr: int, interpret: bool):
    """Pallas-Triton pass over the flat haloed vector: program j owns
    elements [j*BLOCK, (j+1)*BLOCK); halo programs write zeros, data
    programs load each tap as an unaligned 1024-element slice of x (the
    neighbouring taps hit L1/L2) and the matching diagonal block."""
    from jax.experimental.pallas import triton as plgpu
    block = ROW_ALIGN * LANES
    t_rows = n_rows_pad + 2 * hr
    nprog = t_rows * LANES // block
    hprog = hr * LANES // block

    def kernel(*refs):
        if mode == "spmv":
            x_ref, v_ref, o_ref = refs
        elif mode == "residual":
            x_ref, v_ref, b_ref, o_ref = refs
        else:
            tau_ref, x_ref, v_ref, b_ref, d_ref, o_ref = refs
        j = pl.program_id(0)
        start = j * block
        interior = jnp.logical_and(j >= hprog, j < nprog - hprog)

        @pl.when(interior)
        def _():
            vstart = (j - hprog) * block
            ax = jnp.zeros((block,), jnp.float32)
            for d, off in enumerate(offsets):
                v = v_ref[d, pl.ds(vstart, block)].astype(jnp.float32)
                ax = ax + v * x_ref[pl.ds(start + off, block)]
            here = pl.ds(start, block)
            o_ref[here] = _emit(
                mode, ax,
                x_ref[here] if mode == "root" else None,
                None if mode == "spmv" else b_ref[here],
                d_ref[here] if mode == "root" else None,
                tau_ref[0] if mode == "root" else None)

        @pl.when(jnp.logical_not(interior))
        def _():
            o_ref[pl.ds(start, block)] = jnp.zeros((block,), jnp.float32)

    return pl.pallas_call(
        kernel, grid=(nprog,),
        out_shape=jax.ShapeDtypeStruct((t_rows * LANES,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton", interpret=interpret, name=f"stencil_{mode}")


def stencil_pass(mode: str, offsets, hr: int, vals, xh, bh=None,
                 dinvh=None, inv_tau=None, backend: str = "xla",
                 interpret: bool = False):
    """One haloed pass; ``vals`` (k, n_rows_pad, 128) f32 or bf16 (the
    arithmetic is f32), vectors (n_rows_pad + 2 hr, 128) f32."""
    if backend == "xla":
        return _xla_pass(mode, offsets, hr, vals, xh, bh, dinvh, inv_tau)
    if backend != "triton":
        raise ValueError(f"unknown stencil backend {backend!r}")
    k, n_rows_pad, _ = vals.shape
    fn = _triton_pass(mode, tuple(offsets), n_rows_pad, hr, interpret)
    flat = lambda a: a.reshape(-1)  # noqa: E731
    v2 = vals.reshape(k, -1)
    if mode == "spmv":
        out = fn(flat(xh), v2)
    elif mode == "residual":
        out = fn(flat(xh), v2, flat(bh))
    else:
        out = fn(inv_tau, flat(xh), v2, flat(bh), flat(dinvh))
    return out.reshape(-1, LANES)


@jax.tree_util.register_pytree_node_class
class StencilDIA:
    """DIA operator applied in the haloed layout.

    Layout: vals2 (k, n_rows_pad, 128), row-aligned (vals2[d] holds
    A[i, i + offsets[d]] at flat position i, zero out of range).
    Vectors are carried haloed between chained passes; ``pad``/``unpad``
    convert from/to flat (n,) at the level boundaries."""

    def __init__(self, vals2, offsets, shape, n_rows_pad, hr,
                 backend="xla", interpret=False):
        self.vals2 = vals2
        self.offsets = offsets
        self.shape = shape
        self.n_rows_pad = n_rows_pad
        self.hr = hr
        self.backend = backend
        self.interpret = interpret

    def tree_flatten(self):
        return (self.vals2,), (self.offsets, self.shape, self.n_rows_pad,
                               self.hr, self.backend, self.interpret)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @staticmethod
    def from_dia(dia, dtype=jnp.float32, backend: Optional[str] = None,
                 interpret: bool = False) -> "StencilDIA":
        """Build from an ops.sparse.DeviceDIA (vals (k, n) row-aligned).

        ``dtype``: storage dtype of the diagonal values.  bf16 halves the
        dominant per-pass stream; arithmetic stays f32.  The geometry is
        dtype-independent, so f32/bf16 twins share the vector layout."""
        n = dia.shape[0]
        k = len(dia.offsets)
        n_rows_pad = padded_rows(n)
        vals2 = jnp.zeros((k, n_rows_pad * LANES), dtype=dtype)
        vals2 = vals2.at[:, :n].set(dia.vals.astype(dtype))
        offsets = tuple(int(o) for o in dia.offsets)
        return StencilDIA(vals2.reshape(k, n_rows_pad, LANES), offsets,
                          dia.shape, n_rows_pad, halo_rows(offsets),
                          backend or stencil_backend(), interpret)

    def astype(self, dtype) -> "StencilDIA":
        return StencilDIA(self.vals2.astype(dtype), self.offsets,
                          self.shape, self.n_rows_pad, self.hr,
                          self.backend, self.interpret)

    # -- haloed-layout plumbing ------------------------------------------
    def pad(self, x):
        """flat (n,) -> haloed (t_rows, 128)."""
        xp = jnp.zeros(((2 * self.hr + self.n_rows_pad) * LANES,),
                       dtype=jnp.float32)
        xp = jax.lax.dynamic_update_slice(
            xp, x.astype(jnp.float32), (self.hr * LANES,))
        return xp.reshape(-1, LANES)

    def unpad(self, xh, dtype=jnp.float32):
        n = self.shape[0]
        flat = xh.reshape(-1)
        return flat[self.hr * LANES:self.hr * LANES + n].astype(dtype)

    def _pass(self, mode, xh, bh=None, dinvh=None, inv_tau=None):
        return stencil_pass(mode, self.offsets, self.hr, self.vals2, xh,
                            bh, dinvh, inv_tau, self.backend,
                            self.interpret)

    # -- haloed-layout passes (chainable) --------------------------------
    def matvec_h(self, xh):
        return self._pass("spmv", xh)

    def residual_h(self, bh, xh):
        return self._pass("residual", xh, bh)

    def root_h(self, inv_tau, bh, dinvh, xh):
        """inv_tau: (1,) f32 array (1/tau of this root)."""
        return self._pass("root", xh, bh, dinvh, inv_tau)

    # -- flat-vector convenience (PCG matvec etc.) -----------------------
    def matvec(self, x):
        return self.unpad(self.matvec_h(self.pad(x)), x.dtype)


def inv_tau_arrays(roots) -> tuple:
    """Per-root (1,) f32 device scalars 1/tau."""
    return tuple(jnp.asarray([1.0 / float(t)], jnp.float32)
                 for t in np.asarray(roots))
