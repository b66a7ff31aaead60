"""The jitted device solve phase: multilevel V-cycle + PCG.

This is the production counterpart of solve/vcycle.py + solve/pcg.py: the
entire preconditioned solve is ONE XLA computation — polynomial smoothers
(root-by-root fma chains), residual/restriction/prolongation SpMVs on
ELL/DIA device matrices, a dense Cholesky coarsest solve, and a
`lax.while_loop` PCG around it.  Static shapes everywhere; the recursion
over levels is unrolled at trace time (hierarchy depth is a compile-time
constant, like the reference's levels list).

Reference counterparts: tg_cycle_atb (tg.cpp:91), smpr_sym_poly/
smpr_compute_poly (smpr.cpp:213, smpr.hpp:319), kalchev_pcg / mfem CGSolver
(mfem_addons.cpp:106), HypreDirect coarse solve (tg.cpp:61).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from saamge_jax.ops.sparse import (DeviceDIA, DeviceELL, DeviceMatrix,
                                   device_matrix)
from saamge_jax.ops.stencil import StencilDIA, inv_tau_arrays

HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CompiledLevel:
    A: DeviceMatrix
    P: DeviceELL                # prolongation (n_f, n_c)
    R: DeviceELL                # restriction  (n_c, n_f)
    dinv: jnp.ndarray           # weighted-l1 D^{-1} for the smoother
    roots: jnp.ndarray          # SAS relaxation roots (degree 3 nu + 1)
    # invx family second root set + mixing weight (smpr_sym_poly two-branch
    # path, smpr.cpp:213-234); roots2 has zero length for sa/sas/oneminusx
    roots2: jnp.ndarray = None
    weightfirst: jnp.ndarray = None
    # haloed stencil levels (A is a StencilDIA): haloed dinv + per-root
    # 1/tau device scalars (see ops/stencil.py)
    dinvh: jnp.ndarray = None
    inv_taus: tuple = None

    def tree_flatten(self):
        return ((self.A, self.P, self.R, self.dinv, self.roots,
                 self.roots2, self.weightfirst, self.dinvh,
                 self.inv_taus), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CompiledHierarchy:
    """Static solve-phase hierarchy; build once from an MLData via
    ``compile_hierarchy``."""

    levels: List[CompiledLevel]
    chol: jnp.ndarray           # dense Cholesky factor of the coarsest Ac
    coarse_n: int

    def tree_flatten(self):
        return (self.levels, self.chol), self.coarse_n

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux)


def compile_hierarchy(ml, dtype=jnp.float32, prefer_dia: bool = True,
                      use_block_row: bool = True) -> CompiledHierarchy:
    """Convert a host MLData (setup product) into device arrays.

    Coarse-level operators use the MIS-block-row format when the finer
    level's mis_coarsedofoffsets are available (coarse dofs are
    MIS-contiguous, so Ac has dense row blocks — ops/blockrow.py);
    otherwise DIA/banded/ELL by structure.  f32 DIA levels with a
    single root chain run as haloed stencil passes (ops/stencil.py)."""
    levels = []
    for i, level in enumerate(ml.levels):
        tg = level.tg_data
        A_dev = None
        if use_block_row and i > 0:
            finer = ml.levels[i - 1].tg_data
            offs = getattr(finer.interp_data, "mis_coarsedofoffsets", None)
            if offs is not None and offs[-1] == level.A.shape[0]:
                from saamge_jax.ops.blockrow import DeviceBlockRow
                groups = np.asarray(offs, dtype=np.int64)
                A_dev = DeviceBlockRow.from_csr(level.A, groups, dtype)
        if A_dev is None:
            A_dev = device_matrix(level.A, dtype, prefer_dia)
        P_dev = R_dev = None
        if use_block_row and not tg.smooth_interp:
            # tentative P/R have dense MIS row blocks too (R row group m =
            # MIS m's coarse dofs, columns = MIS m's fine dofs)
            offs = getattr(tg.interp_data, "mis_coarsedofoffsets", None)
            if offs is not None and offs[-1] == tg.restr.shape[0]:
                from saamge_jax.ops.blockrow import (DeviceBlockRow,
                                                     TransposedBlockRow)
                Rb = DeviceBlockRow.from_csr(
                    tg.restr, np.asarray(offs, dtype=np.int64), dtype)
                R_dev, P_dev = Rb, TransposedBlockRow(Rb)
        if P_dev is None:
            P_dev = DeviceELL.from_csr(tg.interp, dtype)
            R_dev = DeviceELL.from_csr(tg.restr, dtype)
        pd = tg.poly_data
        roots2 = np.asarray(pd.roots2) if pd.roots2 is not None \
            else np.zeros(0)
        dinvh = None
        inv_taus = None
        if (dtype == jnp.float32 and not len(roots2)
                and isinstance(A_dev, DeviceDIA)):
            # stencil level: haloed passes, the iterate stays haloed
            # across each root chain
            A_dev = StencilDIA.from_dia(A_dev)
            dinvh = A_dev.pad(jnp.asarray(pd.dinv, jnp.float32))
            inv_taus = inv_tau_arrays(pd.roots)
        levels.append(CompiledLevel(
            A=A_dev, P=P_dev, R=R_dev,
            dinv=jnp.asarray(pd.dinv, dtype=dtype),
            roots=jnp.asarray(pd.roots, dtype=dtype),
            roots2=jnp.asarray(roots2, dtype=dtype),
            weightfirst=jnp.asarray(pd.weightfirst, dtype=dtype),
            dinvh=dinvh, inv_taus=inv_taus))
    Ac = ml.levels[-1].tg_data.Ac.toarray()
    chol = jnp.asarray(np.linalg.cholesky(Ac), dtype=dtype)
    return CompiledHierarchy(levels, chol, Ac.shape[0])


def compile_two_level(A: sp.csr_matrix, tg, dtype=jnp.float32,
                      prefer_dia: bool = True) -> CompiledHierarchy:
    """Compile a bare TGData (two-level / algebraic path)."""
    pd = tg.poly_data
    roots2 = np.asarray(pd.roots2) if pd.roots2 is not None else np.zeros(0)
    level = CompiledLevel(
        A=device_matrix(A, dtype, prefer_dia),
        P=DeviceELL.from_csr(tg.interp, dtype),
        R=DeviceELL.from_csr(tg.restr, dtype),
        dinv=jnp.asarray(pd.dinv, dtype=dtype),
        roots=jnp.asarray(pd.roots, dtype=dtype),
        roots2=jnp.asarray(roots2, dtype=dtype),
        weightfirst=jnp.asarray(pd.weightfirst, dtype=dtype))
    Ac = tg.Ac.toarray()
    chol = jnp.asarray(np.linalg.cholesky(Ac), dtype=dtype)
    return CompiledHierarchy([level], chol, Ac.shape[0])


# ---------------------------------------------------------------------------
# functional kernels (all jit-traceable)


def smooth(level: CompiledLevel, b: jnp.ndarray,
           x: jnp.ndarray) -> jnp.ndarray:
    """smpr_sym_poly/smpr_compute_poly: x += (1/tau) D^{-1} (b - A x) per
    root; the invx family mixes two root chains with weightfirst
    (smpr.cpp:213-234).

    Stencil levels chain haloed root passes; otherwise the roots scan
    unrolls into SpMV+fma stages that XLA fuses."""
    if level.inv_taus is not None:
        A = level.A
        bh, xh = A.pad(b), A.pad(x)
        for it in level.inv_taus:
            xh = A.root_h(it, bh, level.dinvh, xh)
        return A.unpad(xh, x.dtype)

    def chain(x0, roots):
        def body(x, tau):
            x = x + (level.dinv * (b - level.A.matvec(x))) / tau
            return x, None
        x1, _ = jax.lax.scan(body, x0, roots)
        return x1

    x1 = chain(x, level.roots)
    if level.roots2 is not None and level.roots2.shape[0]:
        x2 = chain(x, level.roots2)
        w = level.weightfirst
        return w * x1 + (1.0 - w) * x2
    return x1


def coarse_solve(h: CompiledHierarchy, b: jnp.ndarray) -> jnp.ndarray:
    with jax.default_matmul_precision("highest"):
        y = jax.scipy.linalg.solve_triangular(h.chol, b, lower=True)
        return jax.scipy.linalg.solve_triangular(h.chol.T, y, lower=False)


def vcycle(h: CompiledHierarchy, b: jnp.ndarray, x: jnp.ndarray,
           level: int = 0, mu: int = 1) -> jnp.ndarray:
    """tg_cycle_atb, unrolled over levels at trace time; mu=2 gives the
    W-cycle (each coarse visit recurses mu times)."""
    lv = h.levels[level]

    def coarse_correct(resc):
        if level + 1 < len(h.levels):
            xc = jnp.zeros(h.levels[level + 1].A.shape[0], dtype=b.dtype)
            return vcycle(h, resc, xc, level + 1, mu)
        return coarse_solve(h, resc)

    if lv.inv_taus is not None:
        # blocked-stencil level: keep the iterate in the haloed layout
        # across pre-smooth and the residual (no pad/slice glue)
        A = lv.A
        bh, xh = A.pad(b), A.pad(x)
        for it in lv.inv_taus:
            xh = A.root_h(it, bh, lv.dinvh, xh)
        for cycle in range(mu):
            res = A.unpad(A.residual_h(bh, xh), b.dtype)
            xc = coarse_correct(lv.R.matvec(res))
            corr = lv.P.matvec(xc)
            xh = xh + A.pad(corr)
        for it in lv.inv_taus:
            xh = A.root_h(it, bh, lv.dinvh, xh)
        return A.unpad(xh, b.dtype)

    x = smooth(lv, b, x)
    for cycle in range(mu):
        res = b - lv.A.matvec(x)
        resc = lv.R.matvec(res)
        xc = coarse_correct(resc)
        x = x + lv.P.matvec(xc)
    x = smooth(lv, b, x)
    return x


def precond(h: CompiledHierarchy, r: jnp.ndarray) -> jnp.ndarray:
    return vcycle(h, r, jnp.zeros_like(r))


def pcg_solve(h: CompiledHierarchy, b: jnp.ndarray,
              x0: Optional[jnp.ndarray] = None, rel_tol: float = 1e-6,
              abs_tol: float = 0.0,
              max_iter: int = 200) -> Tuple[jnp.ndarray, jnp.ndarray,
                                            jnp.ndarray]:
    """MFEM-CGSolver-semantics PCG, entirely on device.

    Returns (x, iterations, final (Br,r)).  Convergence when
    (B r, r) <= max(rel_tol^2 (B r0, r0), abs_tol^2).  Tolerances are
    converted to device scalars so new values do NOT retrace (python
    scalars key the jit cache by value)."""
    return _pcg_solve(h, b, x0, jnp.asarray(rel_tol, b.dtype),
                      jnp.asarray(abs_tol, b.dtype), max_iter)


@partial(jax.jit, static_argnames=("max_iter",))
def _pcg_solve(h: CompiledHierarchy, b: jnp.ndarray,
               x0: Optional[jnp.ndarray], rel_tol, abs_tol,
               max_iter: int):
    A = h.levels[0].A
    dot = partial(jnp.dot, precision=HI)
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r0vec = b
    else:
        r0vec = b - A.matvec(x0)
    z = precond(h, r0vec)
    nom0 = dot(z, r0vec)
    lim = jnp.maximum(nom0 * rel_tol * rel_tol, abs_tol * abs_tol)
    Ad0 = A.matvec(z)

    def cond(state):
        x, r, d, Ad, nom, it = state
        return jnp.logical_and(nom > lim, it < max_iter)

    def body(state):
        x, r, d, Ad, nom, it = state
        den = dot(d, Ad)
        alpha = nom / den
        x = x + alpha * d
        r = r - alpha * Ad
        z = precond(h, r)
        betanom = dot(r, z)
        d = z + (betanom / nom) * d
        Ad = A.matvec(d)
        return (x, r, d, Ad, betanom, it + 1)

    state = (x0, r0vec, z, Ad0, nom0, jnp.int32(0))
    x, r, d, Ad, nom, it = jax.lax.while_loop(cond, body, state)
    return x, it, nom


@jax.jit
def vcycle_apply(h: CompiledHierarchy, b: jnp.ndarray) -> jnp.ndarray:
    """One preconditioner application (the throughput benchmark kernel)."""
    return precond(h, b)
