"""Device-side batched element-matrix assembly (jax).

The element-matrix batch — the FLOP-heavy part of FEM assembly
(fem_build_discrete_problem, fem.hpp:427-484) — is a pure batched einsum
pipeline, so it runs as a jitted device kernel here instead of on the
few host cores: geometry Jacobians (closed-form batched inverse/det),
physical gradients, and the quadrature-weighted stiffness contraction,
chunked over elements to bound device memory.  Results return as
float32; the numpy f64 path in fem/assemble.py remains the parity
reference.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

# default einsum/dot precision may drop f32 operands to TF32 or bf16;
# geometry and stiffness contractions need true f32 products
_PREC = jax.lax.Precision.HIGHEST

from saamge_jax.fem import assemble as host
from saamge_jax.fem.mesh import Mesh


def _inv_det_jnp(J):
    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = jnp.stack([jnp.stack([e, -b], -1),
                         jnp.stack([-c, a], -1)], -2) / det[..., None, None]
        return inv, jnp.abs(det)
    assert d == 3
    c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
    c01 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
    c02 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
    det = J[..., 0, 0] * c00 + J[..., 0, 1] * c01 + J[..., 0, 2] * c02
    r0 = jnp.stack([c00,
                    J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2],
                    J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]],
                   -1)
    r1 = jnp.stack([c01,
                    J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0],
                    J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]],
                   -1)
    r2 = jnp.stack([c02,
                    J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1],
                    J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]],
                   -1)
    inv = jnp.stack([r0, r1, r2], -2) / det[..., None, None]
    return inv, jnp.abs(det)


@partial(jax.jit, static_argnames=())
def _diffusion_chunk(X, dN, wts, coef_e):
    """X (E, nv, d) vertex coords; dN (nq, nd, d) reference gradients;
    wts (nq,); coef_e (E,) scalar coefficient.  Returns (E, nd, nd)."""
    J = jnp.einsum("eak,qad->eqkd", X, dN, precision=_PREC)
    Jinv, detJ = _inv_det_jnp(J)
    gradN = jnp.einsum("qad,eqdk->eqak", dN, Jinv, precision=_PREC)
    w = wts[None, :] * detJ * coef_e[:, None]            # (E, nq)
    return jnp.einsum("eq,eqak,eqbk->eab", w, gradN, gradN,
                      precision=_PREC)


def diffusion_element_matrices(mesh: Mesh, coef=1.0,
                               chunk: int = 1 << 15) -> np.ndarray:
    """Device twin of assemble.diffusion_element_matrices (scalar or
    per-element coefficients; order 1)."""
    pts, wts, N, dN = host.reference_element(mesh.elem_type, 1)
    c = host._eval_coefficient(coef, mesh)
    X = mesh.vertices[mesh.elements].astype(np.float32)
    dN_d = jnp.asarray(dN, dtype=jnp.float32)
    wts_d = jnp.asarray(wts, dtype=jnp.float32)
    NE = mesh.num_elements
    nd = dN.shape[1]
    chunk = min(chunk, -(-NE // max(NE // chunk, 1)))
    out = np.empty((NE, nd, nd), dtype=np.float32)
    for lo in range(0, NE, chunk):
        hi = min(lo + chunk, NE)
        Xc = X[lo:hi]
        cc = c[lo:hi].astype(np.float32)
        if hi - lo < chunk:          # pad: ONE compiled chunk shape
            pad = chunk - (hi - lo)
            Xc = np.concatenate([Xc, np.repeat(Xc[-1:], pad, axis=0)])
            cc = np.concatenate([cc, np.zeros(pad, dtype=np.float32)])
        blk = _diffusion_chunk(jnp.asarray(Xc), dN_d, wts_d,
                               jnp.asarray(cc))
        out[lo:hi] = np.asarray(blk)[:hi - lo]
    return out


def build_discrete_problem(mesh: Mesh, coef=1.0, rhs=1.0,
                           ess_attr_marker=None, order: int = 1):
    """Device-assembled analog of assemble.build_discrete_problem for the
    scalar diffusion case (the benchmark path)."""
    assert order == 1
    elem_mats = diffusion_element_matrices(mesh, coef).astype(np.float64)
    b = host.domain_lf(mesh, rhs, order, 1)
    e2d = mesh.elem_to_dof(order, 1)
    A = host.assemble_global(elem_mats, e2d, mesh.num_dofs(order))
    ess = np.zeros(0, dtype=np.int64)
    if ess_attr_marker is not None:
        ess = host.ess_dofs_from_attrs(mesh, ess_attr_marker, order, 1)
        x0 = np.zeros_like(b)
        A = host.eliminate_essential_bc(A, ess, x0, b)
        b[ess] = 0.0
    return A, b, elem_mats, e2d, ess
