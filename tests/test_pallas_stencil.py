"""Haloed stencil passes (ops/stencil.py) vs scipy.

The haloed DIA passes are the fine-level format of the structured path
and of the general path's stencil levels (reference hot loop
tg.cpp:91-131 / smpr.hpp:319-339).  Both implementations are checked:
the XLA fusion and the Pallas-Triton pass, the latter in interpret
mode here (tests/test_gpu.py compiles it on the card)."""

import numpy as np
import scipy.sparse as sp
import pytest

import jax.numpy as jnp

from saamge_jax.ops.sparse import DeviceDIA
from saamge_jax.ops.stencil import StencilDIA, inv_tau_arrays
from saamge_jax.solve.structured import _zlane_csr


def _grid_stencil(nodes, seed=0):
    """Random 27-point stencil on an (nx, ny, nz) node grid (x-major
    lexicographic ids) as CSR, diagonally dominant."""
    nx, ny, nz = nodes
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    N = nx * ny * nz
    rng = np.random.default_rng(seed)
    rows, cols, data = [], [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                      & (jz >= 0) & (jz < nz))
                rows.append(np.flatnonzero(ok))
                cols.append(((jx * ny + jy) * nz + jz)[ok])
                v = rng.standard_normal(ok.sum()) * 0.1
                if (dx, dy, dz) == (0, 0, 0):
                    v = v + 3.0
                data.append(v)
    return sp.csr_matrix((np.concatenate(data),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(N, N))


def _stencil_matrix(n, seed=0):
    """Random 27-point stencil operator on an n^3 grid (row-aligned DIA +
    the equivalent CSR)."""
    A = _grid_stencil((n, n, n), seed)
    return A, DeviceDIA.try_from_csr(A, jnp.float32)


@pytest.fixture(scope="module")
def op():
    A, dia = _stencil_matrix(8)
    return A, StencilDIA.from_dia(dia)


def test_spmv_matches_scipy(op):
    A, p = op
    x = np.random.default_rng(1).standard_normal(A.shape[0]) \
        .astype(np.float32)
    y = np.asarray(p.matvec(jnp.asarray(x)))
    ref = A @ x
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_residual_haloed(op):
    A, p = op
    rng = np.random.default_rng(2)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    rh = p.residual_h(p.pad(jnp.asarray(b)), p.pad(jnp.asarray(x)))
    r = np.asarray(p.unpad(rh))
    ref = b - A @ x
    assert np.abs(r - ref).max() <= 1e-5 * np.abs(ref).max()
    # halo rows must come back zero (chainability invariant)
    rh = np.asarray(rh)
    assert np.all(rh[:p.hr] == 0) and np.all(rh[-p.hr:] == 0)


def test_smoother_matches_host_roots(op):
    A, p = op
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    dinv = (1.0 / np.abs(A.diagonal() + 3.0)).astype(np.float32)
    roots = [2.0, 3.0, 4.0]
    bh, dh, xh = (p.pad(jnp.asarray(v)) for v in (b, dinv, x))
    for it in inv_tau_arrays(roots):
        xh = p.root_h(it, bh, dh, xh)
    got = np.asarray(p.unpad(xh))
    ref = x.copy()
    for t in roots:
        ref = ref + dinv * (b - A @ ref) / t
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_compiled_hierarchy_blocked_path():
    """compile_hierarchy runs its stencil fine level as haloed passes;
    PCG must match the same hierarchy with an ELL fine level."""
    from saamge_jax.fem.mesh import hex_mesh
    from saamge_jax.fem import assemble
    from saamge_jax.api import SpectralAMGSolver
    from saamge_jax.config import SolverOptions
    from saamge_jax.solve import compiled as C

    mesh = hex_mesh(6)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=32, elems_per_agg=32,
                         device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)

    h_ref = C.compile_hierarchy(s.ml, prefer_dia=False)
    h_blk = C.compile_hierarchy(s.ml)
    assert isinstance(h_blk.levels[0].A, StencilDIA)
    assert not isinstance(h_ref.levels[0].A, StencilDIA)

    bdev = jnp.asarray(b, jnp.float32)
    x1, it1, _ = C.pcg_solve(h_ref, bdev, max_iter=60)
    x2, it2, _ = C.pcg_solve(h_blk, bdev, max_iter=60)
    assert int(it1) == int(it2)
    assert np.allclose(np.asarray(x1), np.asarray(x2), atol=1e-3)


def _layout_op(layout, dtype, backend, nodes=(6, 7, 9), seed=4):
    """(CSR reference in the kernel's numbering, StencilDIA) for the
    flat or z-lane layout; bf16 references use the bf16-rounded values."""
    A = _grid_stencil(nodes, seed)
    if layout == "zlane":
        A = _zlane_csr(A, nodes, 128)
    dia = DeviceDIA.try_from_csr(A, jnp.float32, max_diags=64)
    p = StencilDIA.from_dia(dia, dtype=dtype, backend=backend,
                            interpret=True)
    if dtype == jnp.bfloat16:
        A = A.copy()
        A.data = np.asarray(jnp.asarray(A.data, jnp.bfloat16), np.float64)
    return A, p


@pytest.mark.parametrize("backend", ["xla", "triton"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["flat", "zlane"])
@pytest.mark.parametrize("mode", ["spmv", "residual", "root"])
def test_pass_matches_scipy(mode, layout, dtype, backend):
    """Every pass, in both fine layouts and both storage dtypes, against
    scipy CSR in float64; the halo rows of the result stay zero."""
    A, p = _layout_op(layout, dtype, backend)
    n = A.shape[0]
    rng = np.random.default_rng(11)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    d = (rng.random(n) + 0.5).astype(np.float32)
    if layout == "zlane":
        # padding slots carry no values (zero rows and columns)
        pad = np.asarray(A.getnnz(axis=1) == 0)
        x[pad] = b[pad] = d[pad] = 0.0
    ax = A @ x.astype(np.float64)
    xh, bh, dh = (p.pad(jnp.asarray(v)) for v in (x, b, d))
    if mode == "spmv":
        yh, ref = p.matvec_h(xh), ax
    elif mode == "residual":
        yh, ref = p.residual_h(bh, xh), b - ax
    else:
        yh = p.root_h(jnp.asarray([0.7], jnp.float32), bh, dh, xh)
        ref = x + d * (b - ax) * 0.7
    y = np.asarray(p.unpad(yh))
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()
    yh = np.asarray(yh)
    assert np.all(yh[:p.hr] == 0) and np.all(yh[-p.hr:] == 0)
