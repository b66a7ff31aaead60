"""Device sparse formats: banded (gather-free), DIA, ELL."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from saamge_jax.ops.sparse import (DeviceBanded, DeviceDIA, DeviceELL,
                                   device_matrix, rcm_permutation)


def _band_matrix(n=100, bw=5, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.diags([rng.standard_normal(n - abs(k)) for k in range(-bw, bw + 1)],
                 offsets=list(range(-bw, bw + 1)), format="csr")
    return A.tocsr()


def test_banded_matches_scipy():
    A = _band_matrix(123, 7)
    B = DeviceBanded.try_from_csr(A, dtype=jnp.float64)
    assert B is not None
    x = np.random.default_rng(1).standard_normal(123)
    y = np.asarray(B.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)


def test_banded_fill_guard():
    # an arrow matrix has full bandwidth: banded must refuse
    n = 256
    A = sp.lil_matrix((n, n))
    A.setdiag(2.0)
    A[0, :] = 1.0
    A[:, 0] = 1.0
    assert DeviceBanded.try_from_csr(A.tocsr(), max_fill=8.0) is None


def test_rcm_reduces_band():
    A = _band_matrix(200, 4)
    perm = np.random.default_rng(0).permutation(200)
    Ashuf = A[np.ix_(perm, perm)].tocsr()
    p = rcm_permutation(Ashuf)
    Aback = Ashuf[np.ix_(p, p)].tocoo()
    bw = np.abs(Aback.col - Aback.row).max()
    assert bw <= 3 * 4 + 2


def test_device_matrix_selection():
    # stencil -> DIA
    A = _band_matrix(200, 2)
    assert isinstance(device_matrix(A), DeviceDIA)
    # wide band with many distinct offsets -> banded
    A2 = _band_matrix(400, 45)
    m = device_matrix(A2)
    assert isinstance(m, DeviceBanded)
    # scattered -> ELL
    A3 = sp.random(300, 300, density=0.02, random_state=0,
                   format="csr") + sp.identity(300)
    assert isinstance(device_matrix(A3.tocsr(), banded_max_fill=2.0),
                      DeviceELL)



def test_blockrow_matches_scipy():
    from saamge_jax.ops.blockrow import DeviceBlockRow
    rng = np.random.default_rng(0)
    # build a block matrix with contiguous row groups sharing column sets
    n = 90
    offsets = np.array([0, 5, 5, 17, 30, 58, 90])
    rows, cols, vals = [], [], []
    for g in range(len(offsets) - 1):
        r0, r1 = offsets[g], offsets[g + 1]
        if r1 == r0:
            continue
        colset = rng.choice(n, size=rng.integers(3, 25), replace=False)
        for r in range(r0, r1):
            for c in colset:
                rows.append(r); cols.append(c)
                vals.append(rng.standard_normal())
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    B = DeviceBlockRow.from_csr(A, offsets, dtype=jnp.float64)
    x = rng.standard_normal(n)
    y = np.asarray(B.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)


def test_compiled_hierarchy_blockrow_matches_plain():
    from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
    from saamge_jax.config import SolverOptions
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import quad_mesh
    from saamge_jax.solve import compiled

    mesh = quad_mesh(24)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    s = SpectralAMGSolver(A, mesh, em,
                          SolverOptions(num_levels=3, correct_nulspace=False,
                                        first_elems_per_agg=32,
                                        elems_per_agg=8),
                          ess_attr_marker=ess)
    h_plain = compiled.compile_hierarchy(s.ml, dtype=jnp.float64,
                                         use_block_row=False)
    h_block = compiled.compile_hierarchy(s.ml, dtype=jnp.float64,
                                         use_block_row=True)
    from saamge_jax.ops.blockrow import DeviceBlockRow
    assert any(isinstance(lv.A, DeviceBlockRow) for lv in h_block.levels[1:])
    bdev = jnp.asarray(b)
    z1 = np.asarray(compiled.vcycle_apply(h_plain, bdev))
    z2 = np.asarray(compiled.vcycle_apply(h_block, bdev))
    np.testing.assert_allclose(z2, z1, rtol=1e-9, atol=1e-11)


def test_fused_pallas_smoother_interpret():
    """A 2D stencil level of compile_hierarchy (haloed passes, the
    successor of the fused smoother kernel) smooths exactly like the
    host polynomial smoother."""
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import quad_mesh
    from saamge_jax.ops.sparse import DeviceDIA
    from saamge_jax.ops.stencil import StencilDIA, inv_tau_arrays
    from saamge_jax.solve import smoothers
    from saamge_jax.solve.compiled import CompiledLevel, smooth

    mesh = quad_mesh(12)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    sdia = StencilDIA.from_dia(DeviceDIA.try_from_csr(A, jnp.float32))
    pd = smoothers.init_poly_data(A, 2, "sas")
    lv = CompiledLevel(
        A=sdia, P=None, R=None,
        dinv=jnp.asarray(pd.dinv, jnp.float32),
        roots=jnp.asarray(pd.roots, jnp.float32),
        dinvh=sdia.pad(jnp.asarray(pd.dinv, jnp.float32)),
        inv_taus=inv_tau_arrays(pd.roots))
    x0 = np.zeros(A.shape[0])
    y = np.asarray(smooth(lv, jnp.asarray(b, dtype=jnp.float32),
                          jnp.asarray(x0, dtype=jnp.float32)))
    ref = smoothers.compute_poly(A, b, x0.copy(), pd.roots, pd.dinv)
    assert np.abs(y - ref).max() / np.abs(ref).max() < 1e-5
