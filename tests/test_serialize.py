"""Hierarchy checkpoint/resume + coefficient plug-ins."""

import os

import numpy as np

from saamge_jax.api import SpectralAMGSolver, checkerboard_coef
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.coefficients import InversePermeability, anisotropic_tensor
from saamge_jax.fem.mesh import quad_mesh
from saamge_jax.solve.pcg import pcg
from saamge_jax.solve.vcycle import VCycleSolver
from saamge_jax.utils.serialize import load_hierarchy, save_hierarchy


def test_save_load_roundtrip(tmp_path):
    mesh = quad_mesh(30)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    opts = SolverOptions(num_levels=3, correct_nulspace=False,
                         first_elems_per_agg=32, elems_per_agg=8)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess)
    res = s.solve(b)

    path = os.path.join(tmp_path, "hier.npz")
    save_hierarchy(path, s.ml)
    ml2 = load_hierarchy(path)

    pre = VCycleSolver(ml2.finest.tg_data)
    pre.set_operator(A)

    def mult(r):
        z = np.zeros_like(r)
        pre.mult(r, z)
        return z

    res2 = pcg(A, b, mult, rel_tol=1e-6, max_iter=100)
    assert res2.converged
    assert res2.iterations == res.iterations   # identical preconditioner
    np.testing.assert_allclose(res2.x, res.x, atol=1e-8)


def test_anisotropic_tensor_assembles():
    mesh = quad_mesh(10)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    coef = anisotropic_tensor(np.array([1.0, 2.0]))
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    assert abs(A - A.T).max() < 1e-12
    import scipy.sparse.linalg as spla
    w = spla.eigsh(A, k=1, which="SA", return_eigenvectors=False)
    assert w[0] > 0


def test_inverse_permeability(tmp_path):
    ip = InversePermeability(Nx=4, Ny=3, Nz=2, hx=1.0, hy=1.0, hz=1.0)
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.5, 2.0, 3 * 4 * 3 * 2)
    f = os.path.join(tmp_path, "perm.dat")
    np.savetxt(f, vals.reshape(-1, 4))
    ip.read_file(f)
    x = np.array([0.5, 0.5, 0.5])
    T = ip.permeability_tensor(x)
    assert T.shape == (3, 3)
    np.testing.assert_allclose(np.diag(T), 1.0 / ip.inverse_permeability(x))
    # 2D slice mode returns 2x2 tensors usable as matrix coefficients
    ip.set_2d_slice("xy", 1)
    T2 = ip.permeability_tensor(np.array([0.2, 0.7]))
    assert T2.shape == (2, 2)
    # and it assembles
    mesh = quad_mesh(6, sx=4.0, sy=3.0)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=ip.coefficient(), rhs=1.0, ess_attr_marker=ess)
    assert np.isfinite(A.data).all()
