"""Arbitrary-order tensor (Q_k) and P2 simplex elements
(fem/assemble.py nodal path — the MFEM H1_FECollection order>1 analog,
fem.hpp:427-484)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh, quad_mesh, read_mesh


def _solve_direct(mesh, order):
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, e2d, essd = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, order=order)
    x = spla.spsolve(A.tocsc(), b)
    return A, b, em, x


def _poisson_1d_exact(p):
    # -u'' = 1 on (0,1), u(0)=u(1)=0 -> u = x(1-x)/2; tensor analog used
    # only qualitatively — we check convergence of the FE solution to a
    # reference fine-grid solve instead
    return p[:, 0] * (1 - p[:, 0]) / 2


@pytest.mark.parametrize("order", [2, 3])
def test_qk_quad_stiffness_consistency(order):
    """Higher-order quad stiffness annihilates linears and reproduces the
    patch test: A @ (linear nodal values) == 0 on interior dofs."""
    mesh = quad_mesh(4)
    ess = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, e2d, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, order=order)
    coords = mesh.dof_coords(order)
    bdr = assemble.ess_dofs_from_attrs(
        mesh, np.ones(mesh.max_bdr_attr(), dtype=np.int64), order)
    interior = np.setdiff1d(np.arange(len(coords)), bdr)
    assert len(interior) > 0
    for lin in (np.ones(len(coords)), coords[:, 0], coords[:, 1],
                coords[:, 0] + 2 * coords[:, 1]):
        r = (A @ lin)[interior]
        assert np.abs(r).max() < 1e-9


@pytest.mark.parametrize("mesh_order", [("hex", 2), ("quad", 3)])
def test_high_order_solution_accuracy(mesh_order):
    kind, order = mesh_order
    mesh = hex_mesh(4) if kind == "hex" else quad_mesh(6)
    A, b, em, x = _solve_direct(mesh, order)
    # compare against a much finer order-1 reference solve at shared nodes
    fine = hex_mesh(16) if kind == "hex" else quad_mesh(48)
    Af, bf, _, xf = _solve_direct(fine, 1)
    cs = mesh.dof_coords(order)
    cf = fine.dof_coords(1)
    # match coarse high-order nodes that coincide with fine vertices
    from scipy.spatial import cKDTree
    tree = cKDTree(cf)
    d, idx = tree.query(cs)
    sel = d < 1e-10
    err = np.abs(x[sel] - xf[idx[sel]]).max()
    assert err < 2e-2 * max(np.abs(xf).max(), 1e-12)


def test_p2_simplices():
    """P2 triangles (mltest mesh) and P2 tets (cube474): patch test +
    direct solve sanity."""
    for path, n_refine in (("/root/reference/amg/test/mltest.mesh", 2),
                           ("/root/reference/amg/data/meshes/cube474.mesh3d",
                            0)):
        mesh = read_mesh(path).refined_times(n_refine)
        ess = np.zeros(mesh.max_bdr_attr(), dtype=np.int64)
        A, _, _, _, _ = assemble.build_discrete_problem(
            mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, order=2)
        coords = mesh.dof_coords(2)
        bdr = assemble.ess_dofs_from_attrs(
            mesh, np.ones(mesh.max_bdr_attr(), dtype=np.int64), 2)
        interior = np.setdiff1d(np.arange(len(coords)), bdr)
        assert len(interior) > 0
        for k in range(mesh.dim):
            r = (A @ coords[:, k])[interior]
            assert np.abs(r).max() < 1e-9, (path, k)
        # SPD + solvable with Dirichlet BCs
        ess1 = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
        A, b, em, e2d, essd = assemble.build_discrete_problem(
            mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess1, order=2)
        assert len(essd) > 0
        x = spla.spsolve(A.tocsc(), b)
        assert np.isfinite(x).all() and np.abs(x).max() > 0


def test_solver_order3():
    """End-to-end SpectralAMGSolver at order 3 (beyond the reference's
    tested order 2)."""
    mesh = quad_mesh(12)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess, order=3)
    opts = SolverOptions(num_levels=2, correct_nulspace=False,
                         first_elems_per_agg=16)
    s = SpectralAMGSolver(A, mesh, em, opts, order=3, ess_attr_marker=ess)
    res = s.solve(b)
    assert res.converged and res.iterations <= 25
    err = np.linalg.norm(res.x - spla.spsolve(A.tocsc(), b))
    assert err < 1e-5
