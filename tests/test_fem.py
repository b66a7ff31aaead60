import numpy as np
import pytest

from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh, quad_mesh, read_mesh


def test_quad_laplacian_known():
    # unit square, 1x1 Q1 element, coefficient 1: the 4x4 element stiffness
    # has diagonal 2/3 and the classic bilinear pattern
    mesh = quad_mesh(1)
    K = assemble.diffusion_element_matrices(mesh, 1.0)[0]
    expect = np.array([
        [4, -1, -2, -1],
        [-1, 4, -1, -2],
        [-2, -1, 4, -1],
        [-1, -2, -1, 4]]) / 6.0
    np.testing.assert_allclose(K, expect, atol=1e-14)


def test_assembled_matrix_properties():
    mesh = quad_mesh(8)
    A, b, em, e2d, ess = assemble.build_discrete_problem(mesh, coef=1.0)
    Ad = A.toarray()
    np.testing.assert_allclose(Ad, Ad.T, atol=1e-13)
    evals = np.linalg.eigvalsh(Ad)
    assert evals.min() > 0  # SPD after elimination w/ kept diagonal
    # interior row sums are zero pre-elimination (constants in kernel)
    mesh2 = quad_mesh(4)
    K = assemble.diffusion_element_matrices(mesh2, 1.0)
    A2 = assemble.assemble_global(K, mesh2.elem_to_dof(), mesh2.num_vertices)
    np.testing.assert_allclose(np.asarray(A2.sum(axis=1)).ravel(), 0.0,
                               atol=1e-12)


def test_hex_element_rowsum_zero():
    mesh = hex_mesh(2)
    K = assemble.elasticity_element_matrices(mesh, 1.0)
    # rigid translations in kernel of each elasticity element matrix
    nd = mesh.elements.shape[1]
    for d in range(3):
        v = np.zeros(3 * nd)
        v[d * nd:(d + 1) * nd] = 1.0
        np.testing.assert_allclose(K[0] @ v, 0.0, atol=1e-12)


def test_elasticity_rotation_kernel():
    mesh = quad_mesh(2)
    K = assemble.elasticity_element_matrices(mesh, 1.0)
    verts = mesh.vertices[mesh.elements[0]]
    nd = len(verts)
    # rotation (y, -x)
    v = np.concatenate([verts[:, 1], -verts[:, 0]])
    np.testing.assert_allclose(K[0] @ v, 0.0, atol=1e-12)


def test_mfem_mesh_reader():
    mesh = read_mesh("/root/reference/amg/test/mltest.mesh")
    assert mesh.num_vertices == 20
    assert mesh.num_elements == 12
    assert mesh.elem_type == "quad"
    # boundary attribute 4 is the left edge x=0
    ess = mesh.ess_vertices(np.array([0, 0, 0, 1]))
    np.testing.assert_allclose(mesh.vertices[ess][:, 0], 0.0)


def test_netgen_reader_and_refine():
    mesh = read_mesh("/root/reference/amg/data/meshes/cube474.mesh3d")
    assert mesh.elem_type == "tet"
    assert mesh.num_elements == 474
    r = mesh.refine_uniform()
    assert r.num_elements == 474 * 8
    # refinement preserves total volume
    def vol(m):
        X = m.vertices[m.elements]
        d = X[:, 1:] - X[:, :1]
        return np.abs(np.linalg.det(d)).sum() / 6.0
    np.testing.assert_allclose(vol(mesh), vol(r), rtol=1e-12)


def test_q2_dof_count():
    mesh = quad_mesh(3)
    # Q2 on n x n quads: (2n+1)^2 dofs
    assert mesh.num_dofs(2) == 7 * 7


def test_device_assembly_matches_host():
    from saamge_jax.fem import assemble, assemble_jax
    from saamge_jax.fem.mesh import hex_mesh
    mesh = hex_mesh(6)
    em_h = assemble.diffusion_element_matrices(mesh, 1.0)
    em_d = assemble_jax.diffusion_element_matrices(mesh, 1.0)
    assert np.abs(em_h - em_d).max() / np.abs(em_h).max() < 1e-5

    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A1, b1, _, _, _ = assemble.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    A2, b2, _, _, _ = assemble_jax.build_discrete_problem(
        mesh, coef=1.0, rhs=1.0, ess_attr_marker=ess)
    assert abs(A1 - A2).max() < 1e-5
    np.testing.assert_allclose(b1, b2, atol=1e-12)


def test_native_stencil_assembly_matches_python():
    """The C++ slab assembly + CSR emission (native/stencil_assemble.cpp)
    reproduces the python path: identical sparsity pattern, values to
    ~1 ulp (FMA contraction), and the folded zero-Dirichlet elimination
    equals eliminate_essential_bc with x0 = 0."""
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import hex_mesh
    mesh = hex_mesh(10)
    ess_m = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(7)
    coefs = 10.0 ** rng.uniform(-2, 2, mesh.num_elements)
    A_nat, b_nat, _, _, ess = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess_m)

    e2d = mesh.elem_to_dof(1, 1)
    em0, c = assemble.diffusion_factorized(mesh, coefs)
    A_py = assemble.assemble_global_stencil_grid(
        em0, c, e2d.indices.reshape(mesh.num_elements, -1),
        mesh.grid, mesh.num_dofs(1))
    b_py = assemble.domain_lf(mesh, 1.0, 1, 1)
    A_py = assemble.eliminate_essential_bc(
        A_py, ess, np.zeros_like(b_py), b_py)
    assert A_nat.nnz == A_py.nnz
    assert np.array_equal(A_nat.indices, A_py.indices)
    assert np.array_equal(A_nat.indptr, A_py.indptr)
    assert abs(A_nat - A_py).max() <= 1e-14 * abs(A_py).max()
    assert np.abs(b_nat - b_py).max() == 0.0


def test_simplex_mass_matrices_closed_form():
    """P1 mass on tri/tet against the closed forms (mfem MassIntegrator
    uses a degree-2k rule; the 1-point centroid rule that is exact for
    P1 STIFFNESS gives a rank-1 mass — advisor-class finding)."""
    import numpy as np
    from saamge_jax.fem import assemble
    from saamge_jax.fem.mesh import Mesh

    def mk(verts, elems, et, bdr, dim):
        return Mesh(vertices=verts, elements=elems,
                    elem_attr=np.ones(len(elems), dtype=np.int64),
                    elem_type=et, boundary=bdr,
                    bdr_attr=np.ones(len(bdr), dtype=np.int64), dim=dim)

    tri = mk(np.array([[0., 0.], [1., 0.], [0., 1.]]),
             np.array([[0, 1, 2]]), "tri",
             np.array([[0, 1], [1, 2], [2, 0]]), 2)
    M = assemble.mass_element_matrices(tri)[0]
    ref = (0.5 / 12.0) * np.array([[2., 1, 1], [1, 2, 1], [1, 1, 2]])
    assert np.abs(M - ref).max() < 1e-12

    tet = mk(np.array([[0., 0, 0], [1., 0, 0], [0., 1, 0], [0., 0, 1]]),
             np.array([[0, 1, 2, 3]]), "tet", np.array([[0, 1, 2]]), 3)
    M = assemble.mass_element_matrices(tet)[0]
    ref = ((1 / 6) / 20.0) * (np.ones((4, 4)) + np.eye(4))
    assert np.abs(M - ref).max() < 1e-10


def test_nodal_dedup_anisotropic_mesh():
    """High-order nodal dedup on a strongly anisotropic hex mesh: the
    quantization tolerance must come from the SHORTEST element edge or
    distinct z-layer nodes collapse into one dof."""
    import numpy as np
    from saamge_jax.fem.mesh import hex_mesh

    mesh = hex_mesh(4, sx=1.0, sy=1.0, sz=0.02)
    nd = mesh.num_dofs(2)
    assert nd == 9 ** 3, nd            # (2*4+1)^3 distinct P2 nodes


def test_lazy_elem_mats_matches_dense_setup():
    """FactorizedElemMats (capacity memory feature): the
    lazy uniform-mesh batch indexes identically to the dense batch and
    drives the FULL setup (host AE assembly + device uniform plan) to
    the same hierarchy."""
    from saamge_jax.api import SpectralAMGSolver
    from saamge_jax.config import SolverOptions
    from saamge_jax.topology.part import partition_cartesian_3d

    mesh = hex_mesh(12)
    rng = np.random.default_rng(3)
    coef = 10.0 ** rng.uniform(-1.0, 1.0, mesh.num_elements)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A1, b1, em1, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    A2, b2, em2, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess,
        lazy_elem_mats=True)
    assert isinstance(em2, assemble.FactorizedElemMats)
    assert abs(A1 - A2).max() == 0.0
    # indexing equivalence across the consumers' access patterns
    np.testing.assert_allclose(em2[7], em1[7], rtol=1e-13)
    idx = np.array([3, 11, 5])
    np.testing.assert_allclose(em2[idx], em1[idx], rtol=1e-13)
    np.testing.assert_allclose(em2[:, 2, :], em1[:, 2, :], rtol=1e-13)
    # trailing subscripts bind to the correct axes for array/slice
    # leading indices (review finding: a length-1 rest previously
    # indexed axis 2)
    np.testing.assert_allclose(em2[idx, 2], em1[idx, 2], rtol=1e-13)
    np.testing.assert_allclose(em2[5, 1], em1[5, 1], rtol=1e-13)
    np.testing.assert_allclose(em2[2:6, 1, 3], em1[2:6, 1, 3],
                               rtol=1e-13)
    # axis binding proved with an ASYMMETRIC basis (stiffness matrices
    # are symmetric, which would mask a row/column swap)
    em0a = np.arange(9.0).reshape(3, 3)
    ca = np.array([1.0, 2.0])
    fa = assemble.FactorizedElemMats(em0a, ca, 2)
    dense_a = ca[:, None, None] * em0a
    sel = np.array([0, 1])
    np.testing.assert_allclose(fa[sel, 2], dense_a[sel, 2])
    np.testing.assert_allclose(fa[1, 0], dense_a[1, 0])
    np.testing.assert_allclose(fa[:, 1, 2], dense_a[:, 1, 2])
    assert em2.shape == em1.shape and len(em2) == len(em1)

    part = partition_cartesian_3d(mesh.elem_centers(), 3, 3, 3)
    opts = SolverOptions(num_levels=2, correct_nulspace=False)
    hier = []
    for em in (em1, em2):
        s = SpectralAMGSolver(A1, mesh, em, opts, ess_attr_marker=ess,
                              partitioning=part.copy())
        hier.append(s.ml.levels[0].tg_data)
    assert hier[0].Ac.shape == hier[1].Ac.shape
    assert abs(hier[0].Ac - hier[1].Ac).max() <= 1e-12

    # the device uniform plan factorizes without the SVD detour
    from saamge_jax.setup.device_setup import analyze_uniform
    from saamge_jax.api import geometric_partitioning, bdr_dof_flags
    rels = geometric_partitioning(A1, mesh, bdr_dof_flags(mesh, ess), 27,
                                  partitioning=part.copy())
    p1 = analyze_uniform(rels, np.asarray(em1))
    p2 = analyze_uniform(rels, em2)
    assert p1 is not None and p2 is not None
    em_r1 = np.einsum("per,rab->peab", p1.coef, p1.basis)
    em_r2 = np.einsum("per,rab->peab", p2.coef, p2.basis)
    np.testing.assert_allclose(em_r2, em_r1, rtol=1e-10, atol=1e-12)
