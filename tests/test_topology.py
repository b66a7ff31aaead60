import numpy as np
import pytest

from saamge_jax.fem.mesh import quad_mesh, read_mesh
from saamge_jax.topology.agglomerate import (FLAG_BETWEEN_AES,
                                             create_partitioning_fine)
from saamge_jax.topology.part import connected_components, partition_kway
from saamge_jax.utils.tables import Table

TESTMESH_PARTITION = np.array([0, 0, 1, 1, 0, 0, 2, 2, 3, 3, 3, 2])


def _testmesh_rels():
    mesh = read_mesh("/root/reference/amg/test/mltest.mesh")
    import scipy.sparse as sp
    from saamge_jax.fem import assemble
    A, b, em, e2d, ess = assemble.build_discrete_problem(
        mesh, coef=1.0, ess_attr_marker=np.array([0, 0, 0, 1]))
    return mesh, create_partitioning_fine(
        A, mesh.elem_to_dof(), mesh.elem_to_elem(),
        TESTMESH_PARTITION, None, 4)


def test_testmesh_AE_tables():
    mesh, rels = _testmesh_rels()
    assert rels.nparts == 4
    # AE0 = elements {0,1,4,5}: vertices rows 0-2 cols 0-2 of the 5x4 grid
    ae0 = set(rels.AE_to_dof.row(0))
    assert ae0 == {0, 1, 2, 5, 6, 7, 10, 11, 12}
    # AE1 = elements {2,3}
    ae1 = set(rels.AE_to_dof.row(1))
    assert ae1 == {2, 3, 4, 7, 8, 9}


def test_testmesh_mises():
    mesh, rels = _testmesh_rels()
    # dofs interior to a single AE form per-AE MISes; interface dofs group by
    # identical AE membership signatures
    sig = {}
    for dof in range(rels.ND):
        key = tuple(sorted(rels.dof_to_AE.row(dof)))
        sig.setdefault(key, []).append(dof)
    assert rels.num_mises == len(sig)
    # every MIS is one signature group, dofs sorted ascending
    for mis in range(rels.num_mises):
        dofs = list(rels.mis_to_dof.row(mis))
        assert dofs == sorted(dofs)
        keys = {tuple(sorted(rels.dof_to_AE.row(d))) for d in dofs}
        assert len(keys) == 1
    # dof 7 (vertex shared by AE0 and AE1) is flagged between AEs
    assert rels.agg_flags[7] & FLAG_BETWEEN_AES


def test_mis_partition_of_dofs():
    mesh = quad_mesh(10)
    from saamge_jax.fem import assemble
    A, b, em, e2d, ess = assemble.build_discrete_problem(mesh, coef=1.0)
    rels = create_partitioning_fine(A, mesh.elem_to_dof(),
                                    mesh.elem_to_elem(), None, None, 8)
    # MISes partition the dofs
    seen = np.zeros(rels.ND, dtype=int)
    for mis in range(rels.num_mises):
        seen[rels.mis_to_dof.row(mis)] += 1
    assert (seen == 1).all()
    # mises array is consistent with mis_to_dof
    for mis in range(rels.num_mises):
        assert (rels.mises[rels.mis_to_dof.row(mis)] == mis).all()


def test_partitioner_connected_and_balanced():
    mesh = quad_mesh(20)
    e2e = mesh.elem_to_elem()
    part = partition_kway(e2e, None, 8)
    nparts = part.max() + 1
    assert nparts >= 8
    sizes = np.bincount(part)
    assert sizes.min() > 0
    # every part connected: connected_components must not split anything
    before = part.copy()
    n2 = connected_components(part, e2e)
    assert n2 == nparts
    # each AE has reasonable size (balance within 3x)
    assert sizes.max() <= 3 * max(1, 400 // 8)


def test_aggregates_mode_disjoint():
    mesh = quad_mesh(8)
    from saamge_jax.fem import assemble
    A, b, em, e2d, ess = assemble.build_discrete_problem(mesh, coef=1.0)
    rels = create_partitioning_fine(A, mesh.elem_to_dof(),
                                    mesh.elem_to_elem(), None, None, 4,
                                    do_aggregates=True)
    # aggregates partition all dofs, one aggregate per AE
    assert rels.num_mises == rels.nparts
    assert (rels.mises >= 0).all()
    assert rels.mises_size.sum() == rels.ND


def test_elem_to_elem_grid_fast_path_parity():
    """The Cartesian closed-form dual graph (Mesh._elem_to_elem_grid)
    must produce the identical Table to the generic face-matching path
    (same indptr, same within-row ascending neighbor order)."""
    import numpy as np
    from saamge_jax.fem.mesh import hex_mesh

    for dims in [(2, 3, 4), (3, 3, 3), (1, 4, 2), (4, 4, 1)]:
        m = hex_mesh(*dims)
        assert m.grid is not None
        fast = m.elem_to_elem()          # takes the grid path
        object.__setattr__(m, "grid", None)
        object.__setattr__(m, "_e2e_cache", None)
        gen = m.elem_to_elem()           # generic lexsort face matching
        assert np.array_equal(fast.indptr, gen.indptr), dims
        assert np.array_equal(fast.indices, gen.indices), dims
        assert fast.ncols == gen.ncols == m.num_elements
