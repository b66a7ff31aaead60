"""VTK visualization output (GLVis analog)."""

import os

import numpy as np

from saamge_jax.api import (SpectralAMGSolver, bdr_dof_flags,
                            checkerboard_coef, geometric_partitioning)
from saamge_jax.fem import assemble, vis
from saamge_jax.fem.mesh import quad_mesh


def test_vtk_outputs(tmp_path):
    mesh = quad_mesh(8)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=checkerboard_coef, rhs=1.0, ess_attr_marker=ess)
    flags = bdr_dof_flags(mesh, ess)
    rels = geometric_partitioning(A, mesh, flags, 4)

    p1 = os.path.join(tmp_path, "parts.vtk")
    vis.save_partitioning(p1, mesh, rels.partitioning)
    p2 = os.path.join(tmp_path, "aggs.vtk")
    vis.save_aggregates(p2, mesh, rels)
    p3 = os.path.join(tmp_path, "sol.vtk")
    vis.save_solution(p3, mesh, np.linspace(0, 1, mesh.num_dofs(1)))

    for p in (p1, p2, p3):
        txt = open(p).read()
        assert txt.startswith("# vtk DataFile")
        assert "CELLS 64" in txt
    assert "SCALARS AE" in open(p2).read()

    gf = os.path.join(tmp_path, "x.gf")
    x = np.arange(5.0)
    vis.write_gridfunction(gf, x)
    np.testing.assert_allclose(vis.read_gridfunction(gf), x)


def test_glvis_socket_protocol_roundtrip(tmp_path):
    """The GLVis client speaks the reference's wire protocol
    (fem.cpp:163-276): 'solution\\n' + MFEM mesh v1.0 + GridFunction.
    A fake server captures the stream; the mesh section must round-trip
    through our own MFEM reader, and the field values must survive."""
    import socket
    import threading
    from saamge_jax.fem import glvis
    from saamge_jax.fem.mesh import quad_mesh, read_mfem_mesh

    mesh = quad_mesh(4)
    x = np.arange(mesh.num_vertices, dtype=np.float64) * 0.5

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    got = []

    def serve():
        conn, _ = srv.accept()
        buf = b""
        while True:
            d = conn.recv(65536)
            if not d:
                break
            buf += d
        got.append(buf.decode())
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    glvis.visualize_solution(mesh, x, host="127.0.0.1", port=port)
    t.join(timeout=10)
    srv.close()
    assert got, "server saw no data"
    payload = got[0]
    assert payload.startswith("solution\n")
    mesh_txt, gf_txt = payload[len("solution\n"):].split(
        "FiniteElementSpace", 1)
    mf = tmp_path / "m.mesh"
    mf.write_text(mesh_txt)
    m2 = read_mfem_mesh(str(mf))
    assert m2.num_elements == mesh.num_elements
    assert np.array_equal(m2.elements, mesh.elements)
    assert np.allclose(m2.vertices, mesh.vertices)
    assert np.array_equal(m2.boundary, mesh.boundary)
    vals = [float(v) for v in gf_txt.splitlines()
            if v and not any(c.isalpha() for c in v.split()[0][1:])
            and v[0] in "-0123456789"]
    assert np.allclose(vals, x)


def test_glvis_partitioning_l2_field():
    from saamge_jax.fem import glvis
    from saamge_jax.fem.mesh import hex_mesh
    mesh = hex_mesh(4)
    part = np.arange(mesh.num_elements) % 8
    s = glvis.mfem_gf_str(mesh, part.astype(float), l2=True)
    assert "L2_3D_P0" in s
    assert len([ln for ln in s.splitlines()
                if ln and ln[0] in "-0123456789"]) \
        >= mesh.num_elements


def test_glvis_png_quicklook(tmp_path):
    from saamge_jax.fem import glvis
    from saamge_jax.fem.mesh import hex_mesh, quad_mesh
    m2 = quad_mesh(5)
    x2 = np.linspace(0, 1, m2.num_vertices)
    p2 = tmp_path / "q.png"
    glvis.plot_png(str(p2), m2, x=x2, title="2d")
    assert p2.stat().st_size > 1000
    m3 = hex_mesh(4)
    x3 = np.linspace(0, 1, m3.num_vertices)
    p3 = tmp_path / "h.png"
    glvis.plot_png(str(p3), m3, x=x3, title="slice")
    assert p3.stat().st_size > 1000
