"""Live visualization: a GLVis socket client + PNG quick-look.

The reference's interactive path streams ``solution\\n<mesh><gridfunction>``
to a running GLVis server over TCP (8 functions, fem.cpp:156-430:
solutions, partitionings, per-DoF aggregate colorings).  This module
speaks the same wire protocol — point it at any GLVis (default port
19916) and the same live views work — and adds a matplotlib PNG
renderer for headless quick-look on machines where no display exists.
File-based output (ParaView VTK) stays in fem/vis.py.

Wire format notes: MFEM mesh v1.0 ASCII (the exact format
fem/mesh.read_mfem_mesh parses — the writer here round-trips through
it, asserted in tests/test_vis.py), GridFunction header with an
H1_*D_P1 collection for nodal fields and L2_*D_P0 for per-element
fields (partitioning colors, matching fem_parallel_visualize_
partitioning's elementwise coloring).
"""

from __future__ import annotations

import socket
from typing import Optional

import numpy as np

from saamge_jax.fem.mesh import Mesh

GLVIS_DEFAULT_PORT = 19916

_GEOM = {"tri": 2, "quad": 3, "tet": 4, "hex": 5}
_BDR_GEOM = {"tri": 1, "quad": 1, "tet": 2, "hex": 3}


def mfem_mesh_str(mesh: Mesh) -> str:
    """Serialize to MFEM mesh v1.0 ASCII (inverse of read_mfem_mesh)."""
    g = _GEOM[mesh.elem_type]
    bg = _BDR_GEOM[mesh.elem_type]
    out = ["MFEM mesh v1.0", "", "dimension", str(mesh.dim), ""]
    out += ["elements", str(mesh.num_elements)]
    attrs = (mesh.elem_attr if mesh.elem_attr is not None
             else np.ones(mesh.num_elements, dtype=np.int64))
    for a, row in zip(attrs, mesh.elements):
        out.append(f"{int(a)} {g} " + " ".join(str(int(v)) for v in row))
    out += ["", "boundary", str(len(mesh.boundary))]
    for a, row in zip(mesh.bdr_attr, mesh.boundary):
        out.append(f"{int(a)} {bg} " + " ".join(str(int(v))
                                                for v in row))
    out += ["", "vertices", str(len(mesh.vertices)), str(mesh.dim)]
    for v in mesh.vertices:
        out.append(" ".join(f"{x:.16g}" for x in v))
    return "\n".join(out) + "\n"


def mfem_gf_str(mesh: Mesh, x: np.ndarray, order: int = 1,
                vdim: int = 1, l2: bool = False) -> str:
    """Serialize a nodal (H1_P<order>) or per-element (L2_P0) field."""
    fec = (f"L2_{mesh.dim}D_P0" if l2
           else f"H1_{mesh.dim}D_P{order}")
    out = ["FiniteElementSpace",
           f"FiniteElementCollection: {fec}",
           f"VDim: {vdim}",
           "Ordering: 0", ""]
    out += [f"{float(v):.16g}" for v in np.asarray(x).ravel()]
    return "\n".join(out) + "\n"


def glvis_send(mesh: Mesh, x: Optional[np.ndarray] = None,
               host: str = "localhost", port: int = GLVIS_DEFAULT_PORT,
               keys: Optional[str] = None, order: int = 1,
               vdim: int = 1, l2: bool = False,
               timeout: float = 5.0) -> None:
    """Stream one view to a running GLVis server (the reference's
    socketstream send, fem.cpp:163-176).  Raises OSError when no GLVis
    is listening — callers fall back to fem/vis.py file output."""
    if x is None:
        payload = "mesh\n" + mfem_mesh_str(mesh)
    else:
        payload = ("solution\n" + mfem_mesh_str(mesh)
                   + mfem_gf_str(mesh, x, order=order, vdim=vdim, l2=l2))
    if keys:
        payload += f"keys {keys}\n"
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(payload.encode())


def visualize_solution(mesh: Mesh, x: np.ndarray, order: int = 1,
                       vdim: int = 1, **kw) -> None:
    """fem_parallel_visualize_gf analog (fem.cpp:259-276)."""
    glvis_send(mesh, x, order=order, vdim=vdim, **kw)


def visualize_partitioning(mesh: Mesh, partitioning: np.ndarray,
                           **kw) -> None:
    """fem_parallel_visualize_partitioning analog (fem.cpp:180-204):
    elementwise partition colors as an L2_P0 field."""
    glvis_send(mesh, np.asarray(partitioning, dtype=np.float64),
               l2=True, **kw)


def visualize_aggregates(mesh: Mesh, rels, order: int = 1, **kw) -> None:
    """fem_parallel_visualize_aggregates analog (fem.cpp:207-233):
    per-DoF agglomerate ids as a nodal field.  The full order-nd field is
    streamed so the declared FE space matches the value count (fem.cpp's
    aggregate view sends the whole fespace-sized function)."""
    nd = mesh.num_dofs(order)
    ae_id = np.full(nd, -1.0)
    for ae in range(rels.nparts):
        ae_id[rels.AE_to_dof.row(ae)] = ae
    glvis_send(mesh, ae_id, order=order, **kw)


# ---------------------------------------------------------------------------
# headless PNG quick-look (no GLVis server needed)


def plot_png(path: str, mesh: Mesh, x: Optional[np.ndarray] = None,
             cell_data: Optional[np.ndarray] = None,
             title: str = "") -> None:
    """Render a nodal field (2D: filled elements; 3D: middle z-slice of
    a structured grid, else vertex scatter) to a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    verts = mesh.vertices
    if mesh.dim == 2:
        from matplotlib.collections import PolyCollection
        polys = verts[mesh.elements[:, [0, 1, 2, 3]
                                    if mesh.elem_type == "quad"
                                    else [0, 1, 2]]]
        pc = PolyCollection(polys, edgecolors="none")
        if cell_data is not None:
            pc.set_array(np.asarray(cell_data, dtype=float))
        elif x is not None:
            pc.set_array(np.asarray(
                x[mesh.elements].mean(axis=1), dtype=float))
        ax.add_collection(pc)
        ax.autoscale()
        fig.colorbar(pc, ax=ax)
    else:
        grid = getattr(mesh, "grid", None)
        if grid is not None and x is not None and len(grid) == 3:
            nx, ny, nz = (g + 1 for g in grid)
            f3 = np.asarray(x[:nx * ny * nz]).reshape(nx, ny, nz)
            im = ax.imshow(f3[:, :, nz // 2].T, origin="lower")
            fig.colorbar(im, ax=ax)
        else:
            c = (np.asarray(x[:len(verts)], dtype=float)
                 if x is not None else None)
            sc = ax.scatter(verts[:, 0], verts[:, 1], c=c, s=2)
            if c is not None:
                fig.colorbar(sc, ax=ax)
    ax.set_title(title)
    ax.set_aspect("equal")
    fig.savefig(path, dpi=110)
    plt.close(fig)
