"""Host-side graph partitioning (METIS replacement).

The reference partitions the element dual graph with METIS K-way
(part.cpp:120-204) and post-fixes disconnected parts with a BFS
connected-component split (part.cpp:56-118 connectedComponents).  Partitioning
runs once per level during setup, so a host implementation is appropriate; we
use greedy graph growing with balance-constrained boundary refinement
(Fiduccia-Mattheyses style sweeps), which produces connected, balanced parts
of comparable quality for agglomeration purposes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from saamge_jax.utils.logging import sa_print
from saamge_jax.utils.tables import Table


def connected_components(partition: np.ndarray, graph: Table) -> int:
    """Split disconnected parts into separate parts, renumber compactly.

    Same contract (including the output numbering) as the reference's
    connectedComponents (part.cpp:56): modifies ``partition`` in place,
    returns the new number of parts; vertices with negative part ids are
    ignored.  Components are labeled with scipy's csgraph (C BFS) on the
    same-part subgraph, then renumbered by (part, lowest node) — identical
    to the reference's first-visit ordering."""
    import scipy.sparse as sp2
    from scipy.sparse.csgraph import connected_components as _cc

    n = graph.nrows
    if n == 0:
        return 0
    mask = partition >= 0
    rows = np.repeat(np.arange(n, dtype=np.int64), graph.row_sizes())
    cols = graph.indices
    keep = mask[rows] & mask[cols] & (partition[rows] == partition[cols])
    g = sp2.csr_matrix(
        (np.ones(int(keep.sum()), dtype=np.int8),
         (rows[keep], cols[keep])), shape=(n, n))
    ncomp, labels = _cc(g, directed=False)
    lab = labels[mask]
    nodes = np.flatnonzero(mask)
    first = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(first, lab, nodes)
    part_of_lab = np.full(ncomp, -1, dtype=np.int64)
    part_of_lab[lab] = partition[mask]
    used = np.flatnonzero(part_of_lab >= 0)
    order = used[np.lexsort((first[used], part_of_lab[used]))]
    newid = np.full(ncomp, -1, dtype=np.int64)
    newid[order] = np.arange(len(order), dtype=np.int64)
    partition[mask] = newid[lab]
    return len(order)


def _grow_parts(graph: Table, weights: np.ndarray, nparts: int,
                rng: np.random.Generator) -> np.ndarray:
    """Greedy graph growing: BFS regions up to a weight target."""
    n = graph.nrows
    part = np.full(n, -1, dtype=np.int64)
    total_w = weights.sum()
    target = total_w / nparts
    assigned = 0
    order_hint = 0
    for p in range(nparts):
        # pick seed: first unassigned vertex with fewest unassigned neighbors
        # of previously grown regions (cheap heuristic: next unassigned)
        seed = -1
        while order_hint < n:
            if part[order_hint] < 0:
                seed = order_hint
                break
            order_hint += 1
        if seed < 0:
            break
        frontier = [seed]
        part[seed] = p
        w = weights[seed]
        budget = target if p < nparts - 1 else np.inf
        while frontier and w < budget:
            nxt = []
            for i in frontier:
                for k in graph.row(i):
                    if part[k] < 0 and w < budget:
                        part[k] = p
                        w += weights[k]
                        nxt.append(k)
            frontier = nxt
    # sweep leftovers onto an adjacent part (or part 0)
    for i in range(n):
        if part[i] < 0:
            neigh = [part[k] for k in graph.row(i) if part[k] >= 0]
            part[i] = neigh[0] if neigh else 0
    return part


def _refine(graph: Table, weights: np.ndarray, part: np.ndarray,
            nparts: int, passes: int = 6, imbalance: float = 1.3) -> None:
    """Boundary-move refinement reducing edge cut under a balance cap."""
    n = graph.nrows
    part_w = np.bincount(part, weights=weights, minlength=nparts)
    max_w = imbalance * weights.sum() / nparts
    for _ in range(passes):
        moved = 0
        for i in range(n):
            pi = part[i]
            row = graph.row(i)
            if len(row) == 0:
                continue
            neigh_parts = part[row]
            if np.all(neigh_parts == pi):
                continue
            # gain of moving i to part q = (#edges to q) - (#edges to pi)
            internal = int((neigh_parts == pi).sum())
            cand, counts = np.unique(neigh_parts[neigh_parts != pi],
                                     return_counts=True)
            best = np.argsort(-counts)
            for b in best:
                q, cq = int(cand[b]), int(counts[b])
                if cq <= internal:
                    break
                if part_w[q] + weights[i] <= max_w and \
                        part_w[pi] - weights[i] > 0:
                    part[i] = q
                    part_w[q] += weights[i]
                    part_w[pi] -= weights[i]
                    moved += 1
                    break
        if moved == 0:
            break


def _partition_kway_native(graph: Table, weights: np.ndarray,
                           nparts: int, seed: int,
                           adjwgt: Optional[np.ndarray] = None
                           ) -> Optional[np.ndarray]:
    """Multilevel k-way via the C++ partitioner (native/partition.cpp) —
    the METIS_PartGraphKway analog.  Returns None if the native library is
    unavailable."""
    import ctypes

    from saamge_jax import native
    lib = native.load("partition")
    if lib is None:
        return None
    fn = lib.saamge_partition_kway
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                   ctypes.POINTER(ctypes.c_int64),
                   ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_double),
                   ctypes.c_int64, ctypes.c_double, ctypes.c_uint64,
                   ctypes.POINTER(ctypes.c_int64)]
    n = graph.nrows
    xadj = np.ascontiguousarray(graph.indptr, dtype=np.int64)
    adjncy = np.ascontiguousarray(graph.indices, dtype=np.int64)
    vwgt = np.ascontiguousarray(weights, dtype=np.float64)
    part = np.zeros(n, dtype=np.int64)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    aw = None
    if adjwgt is not None:
        aw = ptr(np.ascontiguousarray(adjwgt, dtype=np.float64),
                 ctypes.c_double)
    cut = fn(n, ptr(xadj, ctypes.c_int64), ptr(adjncy, ctypes.c_int64),
             ptr(vwgt, ctypes.c_double), aw, nparts,
             ctypes.c_double(1.1), ctypes.c_uint64(seed),
             ptr(part, ctypes.c_int64))
    if cut < 0:
        return None
    sa_print(4, "native partitioner edge cut: %d", int(cut))
    return part


def partition_kway(graph: Table, weights: Optional[np.ndarray], nparts: int,
                   seed: int = 0,
                   adjwgt: Optional[np.ndarray] = None) -> np.ndarray:
    """part_generate_partitioning analog (part.cpp:120).

    Returns an (n,) part-assignment array; the number of parts actually
    produced is partition.max()+1 after the connected-components fix, which
    the caller must read back (exactly like the reference mutating *nparts).
    """
    n = graph.nrows
    if weights is None:
        weights = np.ones(n, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    if nparts <= 1 or n <= 1:
        return np.zeros(n, dtype=np.int64)
    nparts = min(nparts, n)
    part = _partition_kway_native(graph, weights, nparts, seed, adjwgt)
    if part is None:
        rng = np.random.default_rng(seed)
        part = _grow_parts(graph, weights, nparts, rng)
        _refine(graph, weights, part, nparts)
    ncc = connected_components(part, graph)
    sa_print(3, "Desired number of partitions: %d", nparts)
    sa_print(3, "Actual number of partitions: %d", ncc)
    return part


def partition_cartesian_2d(elem_centers: np.ndarray, nx: int, ny: int,
                           bbox=None) -> np.ndarray:
    """fem_partition_cartesian_2d analog (fem.cpp:560): assign elements to
    an nx x ny Cartesian grid of boxes by element center."""
    c = np.asarray(elem_centers)
    if bbox is None:
        lo, hi = c.min(axis=0), c.max(axis=0)
    else:
        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
    span = np.maximum(hi - lo, 1e-300)
    ix = np.minimum((nx * (c[:, 0] - lo[0]) / span[0]).astype(np.int64),
                    nx - 1)
    iy = np.minimum((ny * (c[:, 1] - lo[1]) / span[1]).astype(np.int64),
                    ny - 1)
    return iy * nx + ix


def partition_cartesian_3d(elem_centers: np.ndarray, nx: int, ny: int,
                           nz: int, bbox=None) -> np.ndarray:
    """3D extension of the reference's Cartesian partitioner
    (fem_partition_cartesian_2d, fem.cpp:560): assign elements to an
    nx x ny x nz grid of bricks by element center.  On structured hex
    meshes this produces regular brick agglomerates — the structured
    fast path's partitioner (perfectly balanced, connected by
    construction, and the AE/MIS topology becomes a regular grid that
    the gather-free device formats exploit).

    Part numbering is brick-lexicographic with x slowest (matching
    hex_mesh element order): part = bx * ny * nz + by * nz + bz."""
    c = np.asarray(elem_centers)
    if bbox is None:
        lo, hi = c.min(axis=0), c.max(axis=0)
    else:
        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
    span = np.maximum(hi - lo, 1e-300)
    ix = np.minimum((nx * (c[:, 0] - lo[0]) / span[0]).astype(np.int64),
                    nx - 1)
    iy = np.minimum((ny * (c[:, 1] - lo[1]) / span[1]).astype(np.int64),
                    ny - 1)
    iz = np.minimum((nz * (c[:, 2] - lo[2]) / span[2]).astype(np.int64),
                    nz - 1)
    return (ix * ny + iy) * nz + iz


def partition_cartesian_bricks(bricks, supers) -> np.ndarray:
    """Superbrick partitioning of a brick-grid coarse level: maps the
    part (brick) ids of a partition_cartesian_3d level, numbered
    (bx*BY + by)*BZ + bz, onto an SX x SY x SZ grid of superbricks with
    the same numbering convention.  Used as ``coarse_part_override(1)``
    so the 3rd level inherits the brick structure and the coarsest
    restriction stays block-diagonal over superbricks
    (solve/structured.py build_structured_interp2; the reference's
    nested Cartesian agglomeration analog, fem.cpp:560)."""
    (BX, BY, BZ), (SX, SY, SZ) = bricks, supers
    if BX % SX or BY % SY or BZ % SZ:
        raise ValueError("supers must divide the brick grid evenly")
    sx, sy, sz = BX // SX, BY // SY, BZ // SZ
    p = np.arange(BX * BY * BZ, dtype=np.int64)
    pz = p % BZ
    py = (p // BZ) % BY
    px = p // (BY * BZ)
    return ((px // sx) * SY + (py // sy)) * SZ + (pz // sz)


def partition_identity(n: int) -> np.ndarray:
    """Identity partitioning: every element its own agglomerate
    (fem_create_partitioning_identity, fem.cpp:648)."""
    return np.arange(n, dtype=np.int64)
