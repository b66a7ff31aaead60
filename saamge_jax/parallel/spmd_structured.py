"""SPMD setup -> sharded structured solve WITHOUT a controller-global
fine operator.

`spmd_ml_produce_data` decomposes the setup's plumbing per rank, but its
product was a controller-global MLData: the fine operator alone is
10.7 GB at the 33M-dof capacity point, and `compile_structured` +
`shard_structured` then build the per-device arrays from that global
CSR.  This module builds the x-slab fine-level shards of
`parallel.structured_sharded.ShardedStructured` DIRECTLY from the SPMD
rank states:

  - rank r's overlapped local rows are FULLY assembled
    (`_route_assemble`, the hypre ParCSR overlapped-assembly analog) and
    cover exactly the closed slab [r*slab, (r+1)*slab] of node planes
    when the brick partitioning's AE blocks split into whole x-layers —
    no fine-level operator value ever needs to leave its rank;
  - the weighted-l1 smoother diagonal of a slab-boundary row needs
    neighbor diagonals one plane outside, which arrive by one
    O(interface) ghost-diag exchange (ledger-accounted — the only
    cross-rank traffic here);
  - the 27 z-lane DIA offsets are closed-form from the geometry, so the
    per-device (k, local_pad, 128) value arrays fill by a direct
    scatter of each rank's CSR entries.

The coarse-level objects (tent blocks, mid brick-blocks, coarsest) are
O(N/57) and keep flowing through the standard builders from the SPMD
coarse outputs — the same agglomerate-small-levels concession hypre
makes.  Reference anchor: every level's data is rank-local
(levels.hpp:47-56, aggregates.cpp:1610-1730); tg_cycle_atb consumes
only distributed operators (tg.cpp:91-131).

Parity contract (tests/test_spmd_structured.py): the arrays equal
`shard_structured(compile_structured(ml), mesh)`'s fine shards.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from saamge_jax.ops.stencil import LANES, ROW_ALIGN, halo_rows


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def zlane_offsets(geo, nzp: int) -> np.ndarray:
    """The 27 z-lane flat-index diagonal offsets, ascending — identical
    to what DeviceDIA.try_from_csr discovers on the z-lane-permuted
    global CSR (ops/sparse.py) for a Q1 27-point stencil."""
    NXn, NYn, NZn = geo.nodes
    offs = [dx * NYn * nzp + dy * nzp + dz
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    return np.asarray(sorted(offs), dtype=np.int64)


def spmd_fine_shards(states: List, geo, ledger=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """Per-device fine-level z-lane arrays from SPMD rank states.

    Returns (vals0 (P, k, local_pad, LANES) f32,
             dinv0 (P, t_rows, LANES) f32 haloed,
             offsets (k,) int64, dims dict) — the exact arrays
    `shard_structured` slices out of the global hierarchy
    (parallel/structured_sharded.py:176-187), built without any global
    operator.  Row geometry mirrors ops/stencil.py so shapes line up."""
    ndev = len(states)
    NXn, NYn, NZn = geo.nodes
    nzp = _round_up(NZn, LANES)
    offsets = zlane_offsets(geo, nzp)
    k = len(offsets)
    off_pos = {int(o): i for i, o in enumerate(offsets)}

    prow = NYn * nzp // LANES
    assert (NXn - 1) % ndev == 0, (NXn, ndev)
    slab = (NXn - 1) // ndev
    sp1 = slab + 1
    real = sp1 * prow
    local_pad = _round_up(real, ROW_ALIGN)
    # same divmod (floor) semantics as shard_structured
    hr_need = max(abs(divmod(int(o), LANES)[0]) for o in offsets) + 1
    hr = halo_rows(offsets)
    t_rows = local_pad + 2 * hr

    NYZ = NYn * NZn

    def gid_to_zf(g):
        x, rem = np.divmod(g, NYZ)
        y, z = np.divmod(rem, NZn)
        return (x * NYn + y) * nzp + z

    # one O(interface) ghost-diagonal exchange: the weighted-l1 diag of
    # a slab-boundary row needs a_jj one plane outside the slab
    diag_of = {}
    fine_diag = {}
    for s in states:
        rr = np.repeat(np.arange(s.n_loc), np.diff(s.A.indptr))
        dpos = np.flatnonzero(s.A.indices == rr)
        dvals = np.zeros(s.n_loc)
        dvals[rr[dpos]] = s.A.data[dpos]
        fine_diag[s.rank] = dvals
        for g, v in zip(s.ldof_gid, dvals):
            diag_of[int(g)] = v

    vals0 = np.zeros((ndev, k, local_pad, LANES), np.float32)
    dinv0 = np.zeros((ndev, t_rows, LANES), np.float32)
    for d, s in enumerate(states):
        lo_flat = d * slab * prow * LANES
        gmap = np.concatenate([s.ldof_gid, s.ghost_gid]) \
            if len(s.ghost_gid) else s.ldof_gid
        A = s.A.tocoo()
        zf_r = gid_to_zf(s.ldof_gid[A.row])
        zf_c = gid_to_zf(gmap[A.col])
        doff = zf_c - zf_r
        kk = np.fromiter((off_pos[int(o)] for o in doff),
                         dtype=np.int64, count=len(doff))
        flat_l = zf_r - lo_flat
        assert (flat_l >= 0).all() and (flat_l < real * LANES).all(), \
            "rank rows must cover exactly the closed slab"
        vals0[d, kk, flat_l // LANES, flat_l % LANES] = A.data

        # weighted-l1 smoother diagonal (smoothers.weighted_l1_dinv)
        # over the rank's complete rows; ghost a_jj from the exchange
        a_jj = np.empty(len(gmap))
        a_jj[:s.n_loc] = fine_diag[s.rank]
        for i, g in enumerate(s.ghost_gid):
            a_jj[s.n_loc + i] = diag_of.get(int(g), 1.0)
        if ledger is not None and len(s.ghost_gid):
            ledger.add("fine_shard_ghost_diag", len(s.ghost_gid) * 8,
                       s.rank)
        a_ii = fine_diag[s.rank]
        assert (a_ii > 0).all(), "eliminated rows keep their diagonal"
        y = np.zeros(s.n_loc)
        np.add.at(y, A.row, np.abs(A.data) / np.sqrt(a_jj[A.col]))
        dinv_r = 1.0 / (np.sqrt(a_ii) * y)
        dz = np.zeros(real * LANES, np.float32)
        dz[gid_to_zf(s.ldof_gid) - lo_flat] = dinv_r
        dinv0[d, hr:hr + real] = dz.reshape(real, LANES)
    dims = {"nzp": nzp, "prow": prow, "sp1": sp1, "real": real,
            "local_pad": local_pad, "hr_need": hr_need, "hr": hr,
            "t_rows": t_rows}
    return vals0, dinv0, offsets, dims
