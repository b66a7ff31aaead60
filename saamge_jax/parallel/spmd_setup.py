"""SPMD-decomposed setup: rank-local index plumbing + explicit exchanges.

The reference runs its ENTIRE setup distributed: elements live on MPI
ranks, every relation table / MIS structure / tentative-P block is built
from rank-local pieces, and the only cross-rank traffic is (i) the
dof->AE membership union for interface dofs (BuildGlobalDofToAE,
aggregates.cpp:660-692), (ii) overlapped-row assembly (hypre ParCSR),
(iii) the SharedEntityCommunication reduce/broadcast of per-MIS
eigenvector blocks and tentative bases (contrib.cpp:492-549,
aggregates.cpp:1610-1730), and (iv) prefix scans for global numbering
(proc_determine_offsets, process.cpp:81; contrib.cpp:684).

This module is the single-controller analog.  "Ranks" are data shards
driven sequentially by the controller; every per-rank step touches only
that rank's O(N_r + interface) arrays, and ALL cross-rank data flow is
confined to the ``_route_*`` functions (each one documents the MPI
primitive it stands in for and records its traffic in an
:class:`ExchangeLedger`).  A multi-process backend would replace the
router bodies with collectives; nothing else changes.  The controller
itself retains only O(#MISes + #AEs + coarse) global state — never a
fine-level O(N) relation table — plus one transient O(N) sort in the
rendezvous step (the assumed-partition analog, see
:func:`_route_rendezvous`).

Determinism contract (the pmltest serial/parallel-equivalence
invariant, /root/reference/amg/CMakeLists.txt:198-203): global MIS ids
are assigned by ascending minimum dof id — exactly the order the
single-host ``_construct_mises_local`` produces — and per-MIS SVD
inputs are concatenated in ascending global-AE order, so the coarse
space is independent of the rank count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from saamge_jax.setup.contrib import _pad2
from saamge_jax.setup.spectral import Eigensolver
from saamge_jax.topology.agglomerate import (FLAG_BETWEEN_AES, FLAG_ESS_BDR,
                                             FLAG_PROC_IFACE, AggPartRels,
                                             _ranges, ae_local_ids,
                                             build_AE_stiffm_with_global)
from saamge_jax.topology.part import partition_kway
from saamge_jax.utils.logging import sa_assert, sa_print
from saamge_jax.utils.tables import Table, group_rows

SVD_EPS = 1e-10  # contrib.cpp:61


# ---------------------------------------------------------------------------
# exchange ledger


@dataclasses.dataclass
class ExchangeLedger:
    """Per-phase cross-rank traffic accounting (bytes, message count, and
    the largest single rank's send volume — the number that must stay
    O(interface) for the setup to scale)."""

    phases: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)

    def add(self, phase: str, nbytes: int, src: int = -1) -> None:
        d = self.phases.setdefault(
            phase, {"bytes": 0, "msgs": 0, "max_rank_bytes": 0, "_per": {}})
        d["bytes"] += int(nbytes)
        d["msgs"] += 1
        per = d["_per"]
        per[src] = per.get(src, 0) + int(nbytes)
        d["max_rank_bytes"] = max(per.values())

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {k: {kk: vv for kk, vv in v.items() if kk != "_per"}
                for k, v in self.phases.items()}


# ---------------------------------------------------------------------------
# per-rank state


@dataclasses.dataclass
class RankState:
    """Everything one 'rank' holds: O(N_r + interface_r) arrays only."""

    rank: int
    elems: np.ndarray                 # global elem ids, ascending
    ldof_gid: np.ndarray              # (n_loc,) global dof ids, ascending
    e2d: Table                        # local elem -> local dof
    e2e: Table                        # local elem -> local elem (in-rank)
    elem_mats: np.ndarray             # (ne_r, nd, nd)
    flags: np.ndarray                 # (n_loc,) uint8 (ESS | PROC_IFACE)
    # interface
    shared_ldofs: np.ndarray = None   # local ids of rank-shared dofs
    sharers: List[Tuple[int, ...]] = None   # per shared dof: all ranks
    owner_mask: np.ndarray = None     # (n_loc,) min-rank ownership
    # AE partitioning
    part: np.ndarray = None           # local elem -> local AE
    n_ae: int = 0
    ae_goff: int = 0                  # global AE id = ae_goff + local id
    # assembled local operator (rows: n_loc, cols: n_loc + n_ghost)
    ghost_gid: np.ndarray = None
    ghost_src: np.ndarray = None      # rank that provided each ghost col
    A: sp.csr_matrix = None
    rels: AggPartRels = None          # local tables (no MIS fields)
    # global dof -> AE signatures (global AE ids), CSR over local dofs
    sig_indptr: np.ndarray = None
    sig_ids: np.ndarray = None
    # local MIS view
    n_mis: int = 0
    mis_of_dof: np.ndarray = None     # local dof -> local mis index
    mis_dofs: Table = None            # local mis -> local dofs (ascending)
    mis_min_gdof: np.ndarray = None
    mis_master: np.ndarray = None     # master rank per local mis
    mis_shared: np.ndarray = None     # bool: crosses rank boundary
    mis_gid: np.ndarray = None        # global MIS id per local mis
    # spectral data
    cut_evects: List[np.ndarray] = None     # per local AE
    skipped: List[float] = None
    ae_stiffm: List[np.ndarray] = None      # cached AE stiffness (per AE,
                                            # the interp_data.AEs_stiffm
                                            # analog)
    # tentative data (per local mis, broadcast from masters)
    mis_ncd: np.ndarray = None
    mis_basis: List[np.ndarray] = None
    mis_coff: np.ndarray = None       # global coarse dof offset per local mis
    peak_bytes: int = 0

    @property
    def n_loc(self) -> int:
        return len(self.ldof_gid)

    def _account(self) -> None:
        b = 0
        if isinstance(self.elem_mats, np.ndarray):
            b += self.elem_mats.nbytes
        elif self.elem_mats is not None:
            b += sum(m.size * 8 for m in self.elem_mats)
        for f in (self.ldof_gid, self.flags, self.part,
                  self.ghost_gid, self.sig_indptr, self.sig_ids,
                  self.mis_of_dof, self.mis_min_gdof, self.mis_gid):
            if f is not None:
                b += f.nbytes
        for t in (self.e2d, self.e2e, self.mis_dofs):
            if t is not None:
                b += t.indptr.nbytes + t.indices.nbytes
        if self.A is not None:
            b += self.A.data.nbytes + self.A.indices.nbytes \
                + self.A.indptr.nbytes
        if self.rels is not None:
            for t in (self.rels.AE_to_dof, self.rels.dof_to_AE,
                      self.rels.AE_to_elem):
                b += t.indptr.nbytes + t.indices.nbytes
        if self.cut_evects is not None:
            b += sum(c.nbytes for c in self.cut_evects if c is not None)
        if self.ae_stiffm is not None:
            b += sum(m.nbytes for m in self.ae_stiffm
                     if isinstance(m, np.ndarray))
        self.peak_bytes = max(self.peak_bytes, b)


# ---------------------------------------------------------------------------
# phase 0: slice the problem onto ranks


def rank_blocks_from_partitioning(partitioning: np.ndarray,
                                  n_ranks: int) -> np.ndarray:
    """elem -> rank from a global AE partitioning: contiguous AE-id blocks
    balanced by element count (so global AE ids stay rank-major, the
    layout proc_determine_offsets produces)."""
    partitioning = np.asarray(partitioning, dtype=np.int64)
    n_ae = int(partitioning.max()) + 1
    if n_ranks > n_ae:
        raise ValueError(f"n_ranks={n_ranks} exceeds the {n_ae} AEs")
    counts = np.bincount(partitioning, minlength=n_ae)
    # block boundaries at the element-count quantiles, forced strictly
    # increasing (and leaving room at the tail) so EVERY rank gets at
    # least one AE
    cum = np.cumsum(counts)
    bounds = np.searchsorted(
        cum, cum[-1] * (np.arange(1, n_ranks) / n_ranks)) + 1
    lo = np.arange(1, n_ranks)
    hi = n_ae - n_ranks + np.arange(1, n_ranks)
    bounds = np.clip(bounds, lo, hi)
    ae_rank = np.zeros(n_ae, dtype=np.int64)
    ae_rank[bounds.astype(np.int64)] = 1
    ae_rank = np.cumsum(ae_rank)
    return ae_rank[partitioning]


def make_rank_states(e2d_global: Table, e2e_global: Table,
                     elem_mats: np.ndarray, bdr_flags: np.ndarray,
                     elem_rank: np.ndarray, n_ranks: int) -> List[RankState]:
    """Slice the problem definition (mesh connectivity + element matrices
    + boundary flags — what each MPI rank reads from its mesh piece)
    onto ranks.  Local dofs are the dofs of local elements, ascending by
    global id; interface dofs are replicated (the overlapped-dof model,
    SURVEY §2.2 item 2)."""
    elem_rank = np.asarray(elem_rank, dtype=np.int64)
    states: List[RankState] = []
    epos = np.full(e2e_global.nrows, -1, dtype=np.int64)
    for r in range(n_ranks):
        elems = np.flatnonzero(elem_rank == r)
        sel = _concat_ranges(e2d_global.indptr, elems)
        gd = e2d_global.indices[sel]
        ldof_gid = np.unique(gd)
        # local elem_to_dof preserving within-row order (vectorized)
        lens = e2d_global.indptr[elems + 1] - e2d_global.indptr[elems]
        indptr = np.zeros(len(elems) + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        e2d = Table(indptr, np.searchsorted(ldof_gid, gd),
                    len(ldof_gid))
        # in-rank element adjacency (cross-rank edges handled separately)
        epos[elems] = np.arange(len(elems))
        nsel = _concat_ranges(e2e_global.indptr, elems)
        nb = e2e_global.indices[nsel]
        nlens = e2e_global.indptr[elems + 1] - e2e_global.indptr[elems]
        rows_of = np.repeat(np.arange(len(elems), dtype=np.int64), nlens)
        keep = elem_rank[nb] == r
        kcounts = np.bincount(rows_of[keep], minlength=len(elems))
        kindptr = np.zeros(len(elems) + 1, dtype=np.int64)
        np.cumsum(kcounts, out=kindptr[1:])
        e2e = Table(kindptr, epos[nb[keep]], len(elems))
        if isinstance(elem_mats, np.ndarray) and elem_mats.ndim == 3:
            em_r = np.ascontiguousarray(elem_mats[elems])
        else:
            em_r = [elem_mats[int(e)] for e in elems]   # ragged (coarse)
        st = RankState(
            rank=r, elems=elems, ldof_gid=ldof_gid, e2d=e2d, e2e=e2e,
            elem_mats=em_r,
            flags=np.asarray(bdr_flags, dtype=np.uint8)[ldof_gid].copy())
        st._account()
        states.append(st)
    return states


def _concat_ranges(indptr: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Concatenated index ranges of the selected CSR rows (delegates to
    topology.agglomerate._ranges)."""
    return _ranges(indptr[rows], indptr[rows + 1] - indptr[rows])


# ---------------------------------------------------------------------------
# phase 1: rendezvous — which dofs are shared, by whom, who owns them


def _route_rendezvous(states: List[RankState],
                      ledger: ExchangeLedger) -> None:
    """Stand-in for the Dof_TrueDof construction (hypre assumed-partition
    rendezvous): each rank announces its dof gids; dofs announced by >1
    rank get their sharer list sent back to every sharer.  The router
    performs one transient O(sum N_r) sort and retains nothing."""
    pairs_r = np.concatenate([np.full(s.n_loc, s.rank, dtype=np.int64)
                              for s in states])
    pairs_g = np.concatenate([s.ldof_gid for s in states])
    for s in states:
        ledger.add("rendezvous", s.ldof_gid.nbytes, s.rank)
    order = np.argsort(pairs_g, kind="stable")   # stable => rank ascending
    g = pairs_g[order]
    r = pairs_r[order]
    # group boundaries
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    counts = np.diff(np.r_[starts, len(g)])
    shared_sel = counts > 1
    # per shared dof: tuple of sharer ranks (ascending)
    shared_starts = starts[shared_sel]
    shared_counts = counts[shared_sel]
    shared_gids = g[shared_starts]
    sharers = [tuple(int(x) for x in r[s0:s0 + c])
               for s0, c in zip(shared_starts, shared_counts)]
    owner = np.array([sh[0] for sh in sharers], dtype=np.int64)
    for s in states:
        pos = np.searchsorted(shared_gids, s.ldof_gid)
        pos = np.clip(pos, 0, max(len(shared_gids) - 1, 0))
        is_sh = np.zeros(s.n_loc, dtype=bool)
        if len(shared_gids):
            is_sh = shared_gids[pos] == s.ldof_gid
        s.shared_ldofs = np.flatnonzero(is_sh)
        s.sharers = [sharers[int(pos[l])] for l in s.shared_ldofs]
        s.owner_mask = np.ones(s.n_loc, dtype=bool)
        if len(shared_gids):
            own = np.ones(s.n_loc, dtype=bool)
            own[s.shared_ldofs] = owner[pos[s.shared_ldofs]] == s.rank
            s.owner_mask = own
        s.flags[s.shared_ldofs] |= FLAG_PROC_IFACE
        ledger.add("rendezvous",
                   len(s.shared_ldofs) * 16, s.rank)
        s._account()


# ---------------------------------------------------------------------------
# phase 2: rank-local AE partitioning + global AE numbering


def partition_ranks_local(states: List[RankState],
                          global_partitioning: Optional[np.ndarray],
                          elems_per_agg: int,
                          ledger: ExchangeLedger, seed: int = 0,
                          weights_global: Optional[np.ndarray] = None
                          ) -> None:
    """Each rank partitions ITS elements into agglomerates (the reference
    runs METIS per rank on the local dual graph, part.cpp:120); global AE
    ids by prefix scan over ranks (proc_determine_offsets,
    process.cpp:81).  ``weights_global``: per-element weights (coarse
    levels weight by AE dof counts, aggregates.cpp:1797)."""
    goff = 0
    uniqs = {}
    for s in states:
        if global_partitioning is not None:
            loc = np.asarray(global_partitioning, dtype=np.int64)[s.elems]
            uniq, inv = np.unique(loc, return_inverse=True)
            s.part = inv.astype(np.int64)
            s.n_ae = len(uniq)
            uniqs[s.rank] = uniq
        else:
            nparts = max(1, int(round(len(s.elems) / elems_per_agg)))
            if nparts == 1:
                s.part = np.zeros(len(s.elems), dtype=np.int64)
            else:
                # strip self-loops for the partitioner (coarse dual
                # graphs carry them)
                ii = np.repeat(np.arange(s.e2e.nrows, dtype=np.int64),
                               s.e2e.row_sizes())
                keep = s.e2e.indices != ii
                cnt = np.bincount(ii[keep], minlength=s.e2e.nrows)
                iptr = np.zeros(s.e2e.nrows + 1, dtype=np.int64)
                np.cumsum(cnt, out=iptr[1:])
                g = Table(iptr, s.e2e.indices[keep], s.e2e.ncols)
                w = None if weights_global is None else \
                    np.asarray(weights_global,
                               dtype=np.float64)[s.elems]
                s.part = partition_kway(g, w, nparts, seed=seed)
            s.n_ae = int(s.part.max()) + 1
        s.ae_goff = goff
        goff += s.n_ae                     # MPI_Scan analog
        ledger.add("ae_scan", 8, s.rank)
    if global_partitioning is not None:
        # contract: the caller's AE numbering must be rank-major so the
        # prefix-scan ids coincide with it (rank_blocks_from_partitioning
        # guarantees this)
        for s in states:
            uniq = uniqs[s.rank]
            sa_assert(1, bool((uniq == np.arange(s.ae_goff,
                                                 s.ae_goff + s.n_ae)).all()),
                      "global partitioning is not rank-major; "
                      "renumber with rank_blocks_from_partitioning")


# ---------------------------------------------------------------------------
# phase 3: dof -> AE membership union for interface dofs


def _route_dof_ae_union(states: List[RankState],
                        ledger: ExchangeLedger) -> None:
    """BuildGlobalDofToAE analog (aggregates.cpp:660-692): every rank
    sends, for each of its interface dofs, its local AE memberships
    (as global AE ids); each sharer receives the union.  Interior dofs
    never travel."""
    # local dof -> local AE table first (also feeds the local rels)
    for s in states:
        AE_to_elem = Table.from_partition(s.part, s.n_ae)
        AE_to_dof = AE_to_elem.mult(s.e2d)
        dof_to_AE = AE_to_dof.transpose()
        s.rels = AggPartRels(
            nparts=s.n_ae, ND=s.n_loc, partitioning=s.part,
            elem_to_dof=s.e2d, dof_to_elem=s.e2d.transpose(),
            elem_to_elem=s.e2e, AE_to_elem=AE_to_elem,
            elem_to_AE=AE_to_elem.transpose(), AE_to_dof=AE_to_dof,
            dof_to_AE=dof_to_AE,
            dof_id_inAE=np.zeros(dof_to_AE.nnz, dtype=np.int64),
            agg_flags=s.flags)          # updated in place later
    # route interface memberships through the rendezvous keys
    msgs: Dict[int, Dict[int, np.ndarray]] = {}   # gdof -> rank -> gae list
    for s in states:
        d2ae = s.rels.dof_to_AE
        for l in s.shared_ldofs:
            gaes = d2ae.row(int(l)) + s.ae_goff
            msgs.setdefault(int(s.ldof_gid[l]), {})[s.rank] = gaes
            ledger.add("dof_ae_union", gaes.nbytes, s.rank)
    for s in states:
        d2ae = s.rels.dof_to_AE
        rows: List[np.ndarray] = [None] * s.n_loc
        for i, l in enumerate(s.shared_ldofs):
            per = msgs[int(s.ldof_gid[l])]
            rows[int(l)] = np.sort(np.concatenate(list(per.values())))
        indptr = np.zeros(s.n_loc + 1, dtype=np.int64)
        chunks = []
        for l in range(s.n_loc):
            row = rows[l]
            if row is None:
                row = d2ae.row(l) + s.ae_goff
            chunks.append(row)
            indptr[l + 1] = indptr[l] + len(row)
        s.sig_indptr = indptr
        s.sig_ids = np.concatenate(chunks) if chunks else \
            np.zeros(0, dtype=np.int64)
        # BETWEEN_AES now globally correct (>=2 AEs in the union)
        between = np.diff(indptr) > 1
        s.flags[between] |= FLAG_BETWEEN_AES
        s._account()


# ---------------------------------------------------------------------------
# phase 4: MIS identification + global numbering


def _route_mis_identify(states: List[RankState],
                        ledger: ExchangeLedger) -> Tuple[int, np.ndarray]:
    """agg_construct_mises_local/parallel analog: each rank groups its
    dofs by AE signature; cross-rank MISes are unified by signature; the
    router assigns global ids by ascending minimum dof id (the
    single-host ordering — SortByTrueDof determinism, aggregates.cpp:271)
    and returns num_mises."""
    records = []   # (min_gdof, size, rank, local mis id, shared?)
    for s in states:
        sizes = np.diff(s.sig_indptr)
        maxm = int(sizes.max()) if s.n_loc else 1
        sig = np.full((s.n_loc, maxm), -1, dtype=np.int64)
        rows_idx = np.repeat(np.arange(s.n_loc, dtype=np.int64), sizes)
        cols_idx = np.arange(s.sig_indptr[-1], dtype=np.int64) \
            - np.repeat(s.sig_indptr[:-1], sizes)
        sig[rows_idx, cols_idx] = s.sig_ids
        inverse, num = group_rows(sig)
        first_dof = np.full(num, s.n_loc, dtype=np.int64)
        np.minimum.at(first_dof, inverse, np.arange(s.n_loc, dtype=np.int64))
        # local mis order: ascending min local dof (== ascending min gdof)
        rank_order = np.empty(num, dtype=np.int64)
        rank_order[np.argsort(first_dof, kind="stable")] = np.arange(num)
        mis_of_dof = rank_order[inverse]
        s.n_mis = num
        s.mis_of_dof = mis_of_dof
        s.mis_dofs = Table.from_pairs(mis_of_dof,
                                      np.arange(s.n_loc, dtype=np.int64),
                                      num, s.n_loc)
        s.mis_min_gdof = s.ldof_gid[first_dof[np.argsort(rank_order,
                                                         kind="stable")]]
        # a MIS is shared iff its dofs are shared (all of its dofs have
        # the same sharer set); masters = min sharer rank
        shared_mask = np.zeros(s.n_loc, dtype=bool)
        shared_mask[s.shared_ldofs] = True
        first_l = np.array([s.mis_dofs.row(m)[0] for m in range(num)],
                           dtype=np.int64)
        s.mis_shared = shared_mask[first_l]
        master = np.full(num, s.rank, dtype=np.int64)
        sh_pos = {int(l): i for i, l in enumerate(s.shared_ldofs)}
        for m in np.flatnonzero(s.mis_shared):
            master[m] = s.sharers[sh_pos[int(first_l[m])]][0]
        s.mis_master = master
        for m in range(num):
            records.append((int(s.mis_min_gdof[m]),
                            int(s.mis_dofs.row_size(m)),
                            s.rank, m, bool(s.mis_shared[m])))
        ledger.add("mis_identify", 24 * num, s.rank)
    # global ids: unique MISes keyed by min gdof (a dof belongs to exactly
    # one MIS, so min-gdof identifies the MIS across ranks)
    recs = sorted(records)
    gid = -1
    last_min = -1
    mis_sizes = []
    for min_g, size, r, m, shared in recs:
        if min_g != last_min:
            gid += 1
            last_min = min_g
            mis_sizes.append(size)
        else:
            sa_assert(1, size == mis_sizes[-1],
                      "cross-rank MIS size mismatch")
        states[r].mis_gid = states[r].mis_gid \
            if states[r].mis_gid is not None \
            else np.full(states[r].n_mis, -1, dtype=np.int64)
        states[r].mis_gid[m] = gid
    num_mises = gid + 1
    for s in states:
        sa_assert(1, bool((s.mis_gid >= 0).all()), "unnumbered MIS")
        ledger.add("mis_identify", 8 * s.n_mis, s.rank)
        s._account()
    return num_mises


# ---------------------------------------------------------------------------
# phase 5: overlapped-row assembly + local BC elimination


def _route_assemble(states: List[RankState], ledger: ExchangeLedger) -> None:
    """hypre ParCSR overlapped assembly analog: each rank scatter-adds its
    element matrices locally, then ships its partial rows for INTERFACE
    dofs to the co-sharers; every rank ends up with fully-assembled rows
    for all of its (overlapped) dofs, with off-rank columns appended as
    ghost columns.  Dirichlet elimination (keep_diag) runs locally after
    the sum — identical values to eliminating the global matrix."""
    partials: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]]
    partials = {}
    local_coo = {}
    for s in states:
        sa_assert(1, isinstance(s.elem_mats, np.ndarray)
                  and s.elem_mats.ndim == 3,
                  "fine-level assembly needs a rectangular element batch "
                  "(ragged inputs only arise on coarse recursion, which "
                  "uses A_rows)")
        NE, nd, _ = s.elem_mats.shape
        dofs = s.e2d.indices.reshape(NE, nd)
        rows = np.repeat(dofs, nd, axis=1).ravel()
        cols = np.tile(dofs, (1, nd)).ravel()
        vals = s.elem_mats.reshape(-1).astype(np.float64)
        local_coo[s.rank] = (rows, cols, vals)
        # partial interface rows -> co-sharers
        sh_mask = np.zeros(s.n_loc, dtype=bool)
        sh_mask[s.shared_ldofs] = True
        sel = sh_mask[rows]
        gr = s.ldof_gid[rows[sel]]
        gc = s.ldof_gid[cols[sel]]
        gv = vals[sel]
        fl = s.flags[cols[sel]] & FLAG_ESS_BDR   # col ess bit travels along
        for dst in {r for sh in s.sharers for r in sh if r != s.rank}:
            # send only the rows this dst also shares
            dst_set = {int(s.ldof_gid[l])
                       for l, sh in zip(s.shared_ldofs, s.sharers)
                       if dst in sh}
            m = np.isin(gr, np.fromiter(dst_set, dtype=np.int64,
                                        count=len(dst_set)))
            if not m.any():
                continue
            partials.setdefault(dst, {})[s.rank] = \
                (gr[m], gc[m], gv[m], fl[m])
            ledger.add("assembly_halo", int(m.sum()) * 25, s.rank)
    for s in states:
        rows, cols, vals = local_coo[s.rank]
        ess_col = (s.flags[cols] & FLAG_ESS_BDR) != 0
        add_r = [rows]
        add_c = [cols]
        add_v = [vals]
        add_e = [ess_col]
        ghost_gid: List[int] = []
        ghost_of: Dict[int, int] = {}
        ghost_src: List[int] = []
        for src in sorted(partials.get(s.rank, {})):
            gr, gc, gv, fl = partials[s.rank][src]
            lr = np.searchsorted(s.ldof_gid, gr)
            # map cols: local where known, else ghost
            pos = np.searchsorted(s.ldof_gid, gc)
            pos_c = np.clip(pos, 0, s.n_loc - 1)
            is_loc = s.ldof_gid[pos_c] == gc
            lc = np.where(is_loc, pos_c, -1)
            for i in np.flatnonzero(~is_loc):
                g = int(gc[i])
                if g not in ghost_of:
                    ghost_of[g] = s.n_loc + len(ghost_gid)
                    ghost_gid.append(g)
                    ghost_src.append(src)
                lc[i] = ghost_of[g]
            add_r.append(lr)
            add_c.append(lc)
            add_v.append(gv)
            e = np.where(is_loc, (s.flags[pos_c] & FLAG_ESS_BDR) != 0,
                         fl != 0)
            add_e.append(e)
        n_ext = s.n_loc + len(ghost_gid)
        rows = np.concatenate(add_r)
        cols = np.concatenate(add_c)
        vals = np.concatenate(add_v)
        essc = np.concatenate(add_e)
        A = sp.coo_matrix((vals, (rows, cols)),
                          shape=(s.n_loc, n_ext)).tocsr()
        A.sort_indices()
        # Dirichlet elimination, keep_diag, x0 = 0 (pattern preserved —
        # mfem Finalize(0) + EliminateEssentialBCFromDofs semantics)
        ess_row = (s.flags & FLAG_ESS_BDR) != 0
        # column ess flags: scatter what we know (local + travelled bits)
        ext_ess = np.zeros(n_ext, dtype=bool)
        ext_ess[cols] = essc
        diag = np.zeros(s.n_loc)
        rr = np.repeat(np.arange(s.n_loc), np.diff(A.indptr))
        dpos = np.flatnonzero(A.indices == rr)
        sa_assert(1, len(dpos) == s.n_loc,
                  "assembled local row missing its diagonal")
        diag[rr[dpos]] = A.data[dpos]
        kill = ess_row[rr] | ext_ess[A.indices]
        A.data[kill] = 0.0
        A.data[dpos[ess_row[rr[dpos]]]] = diag[ess_row[rr[dpos]]]
        s.A = A
        s.ghost_gid = np.asarray(ghost_gid, dtype=np.int64)
        s.ghost_src = np.asarray(ghost_src, dtype=np.int64)
        # extend the local rels to the ghost-augmented width so the AE
        # extraction's column scans stay in bounds
        s.rels.ND = n_ext
        flags_ext = np.zeros(n_ext, dtype=np.uint8)
        flags_ext[:s.n_loc] = s.flags
        flags_ext[s.n_loc:][ext_ess[s.n_loc:]] |= FLAG_ESS_BDR
        s.rels.agg_flags = flags_ext
        s.flags = flags_ext[:s.n_loc]
        s._account()


def _route_coarse_rows(states: List[RankState], A_global: sp.csr_matrix,
                       ledger: ExchangeLedger) -> None:
    """Coarse-level analog of the overlapped-row assembly: the previous
    coarsening's distributed RAP output is redistributed so each rank
    holds the fully-assembled rows of its (overlapped) local dofs with
    off-rank columns as ghosts — the hypre RAP-output row layout.  (The
    router plays the owner-exchange; traffic is metered per rank.)
    No Dirichlet elimination: coarse operators carry no essential dofs
    (the fine elimination is inherited through the Galerkin product)."""
    owner_of = _owner_map(states)
    for s in states:
        sub = A_global[s.ldof_gid]
        cols_g = sub.indices
        pos = np.searchsorted(s.ldof_gid, cols_g)
        pos_c = np.clip(pos, 0, s.n_loc - 1)
        is_loc = s.ldof_gid[pos_c] == cols_g
        ghost_gid, inv = np.unique(cols_g[~is_loc], return_inverse=True)
        lc = np.where(is_loc, pos_c, 0)
        lc[~is_loc] = s.n_loc + inv
        n_ext = s.n_loc + len(ghost_gid)
        s.A = sp.csr_matrix((sub.data.copy(), lc, sub.indptr.copy()),
                            shape=(s.n_loc, n_ext))
        s.A.sort_indices()
        s.ghost_gid = ghost_gid
        # ghost rows live on their owners (min-rank rule — every dof
        # is local somewhere; the rendezvous didn't see these dofs
        # because they are not local here)
        s.ghost_src = owner_of[ghost_gid]
        ledger.add("coarse_rows", sub.data.nbytes + sub.indices.nbytes,
                   s.rank)
        s.rels.ND = n_ext
        flags_ext = np.zeros(n_ext, dtype=np.uint8)
        flags_ext[:s.n_loc] = s.flags
        s.rels.agg_flags = flags_ext
        s._account()


def _owner_map(states: List[RankState]) -> np.ndarray:
    """gdof -> owner rank (minimum rank holding the dof locally)."""
    N = max(int(s.ldof_gid[-1]) for s in states) + 1
    owner = np.full(N, np.iinfo(np.int64).max, dtype=np.int64)
    for s in reversed(states):          # ascending rank wins
        owner[s.ldof_gid] = np.minimum(owner[s.ldof_gid], s.rank)
    return owner


# ---------------------------------------------------------------------------
# phase 6: AE stiffness + local eigensolves (rank-local, batched on device
# when a mesh is provided)


def rank_spectral(states: List[RankState], theta: float,
                  use_truncated: bool = True, setup_mesh=None,
                  ae_local_assembly: bool = False) -> None:
    """The setup hot loop, per rank (interp_compute_vectors,
    interp.cpp:342): AE stiffness by global-matrix extraction with
    interface re-assembly, then the theta-cut eigensolve.

    With ``setup_mesh`` the eigensolves run as ONE mesh-sharded batched
    device solve with the batch ordered rank-major, so each rank's AEs
    land on its shard — the owner-computes compute placement on top of
    the rank-local assembly (SURVEY §2.2 item 5).

    ``ae_local_assembly``: coarse levels assemble the AE matrix purely
    from (coarse) element matrices (agg_build_AE_stiffm,
    aggregates.cpp:959 / ElementMatrixParallelCoarse) instead of the
    global-extraction + interface-reassembly recipe of the fine level."""
    from saamge_jax.topology.agglomerate import build_AE_stiffm_local

    def build_one(s, p):
        if ae_local_assembly:
            return build_AE_stiffm_local(p, s.rels, s.elem_mats,
                                         sparse_out=False)
        return build_AE_stiffm_with_global(s.A, p, s.rels, s.elem_mats)

    if setup_mesh is not None:
        from saamge_jax.ops.batched_eig import batched_spectral_cut
        mats = []
        for s in states:
            s.ae_stiffm = [build_one(s, p) for p in range(s.n_ae)]
            mats.extend(s.ae_stiffm)
        cut, skipped, _bd = batched_spectral_cut(
            mats, theta, use_truncated=use_truncated, mesh=setup_mesh)
        k = 0
        for s in states:
            s.cut_evects = cut[k:k + s.n_ae]
            s.skipped = skipped[k:k + s.n_ae]
            k += s.n_ae
            s._account()
        return
    for s in states:
        eig = Eigensolver(use_truncated=use_truncated)
        s.cut_evects = []
        s.skipped = []
        s.ae_stiffm = []
        for p in range(s.n_ae):
            A_T = build_one(s, p)
            s.ae_stiffm.append(A_T)
            evects, skipped, _B = eig.solve(A_T, theta)
            s.cut_evects.append(evects)
            s.skipped.append(skipped)
        s._account()


# ---------------------------------------------------------------------------
# phase 7-8: SEC reduce -> master SVD -> numbering scan -> broadcast


def _route_tentative(states: List[RankState], num_mises: int,
                     avoid_ess_bdr_dofs: bool, svd_eps: float,
                     ledger: ExchangeLedger, svd_fn=None):
    """SharedEntityCommunication reduce + owner SVD + broadcast
    (contrib.cpp:492-716): per MIS, every sharer restricts its AEs' kept
    eigenvectors to the MIS dofs and sends the block to the MIS master;
    the master concatenates in ascending global-AE order, zeroes
    essential rows, normalizes, and runs the bucketed padded SVD
    (identical math to contrib.build_tentative); the resulting basis and
    coarse-dof count are broadcast back to the sharers.  Coarse dofs are
    numbered by a prefix scan over global MIS ids (contrib.cpp:684).

    Returns (mis_numcoarsedof, offsets, masters_basis: gid -> (gdofs,
    basis)) for the router-side global assembly of P."""
    # --- reduce: blocks to masters, keyed by global mis id
    inbox: Dict[int, Dict[int, List[Tuple[int, np.ndarray]]]] = {}
    for s in states:
        for m in range(s.n_mis):
            master = int(s.mis_master[m])
            dofs_l = s.mis_dofs.row(m)
            blocks = []
            for gae in s.sig_ids[s.sig_indptr[dofs_l[0]]:
                                 s.sig_indptr[dofs_l[0] + 1]]:
                gae = int(gae)
                if not (s.ae_goff <= gae < s.ae_goff + s.n_ae):
                    continue            # AE lives on another sharer
                lae = gae - s.ae_goff
                loc = ae_local_ids(s.rels, dofs_l, np.full(len(dofs_l),
                                                           lae,
                                                           dtype=np.int64))
                sa_assert(1, bool((loc >= 0).all()), "MIS dof not in AE")
                blocks.append((gae, s.cut_evects[lae][loc, :]))
            gid = int(s.mis_gid[m])
            dst = inbox.setdefault(gid, {})
            dst[s.rank] = blocks
            if master != s.rank:
                ledger.add("sec_reduce",
                           sum(b.nbytes for _, b in blocks), s.rank)
    # --- master-side SVD (bucketed padded, contrib._batched_svd_bases
    # semantics) — grouped per master rank
    mis_ncd = np.zeros(num_mises, dtype=np.int64)
    masters_out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for s in states:
        owned = [m for m in range(s.n_mis) if s.mis_master[m] == s.rank]
        # bucket by padded shape
        items = []
        for m in owned:
            gid = int(s.mis_gid[m])
            dofs_l = s.mis_dofs.row(m)
            gdofs = s.ldof_gid[dofs_l]
            ess = (s.flags[dofs_l] & FLAG_ESS_BDR) != 0
            if avoid_ess_bdr_dofs and bool(ess.all()):
                masters_out[gid] = (gdofs, np.zeros((len(dofs_l), 0)))
                continue
            if len(dofs_l) == 1:
                masters_out[gid] = (gdofs, np.ones((1, 1)))
                mis_ncd[gid] = 1
                continue
            blocks = []
            for rnk in sorted(inbox.get(gid, {})):
                blocks.extend(inbox[gid][rnk])
            blocks.sort(key=lambda t: t[0])     # ascending global AE id
            Mblk = np.concatenate([b for _, b in blocks], axis=1) \
                if blocks else np.zeros((len(dofs_l), 0))
            if Mblk.shape[1] == 0:
                sa_print(5, "WARNING: completely zero contribution on "
                            "mis %d!", gid)
                masters_out[gid] = (gdofs, np.zeros((len(dofs_l), 0)))
                continue
            items.append((gid, gdofs, ess, Mblk))
        buckets: Dict[Tuple[int, int], List] = {}
        for it in items:
            key = (_pad2(it[3].shape[0]), _pad2(it[3].shape[1]))
            buckets.setdefault(key, []).append(it)
        for (spad, cpad), its in sorted(buckets.items()):
            M = np.zeros((len(its), spad, cpad))
            for b, (gid, gdofs, ess, Mblk) in enumerate(its):
                M[b, :Mblk.shape[0], :Mblk.shape[1]] = Mblk
                if avoid_ess_bdr_dofs:
                    M[b, :len(ess), :][ess, :] = 0.0
            nrm = np.linalg.norm(M, axis=1, keepdims=True)
            M = np.divide(M, np.where(nrm > 0.0, nrm, 1.0))
            if svd_fn is None:
                U, S, _ = np.linalg.svd(M, full_matrices=False)
                eps_use = svd_eps
            else:
                # mesh-sharded owner-computes SVD (dist_setup.py): the
                # master's bucket is factored with the batch dimension
                # sharded over the device mesh
                U, S = svd_fn(M)
                eps_use = max(svd_eps,
                              getattr(svd_fn, "suggested_eps", 0.0))
            s0 = S[:, :1]
            k_arr = ((S > eps_use * s0) & (s0 > 0.0)).sum(axis=1)
            for b, (gid, gdofs, ess, Mblk) in enumerate(its):
                k = int(k_arr[b])
                if k == 0:
                    sa_print(5, "WARNING: completely zero contribution "
                                "on mis %d!", gid)
                    masters_out[gid] = (gdofs,
                                        np.zeros((len(gdofs), 0)))
                    continue
                basis = np.ascontiguousarray(U[b, :len(gdofs), :k])
                masters_out[gid] = (gdofs, basis)
                mis_ncd[gid] = k
    # --- numbering scan (global mis order == single-host order)
    offsets = np.zeros(num_mises + 1, dtype=np.int64)
    np.cumsum(mis_ncd, out=offsets[1:])
    # --- broadcast to sharers
    for s in states:
        s.mis_ncd = np.zeros(s.n_mis, dtype=np.int64)
        s.mis_coff = np.zeros(s.n_mis, dtype=np.int64)
        s.mis_basis = [None] * s.n_mis
        for m in range(s.n_mis):
            gid = int(s.mis_gid[m])
            gdofs, basis = masters_out[gid]
            s.mis_ncd[m] = mis_ncd[gid]
            s.mis_coff[m] = offsets[gid]
            s.mis_basis[m] = basis
            if s.mis_master[m] != s.rank:
                ledger.add("sec_broadcast", basis.nbytes + 16,
                           int(s.mis_master[m]))
        s._account()
    return mis_ncd, offsets, masters_out


# ---------------------------------------------------------------------------
# phase 9: rank-local P rows + distributed RAP


def _p_rows_csr(s: RankState, NC: int) -> sp.csr_matrix:
    """Tentative-P rows of the rank's local dofs (vectorized from the
    broadcast MIS bases; exact zeros dropped, matching
    contrib_tent_insert_simple)."""
    m_of = s.mis_of_dof
    ncd_d = s.mis_ncd[m_of]                       # per local dof
    counts = np.bincount(m_of, minlength=s.n_mis)
    starts = np.zeros(s.n_mis, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    order = np.argsort(m_of, kind="stable")
    pos = np.empty(s.n_loc, dtype=np.int64)
    pos[order] = np.arange(s.n_loc, dtype=np.int64) \
        - np.repeat(starts, counts)
    # flat basis buffer: each MIS's (size, ncd) block row-major
    bsizes = counts * s.mis_ncd
    boff = np.zeros(s.n_mis, dtype=np.int64)
    np.cumsum(bsizes[:-1], out=boff[1:])
    chunks = [np.ascontiguousarray(s.mis_basis[m][:, :s.mis_ncd[m]]).ravel()
              for m in range(s.n_mis) if s.mis_ncd[m] > 0]
    bflat = np.concatenate(chunks) if chunks else np.zeros(0)
    # entries
    total = int(ncd_d.sum())
    rows = np.repeat(np.arange(s.n_loc, dtype=np.int64), ncd_d)
    j = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(ncd_d) - ncd_d, ncd_d)
    md = m_of[rows]
    vals = bflat[boff[md] + pos[rows] * ncd_d[rows] + j]
    cols = s.mis_coff[md] + j
    nz = vals != 0.0
    P = sp.coo_matrix((vals[nz], (rows[nz], cols[nz])),
                      shape=(s.n_loc, NC)).tocsr()
    P.sort_indices()
    return P


def _fetch_ghost_rows(states: List[RankState], s: RankState,
                      pieces: Dict[int, sp.csr_matrix],
                      ledger: ExchangeLedger,
                      phase: str) -> Optional[sp.csr_matrix]:
    """Fetch the P rows of this rank's ghost columns from the ranks that
    contributed them (SEC-style), preserving ghost order."""
    if not len(s.ghost_gid):
        return None
    grows = []
    for src in np.unique(s.ghost_src):
        so = states[int(src)]
        sel = s.ghost_src == src
        lg = np.searchsorted(so.ldof_gid, s.ghost_gid[sel])
        sa_assert(1, bool((so.ldof_gid[lg] == s.ghost_gid[sel]).all()),
                  "ghost row not on source")
        block = pieces[int(src)][lg]
        grows.append((np.flatnonzero(sel), block))
        ledger.add(phase, block.nnz * 16, int(src))
    G = sp.vstack([b for _, b in grows]).tocsr()
    perm = np.concatenate([i for i, _ in grows])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return G[inv]


def _rank_dinv(states: List[RankState], s: RankState,
               ledger: ExchangeLedger) -> np.ndarray:
    """Rank-local weighted-ell1 smoother diagonal (mbox_snd_D analog):
    d_i = sum_j |a_ij| sqrt(a_ii/a_jj) over stored entries.  Ghost-column
    diagonals are fetched from their owners (one interface exchange)."""
    diag_l = s.A[:, :s.n_loc].diagonal()
    sa_assert(1, bool((diag_l > 0).all()),
              "non-positive diagonal in rank-local operator")
    diag_ext = np.concatenate([diag_l, np.zeros(len(s.ghost_gid))])
    for src in np.unique(s.ghost_src) if len(s.ghost_gid) else []:
        so = states[int(src)]
        sel = s.ghost_src == src
        lg = np.searchsorted(so.ldof_gid, s.ghost_gid[sel])
        diag_ext[s.n_loc + np.flatnonzero(sel)] = \
            so.A[:, :so.n_loc].diagonal()[lg]
        ledger.add("smooth_halo", int(sel.sum()) * 8, int(src))
    sa_assert(1, bool((diag_ext[s.n_loc:] > 0).all()) if len(s.ghost_gid)
              else True, "ghost diagonal missing or non-positive")
    y = abs(s.A) @ (1.0 / np.sqrt(diag_ext))
    return 1.0 / (np.sqrt(diag_l) * y)


def _route_smooth_interp(states: List[RankState],
                         tent_pieces: Dict[int, sp.csr_matrix],
                         roots: np.ndarray, ledger: ExchangeLedger,
                         times_apply: int = 1,
                         drop_tol: float = 0.0) -> Dict[int, sp.csr_matrix]:
    """Distributed prolongator smoothing (interp_smooth, interp.cpp:172):
    P <- prod_k (I - (1/tau_k) D^{-1} A) P applied rank-locally, with one
    ghost-P-row halo exchange per smoothing application (the hypre
    ParMult halo of the reference's SpGEMM-per-root).  The ghost set is
    fixed (the columns of the rank's assembled rows), so the exchange
    volume stays O(interface) per root.  Returns per-rank smoothed local
    P rows."""
    pieces = dict(tent_pieces)
    dinvs = {s.rank: _rank_dinv(states, s, ledger) for s in states}
    for tau in roots:
        for _ in range(max(times_apply, 1)):
            # synchronous halo: everyone fetches BEFORE anyone updates
            exts = {}
            for s in states:
                G = _fetch_ghost_rows(states, s, pieces, ledger,
                                      "smooth_halo")
                exts[s.rank] = sp.vstack([pieces[s.rank], G]).tocsr() \
                    if G is not None else pieces[s.rank]
            for s in states:
                AP = s.A @ exts[s.rank]
                Pn = (pieces[s.rank]
                      - sp.diags(dinvs[s.rank] / tau) @ AP).tocsr()
                pieces[s.rank] = Pn
    if drop_tol > 0.0:
        for r, P in pieces.items():
            P.data[np.abs(P.data) <= drop_tol] = 0.0
            P.eliminate_zeros()
    return pieces


def _route_rap(states: List[RankState], offsets: np.ndarray,
               ledger: ExchangeLedger,
               pieces: Optional[Dict[int, sp.csr_matrix]] = None
               ) -> sp.csr_matrix:
    """Distributed Galerkin product (hypre RAP analog, tg.hpp:696):
    every rank forms the tentative-P rows of its local dofs from the
    broadcast MIS bases, fetches P rows for its ghost columns from the
    ranks that contributed them (one extra SEC-style exchange), computes
    its owned-row contribution P_own^T A_own P_ext, and the router sums
    the coarse COO pieces (the ICI all-reduce over coarse ids)."""
    NC = int(offsets[-1])
    if pieces is None:
        pieces = {}
        for s in states:
            pieces[s.rank] = _p_rows_csr(s, NC)
    Ac_sum = sp.csr_matrix((NC, NC))
    for s in states:
        P_loc = pieces[s.rank]
        G = _fetch_ghost_rows(states, s, pieces, ledger, "rap_ghost_rows")
        P_ext = sp.vstack([P_loc, G]).tocsr() if G is not None else P_loc
        own = np.flatnonzero(s.owner_mask)
        A_own = s.A[own]
        P_own = P_ext[own]
        Ac_r = (P_own.T @ (A_own @ P_ext)).tocsr()
        Ac_sum = (Ac_sum + Ac_r).tocsr()
        ledger.add("rap_reduce", Ac_r.data.nbytes, s.rank)
        s._account()
    Ac_sum.sort_indices()
    return Ac_sum


# ---------------------------------------------------------------------------
# phase 10: coarse-level outputs (tables + element matrices per fine AE)


def _coarse_outputs(states: List[RankState], offsets: np.ndarray,
                    e2e_global: Table, ledger: ExchangeLedger):
    """Per-rank construction of everything the next (much smaller) level
    needs: coarse elem(=AE)_to_dof rows, the coarse dual graph, AE dof
    weights, and the coarse element matrices (AE-local RAP — exactly
    ElementMatrixParallelCoarse, elmat.cpp:105-195).  Total output is
    O(coarse), gathered on the controller (the reference gathers the
    same objects into its coarse agg_partitioning_relations_t)."""
    n_ae_total = max(s.ae_goff + s.n_ae for s in states)
    c_e2d_rows: List[np.ndarray] = [None] * n_ae_total
    c_e2e_rows: List[np.ndarray] = [None] * n_ae_total
    weights = np.zeros(n_ae_total, dtype=np.float64)
    coarse_elem_mats: List[np.ndarray] = [None] * n_ae_total
    # elem -> global AE map for cross-rank adjacency (router-held,
    # O(#elems) ints — the analog of the elem_to_AE ParCSR columns)
    elem_gae = np.zeros(e2e_global.nrows, dtype=np.int64)
    for s in states:
        elem_gae[s.elems] = s.part + s.ae_goff
    for s in states:
        # per-dof nonzero-P-row mask (zero rows — essential dofs inside a
        # MIS — must not trigger the first encounter, matching the
        # ZERO-DROPPED finedof_to_dof pattern of a single host)
        P_loc = getattr(s, "_P_loc", None)
        if P_loc is not None:
            has_row = np.diff(P_loc.indptr) > 0
        else:
            has_row = s.mis_ncd[s.mis_of_dof] > 0
        for lae in range(s.n_ae):
            gae = lae + s.ae_goff
            dofs_l = s.rels.AE_to_dof.row(lae)
            weights[gae] = len(dofs_l)
            # mis ids per AE, first-encounter order over nonzero-row dofs
            # (the order AE_to_dof.mult(finedof_to_dof) produces)
            mis_seq = s.mis_of_dof[dofs_l[has_row[dofs_l]]]
            uniq, first = np.unique(mis_seq, return_index=True)
            order_mis = uniq[np.argsort(first, kind="stable")]
            ncds = s.mis_ncd[order_mis]
            row = _ranges(s.mis_coff[order_mis], ncds)
            c_e2d_rows[gae] = row
            # coarse element matrix: local RAP of the AE stiffness with
            # the stitched per-MIS tentative blocks (ascending mis gid —
            # the np.sort(AE_to_mis.row) order of CoarseProvider)
            blk_start = np.zeros(len(order_mis), dtype=np.int64)
            np.cumsum(ncds[:-1], out=blk_start[1:])
            A_T = s.ae_stiffm[lae] if s.ae_stiffm is not None else \
                build_AE_stiffm_with_global(s.A, lae, s.rels, s.elem_mats)
            local_interp = np.zeros((len(dofs_l), len(row)))
            for k in np.argsort(s.mis_gid[order_mis], kind="stable"):
                mm = int(order_mis[k])
                ncd = int(ncds[k])
                if ncd == 0:
                    continue
                mdofs = s.mis_dofs.row(mm)
                rloc = ae_local_ids(s.rels, mdofs,
                                    np.full(len(mdofs), lae,
                                            dtype=np.int64))
                ccols = blk_start[k] + np.arange(ncd, dtype=np.int64)
                local_interp[np.ix_(rloc, ccols)] += \
                    s.mis_basis[mm][:, :ncd]
            coarse_elem_mats[gae] = local_interp.T @ (A_T @ local_interp)
            ledger.add("coarse_gather",
                       coarse_elem_mats[gae].nbytes + row.nbytes, s.rank)
        # coarse dual graph rows: first-encounter over (elements of AE
        # ascending) x (their e2e neighbors in row order)
        for lae in range(s.n_ae):
            gae = lae + s.ae_goff
            ge = s.elems[s.rels.AE_to_elem.row(lae)]
            nbr_ae = elem_gae[e2e_global.indices[
                _concat_ranges(e2e_global.indptr, ge)]]
            uniq, first = np.unique(nbr_ae, return_index=True)
            c_e2e_rows[gae] = uniq[np.argsort(first, kind="stable")]
    NC = int(offsets[-1])
    coarse_e2d = Table.from_rows(c_e2d_rows, NC)
    coarse_e2e = Table.from_rows(c_e2e_rows, n_ae_total)
    return coarse_e2d, coarse_e2e, weights, coarse_elem_mats


# ---------------------------------------------------------------------------
# driver


@dataclasses.dataclass
class SPMDSetup:
    """Products of one SPMD coarsening + the exchange/memory evidence."""

    n_ranks: int
    num_mises: int
    P: sp.csr_matrix                  # global tentative prolongator
    interp: Optional[sp.csr_matrix]   # smoothed prolongator (nu_pro > 0)
    Ac: sp.csr_matrix                 # Galerkin coarse operator
    mis_numcoarsedof: np.ndarray
    mis_coarsedofoffsets: np.ndarray
    suggested_theta: Optional[float]
    coarse_e2d: Table                 # coarse elem(=fine AE) -> coarse dof
    coarse_e2e: Table                 # coarse dual graph (incl. self)
    coarse_weights: np.ndarray        # AE dof counts (repartition weights)
    coarse_elem_mats: List[np.ndarray]
    n_ae_total: int
    ledger: ExchangeLedger
    peak_bytes_per_rank: List[int]
    states: List[RankState]


def spmd_coarsen_from(prev: "SPMDSetup", theta: float,
                      nparts: Optional[int] = None,
                      partitioning: Optional[np.ndarray] = None,
                      avoid_ess_bdr_dofs: bool = True,
                      svd_eps: float = SVD_EPS,
                      use_truncated: bool = True,
                      setup_mesh=None,
                      nu_pro: int = 0,
                      drop_tol: float = 0.0,
                      seed: int = 0) -> "SPMDSetup":
    """Recursive SPMD coarsening (agg_create_partitioning_coarse +
    ml_produce_hierarchy_from_level, rank-decomposed): the previous
    coarsening's outputs become this level's problem — coarse elements
    are the fine AEs (kept on their ranks, as the reference keeps them
    until the METIS repartition), element matrices are the AE-local
    RAPs, the operator rows come from the distributed RAP output, and
    AE stiffness is assembled purely locally."""
    NDc = prev.Ac.shape[0]
    flags = np.zeros(NDc, dtype=np.uint8)
    elem_rank = np.concatenate(
        [np.full(s.n_ae, s.rank, dtype=np.int64) for s in prev.states])
    if nparts is None:
        nparts = max(prev.n_ae_total // 64, 1)
    epa = max(1, -(-prev.n_ae_total // max(nparts, 1)))
    return spmd_coarsen(
        prev.coarse_e2d, prev.coarse_e2e, prev.coarse_elem_mats, flags,
        prev.n_ranks, partitioning=partitioning, elem_rank=elem_rank,
        elems_per_agg=epa, theta=theta,
        avoid_ess_bdr_dofs=avoid_ess_bdr_dofs, svd_eps=svd_eps,
        use_truncated=use_truncated, setup_mesh=setup_mesh,
        nu_pro=nu_pro, drop_tol=drop_tol, A_rows=prev.Ac,
        ae_local_assembly=True, part_weights=prev.coarse_weights,
        seed=seed)


def assemble_global_A(out: "SPMDSetup") -> sp.csr_matrix:
    """Gather the owner rows of the rank-local operators into the global
    CSR the solve phase consumes (the solve-side input, like the
    reference's assembled ParCSR; setup itself never used this)."""
    N = out.P.shape[0]
    rows, cols, vals = [], [], []
    for s in out.states:
        gmap = np.concatenate([s.ldof_gid, s.ghost_gid]) \
            if len(s.ghost_gid) else s.ldof_gid
        own = np.flatnonzero(s.owner_mask)
        Arow = s.A[own].tocoo()
        rows.append(s.ldof_gid[own[Arow.row]])
        cols.append(gmap[Arow.col])
        vals.append(Arow.data)
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N)).tocsr()
    A.sort_indices()
    return A


def spmd_ml_produce_data(e2d_global: Table, e2e_global: Table,
                         elem_mats: np.ndarray, bdr_flags: np.ndarray,
                         n_ranks: int, mlp, A: Optional[sp.csr_matrix] = None,
                         partitioning: Optional[np.ndarray] = None,
                         elems_per_agg: int = 64,
                         avoid_ess_bdr_dofs: bool = True,
                         setup_mesh=None,
                         spmd_coarsenings: int = 1,
                         seed: int = 0):
    """Full multilevel setup with the FINEST (memory-dominant) coarsening
    running through the SPMD pipeline and the much smaller coarse levels
    continuing on the standard single-host path fed by the per-rank
    coarse outputs (coarse tables + AE-local-RAP element matrices — the
    objects agg_create_partitioning_coarse consumes,
    aggregates.cpp:1736).  Returns (MLData, SPMDSetup).

    ``A``: optional pre-assembled global operator for the solve phase;
    assembled from the rank-local owner rows when omitted.  nu_pro > 0
    runs the distributed prolongator smoothing; ``spmd_coarsenings``
    chains further rank-decomposed coarsenings before the single-host
    continuation."""
    from saamge_jax.setup import ml as ml_mod
    from saamge_jax.setup import tg as tg_mod
    from saamge_jax.setup.contrib import TentativeInterp
    from saamge_jax.setup.elmat import DenseArrayProvider
    from saamge_jax.setup.interp import interp_init_data
    from saamge_jax.solve import smoothers
    from saamge_jax.solve.coarse import make_coarse_solver
    from saamge_jax.topology.agglomerate import (_create_tables,
                                                 _strip_diagonal)

    sa_assert(1, not mlp.use_correct_nullspace,
              "SPMD setup does not build scaling_P (correct_nullspace)")
    num = mlp.num_coarsenings
    k = max(1, min(int(spmd_coarsenings), num))

    def tg_from(out_j, A_lv, j):
        interp_data = interp_init_data(
            _FakeRels(out_j.n_ae_total), mlp.get_nu_pro(j),
            mlp.use_truncated_eigensolver)
        interp_data.tent = TentativeInterp(
            P=out_j.P, mis_tent_interps=None,
            mis_numcoarsedof=out_j.mis_numcoarsedof,
            local_coarse_one_representation=None)
        interp_data.mis_coarsedofoffsets = out_j.mis_coarsedofoffsets
        interp_data.suggested_theta = out_j.suggested_theta
        interp_j = out_j.interp if out_j.interp is not None else out_j.P
        return tg_mod.TGData(
            interp_data=interp_data,
            poly_data=smoothers.init_poly_data(
                A_lv, mlp.get_nu_relax(j), mlp.smoother_poly_family,
                mlp.smoother_poly_param),
            theta=mlp.get_theta(j),
            smooth_interp=out_j.interp is not None,
            ltent_interp=out_j.P, tent_interp=out_j.P, interp=interp_j,
            restr=interp_j.T.tocsr(), Ac=out_j.Ac, doing_spectral=True)

    out = spmd_coarsen(
        e2d_global, e2e_global, elem_mats, bdr_flags, n_ranks,
        partitioning=partitioning, elems_per_agg=elems_per_agg,
        theta=mlp.get_theta(0), avoid_ess_bdr_dofs=avoid_ess_bdr_dofs,
        use_truncated=mlp.use_truncated_eigensolver,
        setup_mesh=setup_mesh, nu_pro=mlp.get_nu_pro(0),
        drop_tol=mlp.smooth_drop_tol, seed=seed)
    if A is None:
        A = assemble_global_A(out)
    ml = ml_mod.MLData()
    ml.levels.append(ml_mod.Level(rels=None, tg_data=tg_from(out, A, 0),
                                  A=A))
    outs = [out]
    # further SPMD coarsenings (rank-decomposed all the way down)
    for j in range(1, k):
        prev = outs[-1]
        out_j = spmd_coarsen_from(
            prev, theta=mlp.get_theta(j),
            nparts=mlp.get_nparts_capped(j, prev.Ac.shape[0]),
            avoid_ess_bdr_dofs=avoid_ess_bdr_dofs,
            use_truncated=mlp.use_truncated_eigensolver,
            setup_mesh=setup_mesh, nu_pro=mlp.get_nu_pro(j),
            drop_tol=mlp.smooth_drop_tol, seed=seed)
        ml.levels.append(ml_mod.Level(
            rels=None, tg_data=tg_from(out_j, prev.Ac, j), A=prev.Ac))
        outs.append(out_j)
    last = outs[-1]
    if k == num:
        ml.levels[-1].tg_data.coarse_solver = make_coarse_solver(
            last.Ac, mlp.coarse_solver_kind)
        ml_mod.ml_impose_cycle(ml)
    else:
        # single-host continuation (level k) from the per-rank coarse
        # outputs, then the standard recursion
        weights = last.coarse_weights
        e2e_part = _strip_diagonal(last.coarse_e2e)
        nparts1 = mlp.get_nparts_capped(k, last.Ac.shape[0])
        part1 = partition_kway(e2e_part, weights.astype(np.float64),
                               nparts1, seed=seed)
        rels1 = _create_tables(last.Ac, last.coarse_e2d, last.coarse_e2e,
                               np.asarray(part1, dtype=np.int64), None,
                               int(np.max(part1)) + 1, False)
        tg1 = tg_mod.tg_init_data(
            last.Ac, rels1, mlp.get_nu_pro(k), mlp.get_nu_relax(k),
            mlp.get_theta(k), mlp.get_smooth_interp(k),
            mlp.smooth_drop_tol,
            use_truncated_eigensolver=mlp.use_truncated_eigensolver)
        emp1 = DenseArrayProvider(rels1, last.coarse_elem_mats)
        tg_mod.tg_build_hierarchy(last.Ac, tg1, rels1, emp1,
                                  avoid_ess_bdr_dofs)
        tg_mod.tg_update_coarse_operator(
            last.Ac, tg1, perform_solve_init=(num == k + 1),
            coarse_solver_kind=mlp.coarse_solver_kind)
        ml.levels.append(ml_mod.Level(rels=rels1, tg_data=tg1,
                                      A=last.Ac))
        ml_mod.ml_produce_hierarchy_from_level(num, k + 1, ml, mlp)
    ml_mod.ml_print_data(A, ml)
    return ml, out


class _FakeRels:
    """Minimal rels stand-in for interp_init_data on the SPMD level (the
    per-AE caches live rank-local, not in a global AggPartRels)."""

    def __init__(self, nparts: int):
        self.nparts = nparts


def spmd_coarsen(e2d_global: Table, e2e_global: Table,
                 elem_mats: np.ndarray, bdr_flags: np.ndarray,
                 n_ranks: int,
                 partitioning: Optional[np.ndarray] = None,
                 elem_rank: Optional[np.ndarray] = None,
                 elems_per_agg: int = 64,
                 theta: float = 0.003,
                 avoid_ess_bdr_dofs: bool = True,
                 svd_eps: float = SVD_EPS,
                 use_truncated: bool = True,
                 setup_mesh=None,
                 nu_pro: int = 0,
                 times_apply_smoother: int = 1,
                 drop_tol: float = 0.0,
                 A_rows: Optional[sp.csr_matrix] = None,
                 ae_local_assembly: bool = False,
                 part_weights: Optional[np.ndarray] = None,
                 seed: int = 0) -> SPMDSetup:
    """One SPMD spectral coarsening: the full distributed pipeline
    (tables -> MISes -> eigensolves -> SEC SVD -> numbering -> RAP ->
    coarse-level inputs), rank by rank.

    ``partitioning``: optional global elem->AE map (must be rank-major;
    see rank_blocks_from_partitioning).  Without it each rank runs the
    local k-way partitioner, like the reference runs METIS per rank.

    Coarse recursion (``spmd_coarsen_from``): ``A_rows`` supplies the
    level operator (the previous distributed RAP output) instead of
    element-scatter assembly, and ``ae_local_assembly`` switches the AE
    stiffness to pure local assembly from the (ragged) coarse element
    matrices (ElementMatrixParallelCoarse semantics)."""
    ledger = ExchangeLedger()
    if elem_rank is None:
        if partitioning is not None:
            elem_rank = rank_blocks_from_partitioning(partitioning, n_ranks)
        else:
            # coarse top-level split of the dual graph into ranks
            elem_rank = partition_kway(e2e_global, None, n_ranks, seed=seed)
            n_ranks = int(elem_rank.max()) + 1
    states = make_rank_states(e2d_global, e2e_global, elem_mats, bdr_flags,
                              elem_rank, n_ranks)
    sa_assert(1, all(len(s.elems) > 0 for s in states),
              "empty rank (n_ranks exceeds what the element partition "
              "supports)")
    _route_rendezvous(states, ledger)
    partition_ranks_local(states, partitioning, elems_per_agg, ledger,
                          seed=seed, weights_global=part_weights)
    _route_dof_ae_union(states, ledger)
    num_mises = _route_mis_identify(states, ledger)
    sa_print(5, "SPMD setup: %d ranks, %d AEs, %d MISes", n_ranks,
             max(s.ae_goff + s.n_ae for s in states), num_mises)
    if A_rows is None:
        _route_assemble(states, ledger)
    else:
        _route_coarse_rows(states, A_rows.tocsr(), ledger)
    rank_spectral(states, theta, use_truncated=use_truncated,
                  setup_mesh=setup_mesh,
                  ae_local_assembly=ae_local_assembly)
    svd_fn = None
    if setup_mesh is not None:
        from saamge_jax.parallel.dist_setup import make_sharded_svd
        svd_fn = make_sharded_svd(setup_mesh)
    mis_ncd, offsets, masters_out = _route_tentative(
        states, num_mises, avoid_ess_bdr_dofs, svd_eps, ledger,
        svd_fn=svd_fn)
    NC = int(offsets[-1])
    tent_pieces = {s.rank: _p_rows_csr(s, NC) for s in states}
    for s in states:
        s._P_loc = tent_pieces[s.rank]   # coarse tables use the TENT
        # pattern (create_partitioning_coarse consumes tent_interp)
    rap_pieces = tent_pieces
    if nu_pro > 0:
        from saamge_jax.solve.smoothers import sa_poly_roots
        rap_pieces = _route_smooth_interp(
            states, tent_pieces, sa_poly_roots(nu_pro), ledger,
            times_apply=times_apply_smoother, drop_tol=drop_tol)
    Ac = _route_rap(states, offsets, ledger, pieces=rap_pieces)
    coarse_e2d, coarse_e2e, weights, c_mats = _coarse_outputs(
        states, offsets, e2e_global, ledger)
    # router-side global P assembly (the solve-phase input; the reference
    # equally materializes the ParCSR P)
    ND = int(e2d_global.ncols)
    rows, cols, vals = [], [], []
    for gid in range(num_mises):
        gdofs, basis = masters_out[gid]
        if basis.shape[1] == 0:
            continue
        nz = basis != 0.0
        r, c = np.nonzero(nz)
        rows.append(gdofs[r])
        cols.append(offsets[gid] + c)
        vals.append(basis[r, c])
    P = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ND, int(offsets[-1]))).tocsr() if rows else \
        sp.csr_matrix((ND, 0))
    interp = None
    if nu_pro > 0:
        # owner-row gather of the smoothed rows (each dof's final row
        # lives on its owner)
        ri, ci, vi = [], [], []
        for s in states:
            own = np.flatnonzero(s.owner_mask)
            Pr = rap_pieces[s.rank][own].tocoo()
            ri.append(s.ldof_gid[own[Pr.row]])
            ci.append(Pr.col)
            vi.append(Pr.data)
        interp = sp.coo_matrix(
            (np.concatenate(vi), (np.concatenate(ri), np.concatenate(ci))),
            shape=(ND, NC)).tocsr()
        interp.sort_indices()
    skipped = [x for s in states for x in s.skipped if x is not None]
    suggested = 0.5 * theta + 0.5 * float(np.mean(skipped)) \
        if skipped else None
    return SPMDSetup(
        n_ranks=n_ranks, num_mises=num_mises, P=P, interp=interp, Ac=Ac,
        mis_numcoarsedof=mis_ncd, mis_coarsedofoffsets=offsets,
        suggested_theta=suggested,
        coarse_e2d=coarse_e2d, coarse_e2e=coarse_e2e,
        coarse_weights=weights, coarse_elem_mats=c_mats,
        n_ae_total=max(s.ae_goff + s.n_ae for s in states),
        ledger=ledger,
        peak_bytes_per_rank=[s.peak_bytes for s in states],
        states=states)
