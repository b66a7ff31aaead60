"""Device-side setup pipeline for translation-invariant agglomerations.

The reference's setup hot loop (interp_compute_vectors, interp.cpp:342)
assembles one AE stiffness matrix and solves one dense generalized
eigenproblem per agglomerate.  On a uniform structured mesh with a
Cartesian brick partitioning all AEs share ONE local assembly pattern
(same local dof map, same element layout — only the per-element
coefficients differ), so the whole per-AE pipeline collapses to batched
device kernels:

  1. assembly as a matmul: A_flat = COEF @ PAT, where PAT (E_loc*r, n^2)
     scatters an r-member element-matrix basis into the brick-local
     dense pattern (built once, on host) and COEF holds the per-element
     basis coefficients.  The basis comes from an SVD of the element
     matrices (verified against EVERY element), so both scalar (r=1) and
     anisotropic-tensor coefficients (r <= d(d+1)/2 + 1,
     AnisotropicDiffusionIntegrator.cpp:131-149) take this path;
  2. essential-BC masking (zero ess rows/cols, keep the re-assembled
     diagonal — agg_build_AE_stiffm_with_global semantics,
     aggregates.cpp:855 with assemble_ess_diag);
  3. weighted-l1 rhs diagonal (mbox_snd_D_sparse_from_sparse,
     mbox.cpp:913), the B^{-1/2} A B^{-1/2} reduction, identity padding;
  4. ONE batched eigensolve per chunk, eigenvectors mapped back by
     B^{-1/2} on device, only the lowest ``kmax`` columns fetched;
  5. the theta cut on host from the eigenvalues (xpack_cut_evects_small
     semantics: keep lambda <= theta, at least one).

Sparse per-AE stiffness matrices (shared CSR structure, per-AE values
from one small matmul) are returned as well so deeper levels
(CoarseProvider local RAP, elmat.cpp:105-195) and adaptivity keep
working.  Returns None when the agglomeration is not translation
invariant — callers fall back to the generic batched/host paths.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from saamge_jax.topology.agglomerate import FLAG_ESS_BDR
from saamge_jax.utils.logging import sa_print


def _bucket(n: int) -> int:
    """All AEs share one size on the uniform path, so pad minimally (to
    a sublane multiple): eigh cost is O(n^3) and a power-of-two pad of
    729 -> 1024 would be 2.8x wasted flops."""
    return -(-max(n, 8) // 32) * 32


@dataclasses.dataclass
class UniformPlan:
    n: int                      # dofs per AE
    e_loc: int                  # elements per AE
    r: int                      # element-matrix basis rank
    elems: np.ndarray           # (NB, E_loc) element ids, template order
    loc: np.ndarray             # (E_loc, nd_el) local dof ids (shared)
    coef: np.ndarray            # (NB, E_loc, r) basis coefficients
    basis: np.ndarray           # (r, nd_el, nd_el) orthonormal basis
    essmask: np.ndarray         # (NB, n) bool
    ae_dofs_sorted: bool


# max rank of the element-matrix basis the device pipeline factors
# through: a scalar coefficient is rank 1, a d-dimensional tensor
# (anisotropic) coefficient spans at most d(d+1)/2 + 1 = 7 reference
# matrices in 3D (AnisotropicDiffusionIntegrator.cpp:131-149)
UNIFORM_BASIS_RMAX = 8


def analyze_uniform(rels, elem_mats,
                    rtol: float = 1e-9) -> Optional[UniformPlan]:
    """Detect the translation-invariant structure or return None.

    Both structural checks are TOTAL (round-2 advisor finding: sampled
    checks could silently accept a violating mesh): the shared local dof
    map is verified for every AE, and the element-matrix factorization
    em_e = sum_j coef[e, j] * basis_j is verified for every element
    (basis found by SVD of a sample, residual checked globally)."""
    from saamge_jax.fem.assemble import FactorizedElemMats
    factorized = isinstance(elem_mats, FactorizedElemMats)
    if not (factorized or (isinstance(elem_mats, np.ndarray)
                           and elem_mats.ndim == 3)):
        return None
    nparts = rels.nparts
    if nparts < 2:
        return None
    sizes = rels.AE_to_dof.row_sizes()
    esz = rels.AE_to_elem.row_sizes()
    if sizes.min() != sizes.max() or esz.min() != esz.max():
        return None
    n = int(sizes[0])
    e_loc = int(esz[0])
    nd_el = elem_mats.shape[1]
    e2d = rels.elem_to_dof
    if len(e2d.indices) != e2d.nrows * nd_el:
        return None                       # ragged element dofs
    e2d_rect = e2d.indices.reshape(-1, nd_el)
    if len(rels.AE_to_elem.indices) != nparts * e_loc:
        return None

    elems = np.sort(rels.AE_to_elem.indices.reshape(nparts, e_loc),
                    axis=1)

    # canonical local numbering = AE_to_dof row order (first-encounter,
    # the dof_id_inAE convention used by the host AE assembly and the
    # tent build).  FULL vectorized check over every AE: map each
    # element dof to its local index via one global searchsorted with
    # per-AE disjoint key ranges.
    dofs = rels.AE_to_dof.indices.reshape(nparts, n)
    order = np.argsort(dofs, axis=1, kind="stable")
    dofs_sorted = np.take_along_axis(dofs, order, axis=1)
    stride = np.int64(rels.ND) + 1
    keys_sorted = (dofs_sorted
                   + stride * np.arange(nparts)[:, None]).ravel()
    q = e2d_rect[elems]                   # (NB, E_loc, nd_el)
    qk = (q + stride * np.arange(nparts)[:, None, None]).ravel()
    pos = np.searchsorted(keys_sorted, qk)
    if not np.array_equal(keys_sorted[pos], qk):
        return None                       # element dof outside its AE
    local = np.take_along_axis(
        order, (pos - np.arange(nparts).repeat(e_loc * nd_el) * n)
        .reshape(nparts, -1), axis=1).reshape(nparts, e_loc, nd_el)
    if (local != local[:1]).any():
        return None
    loc0 = local[0]

    if factorized:
        # already in the exact rank-1 form the SVD below would find:
        # em_e = c[e] * em0 => basis = em0/||em0||, coef = c*||em0||
        em0 = elem_mats.em0
        nrm = float(np.linalg.norm(em0))
        basis1 = (em0 / nrm)[None]
        cvec = (elem_mats.c if elem_mats.c is not None
                else np.ones(elem_mats.NE)) * nrm
        coef = cvec[elems][:, :, None]
        ess = (rels.agg_flags[dofs] & FLAG_ESS_BDR) != 0
        return UniformPlan(n, e_loc, 1, elems, loc0, coef, basis1, ess,
                           False)

    # low-rank element-matrix factorization em_e = coef[e] @ basis:
    # basis from an SVD of a sample, coefficients by projection, the
    # residual checked for EVERY element
    flat = elem_mats.reshape(elem_mats.shape[0], -1)
    rng = np.random.default_rng(0)
    samp = rng.choice(flat.shape[0],
                      size=min(16 * UNIFORM_BASIS_RMAX, flat.shape[0]),
                      replace=False)
    nrm2 = np.einsum("ij,ij->i", flat, flat, optimize=True)
    coef_all = None
    for attempt in range(3):
        U, sv, Vt = np.linalg.svd(flat[samp].astype(np.float64),
                                  full_matrices=False)
        scale = max(sv[0], 1e-300)
        r = int((sv > 1e-9 * scale).sum())
        if r == 0 or r > UNIFORM_BASIS_RMAX:
            return None
        V = Vt[:r]                        # (r, nd^2) orthonormal
        coef_all = flat.astype(np.float64) @ V.T      # (NE, r)
        # exact total residual check via orthogonality:
        # ||em||^2 - ||coef||^2 = ||em - proj||^2
        prj2 = np.einsum("ij,ij->i", coef_all, coef_all, optimize=True)
        res2 = np.maximum(nrm2 - prj2, 0.0)
        bad = res2 > 1e-14 * np.maximum(nrm2, rtol ** 2)
        if not bad.any():
            break
        # sample missed a direction (e.g. a piecewise coefficient
        # region): augment with the worst offenders and retry
        samp = np.unique(np.concatenate(
            [samp, np.argsort(res2)[-16 * UNIFORM_BASIS_RMAX:]]))
    else:
        return None
    coef = coef_all[elems]                # (NB, E_loc, r)
    basis = V.reshape(r, nd_el, nd_el)

    ess = (rels.agg_flags[dofs] & FLAG_ESS_BDR) != 0
    return UniformPlan(n, e_loc, r, elems, loc0, coef, basis, ess, False)


@lru_cache(maxsize=8)
def _assemble_fn(n: int):
    """Jitted device assembly: COEF @ PAT -> BC mask -> weighted-l1
    scaled M = B^{-1/2} A B^{-1/2} (unpadded)."""

    @jax.jit
    def run(coefs, pat, ess):
        Aflat = jnp.dot(coefs, pat, precision="highest",
                        preferred_element_type=jnp.float32)
        A = Aflat.reshape(coefs.shape[0], n, n)
        A = 0.5 * (A + jnp.swapaxes(A, 1, 2))
        diag = jnp.diagonal(A, axis1=1, axis2=2)
        keep = ~ess
        A = A * (keep[:, :, None] & keep[:, None, :])
        ar = jnp.arange(n)
        A = A.at[:, ar, ar].set(diag)
        s = jnp.sqrt(diag)
        bd = jnp.einsum("pij,pj->pi", jnp.abs(A), 1.0 / s,
                        precision="highest") * s
        dh = 1.0 / jnp.sqrt(bd)
        M = dh[:, :, None] * A * dh[:, None, :]
        return M, bd, dh

    return run


@lru_cache(maxsize=8)
def _eigh_fn(n: int, nmax: int, kmax: int):
    """Full batched eigh fallback (small n: a fresh XLA eigh shape is
    cheap to compile and exact)."""

    @jax.jit
    def run(M, dh):
        Pc = M.shape[0]
        Mp = jnp.zeros((Pc, nmax, nmax), jnp.float32)
        arm = jnp.arange(nmax)
        Mp = Mp.at[:, arm, arm].set(1.0)
        Mp = Mp.at[:, :n, :n].set(M)
        evals, Y = jnp.linalg.eigh(Mp)
        X = dh[:, :, None] * Y[:, :n, :kmax]
        return evals, X

    return run


# below this AE size the exact batched eigh is used; above it the
# Chebyshev-filtered subspace solver (ops/filtered_eig.py) — a batched
# eigh is a sweep chain while the filter is pure batched matmul
FILTERED_EIG_MIN_N = 192

# max relative eigenpair residual (||Mx - wx|| / sigma) tolerated from
# the filtered solver on pairs below the theta cut.  Converged filter
# output sits at ~1e-4 (f32 + leakage); a spectrum clustered at the
# filter edge degrades convergence and shows up here — those AEs are
# re-solved exactly on host rather than silently dropping a direction
# (the 0.829-vs-0.999 sensitivity anecdote, reference spectral.hpp:32-60)
FILTER_RESIDUAL_TOL = 0.05


def uniform_spectral_cut(elem_data, theta: float,
                         use_truncated: bool = False,
                         truncated_threshold: int = 64,
                         max_vectors: int = 10,
                         kmax: int = 64, chunk: int = 512,
                         want_sparse_aes: bool = True,
                         mesh=None):
    """Full device setup for a GeometricProvider on a uniform brick
    agglomeration.  Returns (cut_evects, skipped, bdiags, aes_sparse)
    or None when not applicable."""
    rels = getattr(elem_data, "rels", None)
    elem_mats = getattr(elem_data, "elem_mats", None)
    if rels is None or elem_mats is None:
        return None
    plan = analyze_uniform(rels, elem_mats)
    if plan is None:
        return None
    assert theta < 1.0
    n, e_loc, rk = plan.n, plan.e_loc, plan.r
    nmax = _bucket(n)
    kmax = min(kmax, n)
    nparts = rels.nparts

    # dense pattern PAT (E_loc*r, n^2): scatter each basis matrix
    # through the local dof map (one bincount per basis member); the
    # assembly stays ONE matmul COEF @ PAT with COEF (NB, E_loc*r)
    nd_el = plan.loc.shape[1]
    rows = plan.loc[:, :, None] * n + plan.loc[:, None, :]
    flat = (np.arange(e_loc)[:, None, None] * (n * n) + rows).ravel()
    pat = np.stack([
        np.bincount(flat,
                    weights=np.broadcast_to(
                        plan.basis[j], (e_loc, nd_el, nd_el)).ravel(),
                    minlength=e_loc * n * n).reshape(e_loc, n * n)
        for j in range(rk)], axis=1).reshape(e_loc * rk, n * n)
    pat_dev = jnp.asarray(pat, jnp.float32)
    coef2 = plan.coef.reshape(nparts, e_loc * rk)

    # shared sparse structure for per-AE CSR export: union pattern over
    # local (r, c) positions; per-AE values come from one small matmul
    upos = np.unique(rows.ravel())
    w_nnz = np.zeros((e_loc * rk, len(upos)))
    pos_idx = np.searchsorted(upos, rows.reshape(e_loc, -1))
    for j in range(rk):
        np.add.at(w_nnz.reshape(e_loc, rk, -1)[:, j, :],
                  (np.repeat(np.arange(e_loc), nd_el * nd_el),
                   pos_idx.ravel()),
                  np.broadcast_to(plan.basis[j],
                                  (e_loc, nd_el, nd_el)).ravel())
    ur, uc = np.divmod(upos, n)

    assemble = _assemble_fn(n)
    use_filter = n >= FILTERED_EIG_MIN_N
    if not use_filter:
        eigf = _eigh_fn(n, nmax, kmax)
    cut: List[np.ndarray] = [None] * nparts
    skipped = [0.0] * nparts
    bdiags: List[np.ndarray] = [None] * nparts
    aes: List[sp.csr_matrix] = [None] * nparts

    truncated = use_truncated and n > truncated_threshold
    host_fallback = []
    from saamge_jax.utils.logging import TIMERS
    # pad the batch to a stable shape: every distinct (batch, n) pair is
    # a separate XLA compilation
    bpad = chunk
    if nparts < chunk:
        bpad = 8
        while bpad < nparts:
            bpad *= 2
    for c0 in range(0, nparts, bpad):
        idx = np.arange(c0, min(c0 + bpad, nparts))
        pidx = idx
        if len(idx) < bpad:               # repeat brick 0 as padding
            pidx = np.concatenate([idx, np.zeros(bpad - len(idx),
                                                 dtype=np.int64)])
        else:
            pidx = idx
        with TIMERS.phase("setup.device_pipeline.eigh"):
            coefs = jnp.asarray(coef2[pidx], jnp.float32)
            essd = jnp.asarray(plan.essmask[pidx])
            if mesh is not None:
                # shard the AE batch over the device mesh: the sharding
                # propagates through the assembly and eigensolver jits
                # (SURVEY §2.2 item 5 — the batch dim is the DP axis)
                from saamge_jax.parallel.dist_setup import shard_batch
                coefs = shard_batch(mesh, coefs)
                essd = shard_batch(mesh, essd)
            M_d, bd_d, dh_d = assemble(coefs, pat_dev, essd)
            if use_filter:
                from saamge_jax.ops.filtered_eig import \
                    batched_smallest_eigs
                evals, Xf_d, eig_res = batched_smallest_eigs(M_d, kmax)
                X_d = dh_d[:, :, None] * Xf_d
            else:
                eig_res = None
            if eig_res is None:
                evals_d, X_d = eigf(M_d, dh_d)
                evals = np.asarray(evals_d, np.float64)
            bd = np.asarray(bd_d, np.float64)
        with TIMERS.phase("setup.device_pipeline.fetch"):
            # two-phase fetch: eigenvalues first, then only the columns
            # the theta cut can need
            if truncated:
                need = min(max_vectors, n) + 4
            else:
                need = int(max((evals[:, :kmax] <= theta).sum(axis=1)
                               .max(), 1)) + 4
            need = min(max(need, 2), kmax)
            X = np.asarray(X_d[:, :, :need], np.float64)
        with TIMERS.phase("setup.device_pipeline.aes"):
            vals_nnz = coef2[idx] @ w_nnz               # (Pc, nnz_u)
            essb = plan.essmask[idx]
            off_mask = (ur != uc)
            kill = (essb[:, ur] | essb[:, uc]) & off_mask[None, :]
            vals_nnz = np.where(kill, 0.0, vals_nnz)
        rr_t0 = __import__("time").perf_counter()
        for k, p in enumerate(idx):
            ev = evals[k]
            if truncated:
                kk = min(max_vectors, n)
                m = 1 + int((ev[1:kk] < theta).sum())
            else:
                m = max(int(np.searchsorted(ev, theta, side="right")), 1)
            if m > kmax:
                host_fallback.append(int(p))
                m = kmax
            if eig_res is not None and \
                    float(eig_res[k, :m].max()) > FILTER_RESIDUAL_TOL:
                # filtered subspace did not converge for this AE (theta
                # cut near the filter edge / clustered spectrum): exact
                # host re-solve below
                host_fallback.append(int(p))
            bdiags[p] = bd[k].copy()
            A_sp = sp.csr_matrix((vals_nnz[k], (ur, uc)), shape=(n, n))
            if want_sparse_aes:
                aes[p] = A_sp
            # f64 Rayleigh-Ritz refinement: the f32 device eigenvectors
            # carry ~1e-3 noise that defeats the MIS-SVD dedup tolerance
            # (contrib svd_eps=1e-10 assumes f64 inputs); projecting the
            # span onto the f64 operator restores host-grade vectors and
            # eigenvalues, then the theta cut is re-applied in f64
            mm = min((kk if truncated else m) + 4, X.shape[2], n)
            Xk = X[k][:, :mm]
            Bv = bdiags[p]
            G = Xk.T @ (Bv[:, None] * Xk)
            W = Xk.T @ (A_sp @ Xk)

            lam, Z = sla.eigh(0.5 * (W + W.T), 0.5 * (G + G.T))
            if truncated:
                kk2 = min(max_vectors, mm)
                m = 1 + int((lam[1:kk2] < theta).sum())
                skip = float(lam[kk2 - 1] if m == kk2
                             else max(lam[m], 0.0))
            else:
                m = max(int(np.searchsorted(lam, theta, side="right")), 1)
                m = min(m, mm)
                skip = float(lam[m] if m < mm else lam[mm - 1])
            cut[p] = Xk @ Z[:, :m]
            skipped[p] = skip
        TIMERS.totals["setup.device_pipeline.rr"] = \
            TIMERS.totals.get("setup.device_pipeline.rr", 0.0) + \
            (__import__("time").perf_counter() - rr_t0)
        TIMERS.counts["setup.device_pipeline.rr"] = \
            TIMERS.counts.get("setup.device_pipeline.rr", 0) + 1
    if host_fallback:
        host_fallback = sorted(set(host_fallback))
        sa_print(3, "device setup: %d/%d AEs routed to the exact host "
                 "eigensolver (theta cut beyond kmax or filter residual "
                 "> %g)", len(host_fallback), nparts, FILTER_RESIDUAL_TOL)
        from saamge_jax.setup.spectral import Eigensolver
        eig = Eigensolver(use_truncated=use_truncated,
                          max_vectors=max_vectors)
        off_mask = (ur != uc)
        for p in host_fallback:
            if aes[p] is not None:
                A_T = np.asarray(aes[p].todense())
            else:
                # rebuild from the shared sparse structure (the theta cut
                # exceeded kmax, so the device result under-resolves this
                # AE; computable regardless of want_sparse_aes)
                v = coef2[p] @ w_nnz
                kill = (plan.essmask[p][ur] | plan.essmask[p][uc]) \
                    & off_mask
                v = np.where(kill, 0.0, v)
                A_T = np.asarray(
                    sp.csr_matrix((v, (ur, uc)), shape=(n, n)).todense())
            cut[p], skipped[p], bdiags[p] = eig.solve(A_T, theta)
    sa_print(5, "device setup: %d uniform-brick eigensolves "
             "(n=%d padded %d, kmax=%d), %d vectors kept",
             nparts, n, nmax, kmax,
             int(sum(c.shape[1] for c in cut if c is not None)))
    return cut, skipped, bdiags, (aes if want_sparse_aes else None)
