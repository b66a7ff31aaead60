"""Batched device eigensolves/SVDs for the setup phase.

The reference's setup hot loop (interp_compute_vectors, interp.cpp:342)
solves one dense generalized eigenproblem ``A_T x = lambda B_T x`` per
agglomerate, serially, via LAPACK dsygv/dsygvx (xpacks.cpp:224-315), with
B_T the weighted-l1 smoother diagonal.  On the device the per-AE problems
have no cross-AE dependency (SURVEY §2.2 item 5), so they become ONE batched padded
dense eigensolve per size bucket:

  - AE matrices are bucketed by padded size (next multiple of
    ``bucket_multiple``); each bucket is stacked into (B, nmax, nmax).
  - Padding is decoupled: padded rows/cols are zeroed and the padded
    diagonal is set to 1 AFTER the weighted-l1 scaling, so every padding
    eigenvalue is exactly 1.0 and the padding block contributes eigenvectors
    supported only on padded rows.  Spectral cuts use theta < 1, so padding
    eigenpairs are never selected.
  - Since B is diagonal, the generalized problem reduces to the standard
    symmetric eigenproblem of ``M = B^-1/2 A B^-1/2`` and eigenvectors map
    back as ``x = B^-1/2 y`` — exactly what the host Eigensolver does, but
    vmapped over the stack (jnp.linalg.eigh batches natively and XLA lowers
    it to a batched device eigensolver).

Each bucket shape is jitted once and cached; repeated setup phases (more
levels, adaptivity re-solves) hit the cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["batched_spectral_cut", "batched_weighted_l1",
           "padded_eigh_stack"]


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _bucket_size(n: int, multiple: int) -> int:
    """Pad to the next power of two (>= multiple): few distinct shapes means
    few XLA compilations — eigh compile time grows with n, while cached
    runs are milliseconds, so shape reuse (plus the persistent compilation
    cache) keeps compile time out of the setup cost."""
    m = max(multiple, 16)
    while m < n:
        m *= 2
    return m


@jax.jit
def _eigh_batched(Mstack: jnp.ndarray):
    """Batched standard sym-eig; Mstack is the pre-scaled, pre-padded
    (B, nmax, nmax) stack (symmetric; padding block = identity)."""
    M = 0.5 * (Mstack + jnp.swapaxes(Mstack, 1, 2))
    return jnp.linalg.eigh(M)


def batched_weighted_l1(Astack: np.ndarray) -> np.ndarray:
    """Batched weighted-l1 smoother diagonals (host convenience)."""
    diag = np.diagonal(Astack, axis1=1, axis2=2)
    s = np.sqrt(diag)
    return np.einsum("bij,bj->bi", np.abs(Astack), 1.0 / s) * s


def padded_eigh_stack(mats: Sequence[np.ndarray], nmax: int,
                      dtype=np.float64):
    """Stack ragged square matrices into a zero-padded (B, nmax, nmax)."""
    B = len(mats)
    out = np.zeros((B, nmax, nmax), dtype=dtype)
    sizes = np.empty(B, dtype=np.int32)
    for k, m in enumerate(mats):
        n = m.shape[0]
        sizes[k] = n
        out[k, :n, :n] = m
    return out, sizes


def batched_spectral_cut(
        mats: Sequence[np.ndarray], theta: float,
        bucket_multiple: int = 32,
        use_truncated: bool = False,
        truncated_threshold: int = 64,
        max_vectors: int = 10,
        dtype=None,
        device_max_n: int = 1024,
        mesh=None,
) -> Tuple[List[np.ndarray], List[float], List[np.ndarray]]:
    """Device-batched replacement for per-AE Eigensolver.solve loops.

    Returns (cut_evects, skipped, bdiags) — lists over AEs with the same
    theta-cut semantics as setup.spectral.Eigensolver:
      - direct mode: keep eigenvalues <= theta (at least one);
      - truncated (ARPACK-analog) mode for AEs larger than
        ``truncated_threshold``: at most ``max_vectors`` vectors, kept
        while lambda < theta strictly, at least one.
    ``skipped`` is the smallest eigenvalue not taken (adaptive-theta input).
    """
    assert theta < 1.0, "theta >= 1 would select padding eigenpairs"
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    nae = len(mats)
    # bucket indices by padded size
    import scipy.sparse as ssp
    buckets: Dict[int, List[int]] = {}
    host_idxs: List[int] = []
    for i, m in enumerate(mats):
        nmax = _bucket_size(max(m.shape[0], 1), bucket_multiple)
        if nmax > device_max_n or ssp.issparse(m):
            # device eigh compile time grows with n; very large
            # AEs (rare: only badly unbalanced or tiny-nparts levels) and
            # sparse-stored AEs go to the host (LAPACK / sparse-LOBPCG
            # ARPACK-analog) path instead
            host_idxs.append(i)
        else:
            buckets.setdefault(nmax, []).append(i)

    cut: List[Optional[np.ndarray]] = [None] * nae
    skipped: List[float] = [0.0] * nae
    bdiags: List[Optional[np.ndarray]] = [None] * nae

    if host_idxs:
        from saamge_jax.setup.spectral import Eigensolver
        eig = Eigensolver(use_truncated=use_truncated,
                          max_vectors=max_vectors)
        for i in host_idxs:
            cut[i], skipped[i], bdiags[i] = eig.solve(mats[i], theta)

    # small buckets go to host outright: a fresh device eigh shape costs
    # a (possibly remote) compile measured in tens of seconds, far above
    # the host LAPACK time for small batches
    small = [nmax for nmax, idxs in buckets.items()
             if len(idxs) * nmax ** 3 < 2e10]
    if small:
        from saamge_jax.setup.spectral import Eigensolver
        eig_s = Eigensolver(use_truncated=use_truncated,
                           max_vectors=max_vectors)
        for nmax in small:
            for i in buckets.pop(nmax):
                cut[i], skipped[i], bdiags[i] = eig_s.solve(mats[i], theta)

    for nmax, idxs in sorted(buckets.items()):
        # host (f64): weighted-l1 diagonals + the B^{-1/2} A B^{-1/2}
        # scaling; padding block = identity (eigenvalue exactly 1)
        stack, sizes = padded_eigh_stack([mats[i] for i in idxs], nmax,
                                         dtype=np.float64)
        B = len(idxs)
        bdiag = np.ones((B, nmax))
        dhalf = np.ones((B, nmax))
        M = np.zeros((B, nmax, nmax))
        M[:, np.arange(nmax), np.arange(nmax)] = 1.0
        for k in range(B):
            n = int(sizes[k])
            bk = batched_weighted_l1(stack[k:k + 1, :n, :n])[0]
            bdiag[k, :n] = bk
            dh = 1.0 / np.sqrt(bk)
            dhalf[k, :n] = dh
            M[k, :n, :n] = dh[:, None] * stack[k, :n, :n] * dh[None, :]

        # pad the batch dim to a power of two as well (each (B, n, n) is a
        # distinct XLA compilation); identity padding gives trivial results.
        # With a device mesh the batch is also padded to the device count
        # and row-sharded: the per-AE solves are independent, so the batch
        # dimension is the natural data-parallel axis (SURVEY §2.2 item 5).
        Bpad = 1
        while Bpad < B:
            Bpad *= 2
        if mesh is not None:
            ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
            Bpad = max(Bpad, ndev)
        if Bpad > B:
            pad = np.zeros((Bpad - B, nmax, nmax))
            pad[:, np.arange(nmax), np.arange(nmax)] = 1.0
            M = np.concatenate([M, pad], axis=0)

        # device: the batched eigensolve itself
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            spec = PartitionSpec(mesh.axis_names[0])
            M_dev = jax.device_put(M.astype(np.dtype(dtype)),
                                   NamedSharding(mesh, spec))
        else:
            M_dev = jnp.asarray(M, dtype=dtype)
        if mesh is None and nmax >= 256 and np.dtype(dtype) == np.float32:
            # large matrices: Chebyshev-filtered subspace solver (pure
            # batched matmul instead of an eigh sweep chain) + f64
            # Rayleigh-Ritz against the host operators for accuracy.
            # Only the lowest mk pairs exist afterwards — enough for any
            # theta cut this path serves (theta << 1).
            from saamge_jax.ops.filtered_eig import batched_smallest_eigs
            mk = min(64, nmax)
            wf, Xf_d, f_res = batched_smallest_eigs(M_dev, mk)
            Xf = np.asarray(Xf_d, np.float64)[:B]
            evals = np.full((B, nmax), 1.0)
            ncomp = np.zeros(B, dtype=np.int64)
            Y = np.zeros((B, nmax, nmax))
            import scipy.linalg as _sla
            for k in range(B):
                n = int(sizes[k])
                if np.max(f_res[k]) > 0.05:
                    # filtered subspace failed to converge (clustered /
                    # borderline spectrum): exact host solve for this one
                    lam, Z = _sla.eigh(M[k, :n, :n])
                    evals[k, :n] = lam
                    ncomp[k] = n
                    Y[k, :n, :n] = Z
                    continue
                Xk = Xf[k][:n]
                # f64 Rayleigh-Ritz against the host-built scaled
                # operator M (the filtered f32 vectors carry ~1e-4 span
                # noise; cf. setup/device_setup.py refinement)
                Mk = M[k, :n, :n]
                W = Xk.T @ (Mk @ Xk)
                G = Xk.T @ Xk
                # near-dependent filtered vectors make G singular; the
                # trace-scaled ridge matches filtered_eig's internal RR
                G = G + 1e-12 * np.trace(G) / G.shape[0] \
                    * np.eye(G.shape[0])
                lam, Z = _sla.eigh(0.5 * (W + W.T), 0.5 * (G + G.T))
                evals[k, :len(lam)] = lam
                ncomp[k] = len(lam)
                Y[k, :n, :len(lam)] = Xk @ Z
        else:
            evals_d, Y_d = _eigh_batched(M_dev)
            evals = np.asarray(evals_d, dtype=np.float64)[:B]
            Y = np.asarray(Y_d, dtype=np.float64)[:B]
            ncomp = sizes.astype(np.int64)

        for k, i in enumerate(idxs):
            n = int(sizes[k])
            nc = min(int(ncomp[k]), n)
            ev = evals[k]
            truncated = use_truncated and n > truncated_threshold
            if truncated:
                kk = min(max_vectors, n, nc)
                got = 1 + int((ev[1:kk] < theta).sum())
                m = got
                skip = float(ev[kk - 1] if got == kk else max(ev[got], 0.0))
            else:
                m = max(int(np.searchsorted(ev, theta, side="right")), 1)
                m = min(m, nc)
                # skip = first eigenvalue beyond the cut; clamp to the
                # last COMPUTED Ritz value (beyond nc the entries are 1.0
                # placeholders on the filtered path)
                skip = float(ev[m] if m < nc else ev[nc - 1])
            # back to generalized eigenvectors: x = B^{-1/2} y (host, f64)
            cut[i] = dhalf[k, :n, None] * Y[k][:n, :m]
            skipped[i] = skip
            bdiags[i] = bdiag[k, :n].copy()
    return cut, skipped, bdiags
