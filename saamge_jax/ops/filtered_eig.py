"""Chebyshev-filtered batched subspace eigensolver (matmul-native).

A batched dense eigh is an iterative sweep chain that makes little use
of the matrix units, while batched matmuls run near the device's dense
rate.  The setup pipeline only needs the ~10-50 SMALLEST eigenpairs of
each (scaled) AE operator, so it uses filtered subspace iteration built
ENTIRELY from batched matmuls:

  1. Gershgorin upper bound sigma per matrix (one |M| row sum);
  2. rounds of a degree-d Chebyshev filter p(M) X via the three-term
     recurrence — p amplifies [0, a] against [a, sigma] exponentially in
     d — followed by Cholesky-QR re-orthonormalization (matmul +
     batched triangular solve);
  3. the filter cutoff a is set adaptively from a Rayleigh-Ritz estimate
     of the m-th eigenvalue after the first round;
  4. one final m x m Rayleigh-Ritz on HOST in f64 (the projected
     matrices are tiny; host LAPACK is faster than a device tiny-eigh
     and gives f64 eigenvalues for the theta cut).

This replaces the reference's per-AE LAPACK dsygv / ARPACK dispatch
(xpacks.cpp:224-315, arpacks.cpp:220) for the batched device path.
Accuracy: the subspace is exact up to filter leakage; downstream the
pipeline re-Rayleigh-Ritzes against the f64 sparse AE operators, so only
MISSED directions would matter — guarded by the m = need + margin
subspace width and the parity tests.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp


def _cheb_filter(M, X, a, sigma, degree):
    """X <- T_degree(L) X with L = (2 M - (a+sigma) I) / (sigma - a):
    |T_d| <= 1 on [a, sigma], grows like exp(2 d sqrt(a'/..)) below a.
    The degree-step recurrence is unrolled at trace time."""
    c = (a + sigma) / 2.0
    h = (sigma - a) / 2.0

    def lmap(V):
        return (jnp.einsum("bij,bjm->bim", M, V,
                           precision="highest",
                           preferred_element_type=jnp.float32)
                - c[:, None, None] * V) / h[:, None, None]

    T0 = X
    T1 = lmap(X)
    for _ in range(degree - 1):
        T0, T1 = T1, 2.0 * lmap(T1) - T0
    return T1


def _orthonormalize(X, eps=1e-6):
    """Cholesky QR (approximate at f32; the final Rayleigh-Ritz is
    generalized with the true Gram matrix, so exactness is not load
    bearing).  Measured IN COMPOSITION with the Chebyshev filter the
    wide (B, m, n) trsm costs +4.8 ms/round while an 'optimized'
    small-trsm-against-I + matmul apply costs +39.6 ms — the transposed
    output layout it induces propagates into every filter matmul.  Keep
    the direct form (xpacks_orth_set analog, xpacks.hpp:223)."""
    G = jnp.einsum("bim,bin->bmn", X, X, precision="highest",
                   preferred_element_type=jnp.float32)
    m = X.shape[2]
    G = G + eps * jnp.trace(G, axis1=1, axis2=2)[:, None, None] \
        * jnp.eye(m, dtype=X.dtype) / m
    L = jnp.linalg.cholesky(G)
    Xt = jax.lax.linalg.triangular_solve(
        L, jnp.swapaxes(X, 1, 2), left_side=True, lower=True,
        transpose_a=False)
    return jnp.swapaxes(Xt, 1, 2)


@lru_cache(maxsize=16)
def _build(n: int, m: int, degree: int, rounds: int):
    @jax.jit
    def first(M, X0, a_frac):
        absM = jnp.abs(M)
        sigma = jnp.max(jnp.sum(absM, axis=2), axis=1) * 1.01
        a = a_frac * sigma
        X = _orthonormalize(X0)
        X = _cheb_filter(M, X, a, sigma, degree)
        X = _orthonormalize(X)
        # projected T is returned for a HOST Ritz estimate: host LAPACK
        # on the tiny (B, m, m) stack is cheap and f64
        T = jnp.einsum("bim,bij,bjn->bmn", X, M, X, precision="highest",
                       preferred_element_type=jnp.float32)
        return X, sigma, T

    @jax.jit
    def rest(M, X, a, sigma):
        for _ in range(rounds - 1):
            X = _orthonormalize(_cheb_filter(M, X, a, sigma, degree))
        T = jnp.einsum("bim,bij,bjn->bmn", X, M, X, precision="highest",
                       preferred_element_type=jnp.float32)
        G = jnp.einsum("bim,bin->bmn", X, X, precision="highest",
                       preferred_element_type=jnp.float32)
        return X, T, G

    return first, rest


def batched_smallest_eigs(M, m: int, degree: int = 16, rounds: int = 4,
                          a_frac: float = 0.05, seed: int = 0):
    """Approximate the m smallest eigenpairs of each SPD matrix in the
    (B, n, n) f32 stack.  Returns (evals (B, m) f64 host, X (B, n, m)
    device f32, res (B, m) f64 host) with eigenvalues ascending; res is
    the RELATIVE eigenpair residual ||M x - w x|| / sigma per pair
    (sigma = Gershgorin bound), the per-chunk guard against silently
    dropped directions near a borderline theta cut (theta-cut
    sensitivity, reference spectral.hpp:32-60).
    Callers should route matrices whose sub-cut pairs exceed a few
    percent to the exact path."""
    import time as _time
    from saamge_jax.utils.logging import sa_print
    B, n, _ = M.shape
    first, rest = _build(n, m, degree, rounds)
    rng = np.random.default_rng(seed)
    X0 = jnp.asarray(rng.standard_normal((B, n, m)), jnp.float32)
    _t0 = _time.perf_counter()
    X, sigma, T1 = first(M, X0, jnp.float32(a_frac))
    T1h = np.asarray(T1, np.float64)
    ew = np.linalg.eigvalsh(0.5 * (T1h + T1h.transpose(0, 2, 1)))
    # adaptive cutoff: just above the m-th Ritz value but CLAMPED well
    # below sigma — with m much wider than the wanted low cluster the
    # m-th Ritz value sits in the spectral bulk, and a cutoff near sigma
    # makes the filter a no-op (measured 5e-3 span error on the lowest
    # modes).  The clamp keeps exponential suppression of the bulk; the
    # low cluster (what the theta cut uses) converges fastest.
    ew_host = ew
    sa_print(5, "filtered_eig first(): %.1fs", _time.perf_counter() - _t0)
    a = np.minimum(np.maximum(ew_host[:, -1] * 1.5, 1e-8),
                   np.asarray(sigma, np.float64) * 0.05)
    _t0 = _time.perf_counter()
    X, T, G = rest(M, X, jnp.asarray(a, jnp.float32), sigma)
    T_host = np.asarray(T, np.float64)
    G_host = np.asarray(G, np.float64)
    sa_print(5, "filtered_eig rest()+fetch: %.1fs",
             _time.perf_counter() - _t0)
    # generalized host RR: the NS orthonormalization is approximate, so
    # solve T z = w G z per matrix (scipy, tiny matrices)
    import scipy.linalg as _sla
    w = np.empty((B, m))
    V = np.empty((B, m, m))
    for k in range(B):
        Gk = 0.5 * (G_host[k] + G_host[k].T)
        Gk = Gk + 1e-12 * np.trace(Gk) / m * np.eye(m)
        wk, vk = _sla.eigh(0.5 * (T_host[k] + T_host[k].T), Gk)
        w[k], V[k] = wk, vk
    Xr = jnp.einsum("bim,bmn->bin", X, jnp.asarray(V, jnp.float32),
                    precision="highest", preferred_element_type=jnp.float32)
    res = _residuals(M, Xr, jnp.asarray(w, jnp.float32))
    resh = np.asarray(res, np.float64) \
        / np.maximum(np.asarray(sigma, np.float64)[:, None], 1e-30)
    return w, Xr, resh


@jax.jit
def _residuals(M, X, w):
    """Per-pair residual norms ||M x_k - w_k x_k||_2, (B, m)."""
    R = jnp.einsum("bij,bjm->bim", M, X, precision="highest",
                   preferred_element_type=jnp.float32) \
        - X * w[:, None, :]
    nx = jnp.sqrt(jnp.maximum(jnp.sum(X * X, axis=1), 1e-30))
    return jnp.sqrt(jnp.sum(R * R, axis=1)) / nx
