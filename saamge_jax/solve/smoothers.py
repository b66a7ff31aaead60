"""Polynomial smoothers: root families and application.

Reference: smpr.{hpp,cpp}.  The smoother applies
x += [I - p(D^{-1}A)] A^{-1} (b - A x) realized root-by-root
(smpr_compute_poly, smpr.hpp:319-339):

    for tau in roots:  x += (1/tau) * D^{-1} (b - A x)

with D the weighted l1 diagonal d_i = sum_j |a_ij| sqrt(a_ii/a_jj)
(mbox_build_Dinv_neg_parallel_matrix, mbox.cpp:1839).

Root families (smpr.cpp:255-341):
  - oneminusx: [1]
  - sa:   sin^2(i pi/(2 nu + 1)), i=1..nu           (degree nu)
  - sas:  cos^2(i pi/(2 nu+1)), i=0..2nu  then sa   (degree 3 nu + 1, default)
  - invx: best uniform 1/x approximation (Chebyshev-based)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp


def weighted_l1_dinv(A: sp.csr_matrix) -> np.ndarray:
    """1/d with d_i = sum_j |a_ij| sqrt(a_ii/a_jj) over stored entries."""
    diag = A.diagonal()
    assert (diag > 0).all()
    Aabs = abs(A)
    y = Aabs @ (1.0 / np.sqrt(diag))
    d = np.sqrt(diag) * y
    return 1.0 / d


def sa_poly_roots(nu: int) -> np.ndarray:
    denom = 2 * nu + 1
    i = np.arange(1, nu + 1)
    return np.sin(i * np.pi / denom) ** 2


def sas_poly_roots(nu: int) -> np.ndarray:
    assert nu > 0
    denom = 2 * nu + 1
    i = np.arange(0, 2 * nu + 1)
    first = np.cos(i * np.pi / denom) ** 2
    return np.concatenate([first, sa_poly_roots(nu)])


def oneminusx_poly_roots() -> np.ndarray:
    return np.ones(1)


def _cheb(n: int, x: float) -> float:
    if n == 0:
        return 1.0
    if n == 1:
        return x
    pp, p = 1.0, x
    for _ in range(2, n + 1):
        pp, p = p, 2.0 * x * p - pp
    return p


def invx_poly_data(nu: int, a: float):
    """smpr_invx_poly_init (smpr.cpp:308): two root sets + mixing weight."""
    assert 0.0 < a < 1.0 and nu > 1
    sq = np.sqrt(a)
    t = (1 - sq) / (1 + sq)
    theta0 = -(((1 - a) ** 2) * (1 + t ** (2 * nu))) / (8 * a)
    theta1 = ((1 - a) ** 2) * (1.0 / t ** 2 + t ** (2 * nu)) / (16 * a)
    xx = -((1 + a) / (1 - a))
    tmp = (_cheb(nu, xx) * (1 + a)) / (_cheb(nu + 1, xx) * (1 - a))
    weightfirst = theta0 - 2 * theta1 * tmp
    tmp0 = (_cheb(nu + 1, xx) * (1 - a) * theta0) / (_cheb(nu, xx) * 4 * theta1)
    tau0 = (1 + a) * 0.5 - tmp0

    def tauk(nn, k):
        t_ = ((2.0 * k - 1.0) * (np.pi / 4)) / nn
        return a * np.cos(t_) ** 2 + np.sin(t_) ** 2

    roots = np.array([tauk(nu, k) for k in range(1, nu + 1)] + [tau0])
    roots2 = np.array([tauk(nu - 1, k) for k in range(1, nu)])
    return roots, roots2, weightfirst


@dataclasses.dataclass
class PolyData:
    """smpr_poly_data_t analog."""

    nu: int
    roots: np.ndarray
    dinv: np.ndarray                       # +D^{-1} (reference stores -D^{-1})
    roots2: Optional[np.ndarray] = None
    weightfirst: float = 1.0

    @property
    def degree(self) -> int:
        return len(self.roots)


def init_poly_data(A: sp.csr_matrix, nu: int, family: str = "sas",
                   param: float = 0.0) -> PolyData:
    """smpr_init_poly_data (smpr.cpp:359)."""
    dinv = weighted_l1_dinv(A)
    if family == "sas":
        return PolyData(nu, sas_poly_roots(nu), dinv)
    if family == "sa":
        return PolyData(nu, sa_poly_roots(nu), dinv)
    if family == "oneminusx":
        return PolyData(nu, oneminusx_poly_roots(), dinv)
    if family == "invx":
        roots, roots2, w = invx_poly_data(nu, param)
        return PolyData(nu, roots, dinv, roots2, w)
    raise ValueError(family)


def update_dinv(A: sp.csr_matrix, pd: PolyData) -> None:
    """smpr_update_Dinv_neg (smpr.cpp:349)."""
    pd.dinv = weighted_l1_dinv(A)


def compute_poly(A, b, x, roots, dinv):
    """x += (1/tau_i) D^{-1}(b - A x) per root (smpr_compute_poly)."""
    for tau in roots:
        x += (dinv * (b - A @ x)) / tau
    return x


def sym_poly(A, b, x, pd: PolyData):
    """smpr_sym_poly (smpr.cpp:213): the default pre/post smoother."""
    if pd.roots2 is not None and len(pd.roots2):
        y = x.copy()
        x = compute_poly(A, b, x, pd.roots, pd.dinv)
        y = compute_poly(A, b, y, pd.roots2, pd.dinv)
        return pd.weightfirst * x + (1.0 - pd.weightfirst) * y
    return compute_poly(A, b, x, pd.roots, pd.dinv)


def gauss_seidel_l1(A: sp.csr_matrix, b: np.ndarray, x: np.ndarray,
                    sweeps: int = 1, symmetric: bool = True) -> np.ndarray:
    """Hybrid l1 Gauss-Seidel (smpr_gauss_seidel, smpr.cpp:195 — hypre's
    l1GS relaxation): forward/backward triangular sweeps with the weighted
    l1 diagonal added for robustness.  Host-side alternative smoother; the
    polynomial smoothers remain the device-friendly default (triangular
    sweeps are inherently sequential)."""
    import scipy.sparse.linalg as spla
    n = A.shape[0]
    dl1 = 1.0 / weighted_l1_dinv(A)          # the l1 diagonal itself
    L = sp.tril(A, k=-1, format="csr")
    M_fwd = (L + sp.diags(dl1)).tocsr()
    U = sp.triu(A, k=1, format="csr")
    M_bwd = (U + sp.diags(dl1)).tocsr()
    for _ in range(sweeps):
        x += spla.spsolve_triangular(M_fwd, b - A @ x, lower=True)
        if symmetric:
            x += spla.spsolve_triangular(M_bwd, b - A @ x, lower=False)
    return x
