"""Chained haloed root passes (the fine-level smoother of the structured
and general paths) vs the host polynomial smoother: the smpr root chain
x += dinv (b - A x) / tau (smpr_compute_poly, smpr.hpp:319-339) applied
root by root, with the pre-smooth's trailing residual b - A x."""

import numpy as np
import scipy.sparse as sp
import pytest

import jax.numpy as jnp

from saamge_jax.ops.sparse import DeviceDIA
from saamge_jax.ops.stencil import StencilDIA, inv_tau_arrays


def _stencil(nx, ny, nz, seed=0):
    """Random diagonally-dominant 27-point stencil on an (nx, ny, nz)
    node grid: (CSR, DeviceDIA)."""
    N = nx * ny * nz
    offs = sorted(dx * ny * nz + dy * nz + dz
                  for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dz in (-1, 0, 1))
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((len(offs), N)) * 0.1
    vals[offs.index(0)] = 2.0 + rng.random(N)
    rows, cols, data = [], [], []
    for k, o in enumerate(offs):
        if o >= 0:
            vals[k, N - o:] = 0
        else:
            vals[k, :-o] = 0
        i = np.arange(max(0, -o), min(N, N - o))
        rows.append(i)
        cols.append(i + o)
        data.append(vals[k, i])
    A = sp.csr_matrix((np.concatenate(data),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N))
    return A, DeviceDIA(jnp.asarray(vals, jnp.float32), tuple(offs), (N, N))


def _setup(n, seed, n_roots):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n).astype(np.float32)
    d = (rng.random(n) + 0.5).astype(np.float32) * 0.3
    x = rng.standard_normal(n).astype(np.float32)
    roots = rng.random(n_roots) + 1.0
    return b, d, x, roots


def _host_chain(A, roots, b, d, x, emit_residual=False):
    x = x.astype(np.float64)
    for t in roots:
        x = x + d * (b - A @ x) / t
    return (x, b - A @ x) if emit_residual else x


def _device_chain(p, roots, b, d, x, emit_residual=False):
    bh, dh, xh = (p.pad(jnp.asarray(v)) for v in (b, d, x))
    for it in inv_tau_arrays(roots):
        xh = p.root_h(it, bh, dh, xh)
    if not emit_residual:
        return xh
    return xh, p.residual_h(bh, xh)


def _close(got, ref, tol=1e-5):
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("dims,k", [
    ((10, 10, 10), 3),
    ((6, 20, 26), 4),     # row reach 4 > one halo granule
    ((8, 8, 8), 2),
])
def test_chain_matches_host(dims, k):
    A, dia = _stencil(*dims)
    p = StencilDIA.from_dia(dia)
    b, d, x, roots = _setup(A.shape[0], 1, k)
    got_h = _device_chain(p, roots, b, d, x)
    _close(np.asarray(p.unpad(got_h)), _host_chain(A, roots, b, d, x))
    # halo rows stay zero (chainability invariant)
    gh = np.asarray(got_h)
    assert np.all(gh[:p.hr] == 0) and np.all(gh[-p.hr:] == 0)


def test_chain_residual_output():
    A, dia = _stencil(10, 10, 10)
    p = StencilDIA.from_dia(dia)
    b, d, x, roots = _setup(A.shape[0], 2, 3)
    xh, rh = _device_chain(p, roots, b, d, x, emit_residual=True)
    ref_x, ref_r = _host_chain(A, roots, b, d, x, emit_residual=True)
    _close(np.asarray(p.unpad(xh)), ref_x)
    _close(np.asarray(p.unpad(rh)), ref_r)
    gh = np.asarray(rh)
    assert np.all(gh[:p.hr] == 0) and np.all(gh[-p.hr:] == 0)


def test_chain_many_roots():
    """A long chain (6 roots, the degree of nu_relax=3 SAS) with the
    trailing residual."""
    A, dia = _stencil(10, 10, 10)
    p = StencilDIA.from_dia(dia)
    b, d, x, roots = _setup(A.shape[0], 3, 6)
    xh, rh = _device_chain(p, roots, b, d, x, emit_residual=True)
    ref_x, ref_r = _host_chain(A, roots, b, d, x, emit_residual=True)
    _close(np.asarray(p.unpad(xh)), ref_x)
    _close(np.asarray(p.unpad(rh)), ref_r)


def test_chain_single_root():
    A, dia = _stencil(8, 8, 8)
    p = StencilDIA.from_dia(dia)
    b, d, x, roots = _setup(A.shape[0], 4, 1)
    _close(np.asarray(p.unpad(_device_chain(p, roots, b, d, x))),
           _host_chain(A, roots, b, d, x))


def test_chain_bf16_twin():
    """bf16 diagonal storage (the production smoother twin) against the
    host chain on the bf16-rounded operator."""
    A, dia = _stencil(10, 10, 10)
    p = StencilDIA.from_dia(dia, dtype=jnp.bfloat16)
    A16 = A.copy()
    A16.data = np.asarray(jnp.asarray(A.data, jnp.bfloat16), np.float64)
    b, d, x, roots = _setup(A.shape[0], 5, 3)
    _close(np.asarray(p.unpad(_device_chain(p, roots, b, d, x))),
           _host_chain(A16, roots, b, d, x))
