"""Mid-level brick-block operator (solve/structured.BrickBlockOp) and the
mid smoothing chain vs dense references.

BrickBlockOp.matvec (fused and per-offset rectangle paths, with and
without symmetry-halved streaming) is checked against scipy in float64;
the mid chain (structured.poly_chain over the brick-block matvec) and
the whole mid correction (structured.mid_correct) against a dense numpy
smoother (smpr_compute_poly, smpr.hpp:319-339; tg_cycle_atb's coarse
solve, tg.cpp:126)."""

import dataclasses
import types

import numpy as np
import scipy.sparse as sp
import pytest

import jax.numpy as jnp

from saamge_jax.solve.structured import (BrickBlockOp, _sym_keep,
                                         mid_correct, poly_chain)


def _brick_op(bricks, bs, seed=0, ragged_rects=False, sym=False):
    """Random brick-neighbor-coupled operator as CSR -> (BrickBlockOp,
    CSR).  ``ragged_rects`` restricts far offsets to low slots so the
    used-slot rectangles are genuinely ragged; ``sym`` symmetrizes."""
    BX, BY, BZ = bricks
    NB = BX * BY * BZ
    n = NB * bs
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    pid = np.arange(NB)
    px, py, pz = pid // (BY * BZ), (pid // BZ) % BY, pid % BZ
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                qx, qy, qz = px + dx, py + dy, pz + dz
                ok = ((0 <= qx) & (qx < BX) & (0 <= qy) & (qy < BY)
                      & (0 <= qz) & (qz < BZ))
                p_ok = pid[ok]
                q_ok = (qx * BY + qy)[ok] * BZ + qz[ok]
                far = abs(dx) + abs(dy) + abs(dz)
                r1 = bs if (far == 0 or not ragged_rects) else \
                    max(1, bs - far)
                r2 = bs if (far == 0 or not ragged_rects) else \
                    max(1, bs - 2 * far)
                for s1 in range(r1):
                    for s2 in range(r2):
                        rows.append(s1 * NB + p_ok)
                        cols.append(s2 * NB + q_ok)
                        vals.append(
                            rng.standard_normal(len(p_ok)) * 0.05
                            + (2.0 if (far == 0 and s1 == s2) else 0.0))
    A = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    if sym:
        A = ((A + A.T) * 0.5).tocsr()
    cd_brick = np.tile(np.arange(NB), bs)
    slot = np.repeat(np.arange(bs), NB)
    return BrickBlockOp.from_csr(A, cd_brick, slot, bs, bricks,
                                 dtype=jnp.float32), A


def _close(got, ref, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n).astype(np.float32)
    d = (rng.random(n) * 0.3 + 0.1).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return b, d, x


def _dense_chain(A, taus, b, d, x):
    x = x.astype(np.float64)
    for t in taus:
        x = x + d * (b - A @ x) * t
    return x


# -- matvec -------------------------------------------------------------


@pytest.mark.parametrize("bricks,bs,ragged", [
    ((10, 8, 8), 4, True),
    ((10, 8, 8), 4, False),
    ((3, 2, 2), 5, True),
    ((16, 8, 4), 3, True),
])
def test_matvec_matches_dense(bricks, bs, ragged):
    op, A = _brick_op(bricks, bs, seed=hash((bricks, bs)) % 997,
                      ragged_rects=ragged)
    x = np.random.default_rng(5).standard_normal(A.shape[0]) \
        .astype(np.float32)
    _close(op.matvec(jnp.asarray(x)), A @ x.astype(np.float64))


def test_matvec_bf16_blocks():
    """bf16 blocks: the matvec of the bf16-rounded operator (the vector
    is rounded to the block dtype too, like the storage twin)."""
    op, A = _brick_op((10, 8, 8), 4, seed=31, ragged_rects=True)
    op16 = dataclasses.replace(op, blocks=op.blocks.astype(jnp.bfloat16))
    x = np.random.default_rng(6).standard_normal(A.shape[0]) \
        .astype(np.float32)
    A16 = A.copy()
    A16.data = np.asarray(jnp.asarray(A.data, jnp.bfloat16), np.float64)
    x16 = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float64)
    _close(op16.matvec(jnp.asarray(x)), A16 @ x16)


@pytest.mark.parametrize("sym", [False, True])
def test_rect_matvec_matches_dense(sym, monkeypatch):
    """The per-offset rectangle path (forced by dropping RECT_MIN_BYTES)
    equals the fused path and scipy, with and without the symmetric
    half stream."""
    op, A = _brick_op((3, 3, 2), 4, seed=21, ragged_rects=True, sym=sym)
    op = dataclasses.replace(op, sym_stream=sym)
    x = np.random.default_rng(9).standard_normal(A.shape[0]) \
        .astype(np.float32)
    y_fused = np.asarray(op.matvec(jnp.asarray(x)))
    monkeypatch.setattr(BrickBlockOp, "RECT_MIN_BYTES", 0)
    y_rect = op.matvec(jnp.asarray(x))
    ref = A @ x.astype(np.float64)
    _close(y_rect, ref)
    _close(y_rect, y_fused)


def test_sym_stream_rect_matvec_matches(monkeypatch):
    """The sym_stream rect branch of BrickBlockOp.matvec (kept offsets
    applied forward + transposed-shifted) vs the ground truth — the
    rect regime is forced by dropping RECT_MIN_BYTES so the branch is
    exercised at test size."""
    op, Asym = _brick_op((3, 3, 2), 4, seed=33, ragged_rects=True,
                         sym=True)
    op = dataclasses.replace(op, sym_stream=True)
    monkeypatch.setattr(BrickBlockOp, "RECT_MIN_BYTES", 0)
    x = np.random.default_rng(7).standard_normal(Asym.shape[0]) \
        .astype(np.float32)
    y_ref = Asym @ x.astype(np.float64)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    _close(y, y_ref)
    # the sym stream must actually be halved vs the full rect stream
    op_full = dataclasses.replace(op, sym_stream=False)
    assert op.traffic_bytes < op_full.traffic_bytes
    _close(y, np.asarray(op_full.matvec(jnp.asarray(x))))


def test_sym_rejects_one_sided_offset():
    """An offset stored only in one direction (the hazard from_csr's
    rect symmetrization warns about) must RAISE in every sym path, not
    silently drop/fabricate the coupling (_sym_keep guard)."""
    bs, bricks = 2, (2, 2, 2)
    BX, BY, BZ = bricks
    NB = BX * BY * BZ
    n = bs * NB
    pid = np.arange(NB)
    px = pid // (BY * BZ)
    src = pid[px > 0]
    # unit diagonal on all slots + one-sided coupling p -> p - BY*BZ
    rows = [np.arange(n), src]
    cols = [np.arange(n), src - BY * BZ]
    vals = [np.ones(n), np.full(len(src), 0.5)]
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    cd_brick = np.tile(np.arange(NB), bs)
    slot = np.repeat(np.arange(bs), NB)
    op = BrickBlockOp.from_csr(A, cd_brick, slot, bs, bricks,
                               dtype=jnp.float32)
    assert any(tuple(d) == (-1, 0, 0) for d in op.doffs)
    with pytest.raises(ValueError, match="one-sided"):
        _sym_keep(op.doffs)
    with pytest.raises(ValueError, match="one-sided"):
        op._sym_keep()


# -- mid smoothing chain ------------------------------------------------


TAUS = (0.31, 0.17, 0.09, 0.23)


def _taus(vals):
    return tuple(jnp.asarray([t], jnp.float32) for t in vals)


@pytest.mark.parametrize("bricks,bs,emit_res,ragged", [
    ((3, 2, 2), 4, True, False),
    ((3, 2, 2), 4, False, False),
    ((2, 3, 4), 5, True, True),
    ((4, 4, 4), 3, False, True),
])
def test_mid_chain_matches_root_loop(bricks, bs, emit_res, ragged):
    op, A = _brick_op(bricks, bs, seed=hash((bricks, bs)) % 1000,
                      ragged_rects=ragged)
    b, d, x = _vectors(A.shape[0], 7)
    got = poly_chain(op.matvec, _taus(TAUS), jnp.asarray(d),
                     jnp.asarray(b), jnp.asarray(x))
    ref = _dense_chain(A, TAUS, b, d, x)
    _close(got, ref)
    if emit_res:
        _close(jnp.asarray(b) - op.matvec(got), b - A @ ref)


def test_mid_chain_bf16_blocks_close():
    """bf16-valued blocks relax a ~1e-2-perturbed operator (the
    mid_dtype=bfloat16 configuration)."""
    op, A = _brick_op((3, 3, 2), 4, seed=11)
    op16 = dataclasses.replace(op, blocks=op.blocks.astype(jnp.bfloat16))
    b, d, _ = _vectors(A.shape[0], 3)
    x = np.zeros_like(b)
    got = poly_chain(op16.matvec, _taus((0.3, 0.12)), jnp.asarray(d),
                     jnp.asarray(b), jnp.asarray(x))
    ref = _dense_chain(A, (0.3, 0.12), b, d, x)
    err = np.abs(np.asarray(got) - ref)
    assert err.max() <= 0.05 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("bricks,bs,ragged", [
    ((3, 2, 2), 4, False),
    ((2, 3, 4), 5, True),
    ((4, 4, 4), 3, True),
])
def test_mid_chain_symmetric_halving(bricks, bs, ragged, monkeypatch):
    """The chain over the symmetry-halved rect matvec (each kept block
    applied forward + transposed) matches the dense chain."""
    op, A = _brick_op(bricks, bs, seed=hash((bricks, bs, 5)) % 1000,
                      ragged_rects=ragged, sym=True)
    op = dataclasses.replace(op, sym_stream=True)
    monkeypatch.setattr(BrickBlockOp, "RECT_MIN_BYTES", 0)
    b, d, x = _vectors(A.shape[0], 8)
    got = poly_chain(op.matvec, _taus(TAUS[:3]), jnp.asarray(d),
                     jnp.asarray(b), jnp.asarray(x))
    _close(got, _dense_chain(A, TAUS[:3], b, d, x))


@pytest.mark.parametrize("padded_mid", [True, False],
                         ids=["brickblock", "dense"])
def test_mid_correct_matches_dense(padded_mid):
    """The whole mid correction (pre chain, coarsest R1/Ainv/R1^T
    correction, post chain) against the same sequence in dense numpy."""
    bricks, bs = (3, 2, 2), 3
    op, A = _brick_op(bricks, bs, seed=17, sym=True)
    n = A.shape[0]
    rng = np.random.default_rng(2)
    n2 = 7
    R1 = rng.standard_normal((n2, n)) * 0.2
    Ac2 = R1 @ A.toarray() @ R1.T
    Ainv = np.linalg.inv(Ac2)
    b, d, _ = _vectors(n, 4)
    m = types.SimpleNamespace(
        A1d=op if padded_mid else jnp.asarray(A.toarray(), jnp.float32),
        dinv1=jnp.asarray(d), taus1=_taus(TAUS[:2]),
        R1=jnp.asarray(R1, jnp.float32),
        Ainv=jnp.asarray(Ainv, jnp.float32), Rst1=None,
        flat_id=jnp.arange(n))
    got = mid_correct(m, jnp.asarray(b))
    x = _dense_chain(A, TAUS[:2], b, d, np.zeros(n))
    x = x + R1.T @ (Ainv @ (R1 @ (b - A @ x)))
    x = _dense_chain(A, TAUS[:2], b, d, x)
    _close(got, x, tol=1e-4)
