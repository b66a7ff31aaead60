"""Structured (brick) gather-free hierarchy vs the generic compiled path.

The structured path re-expresses tent P/R as per-brick dense blocks and
the coarse operator as padded brick-major DIA (solve/structured.py); it
must reproduce the generic V-cycle exactly (same preconditioner, same
PCG iteration counts)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from saamge_jax.api import SpectralAMGSolver
from saamge_jax.config import SolverOptions
from saamge_jax.fem import assemble
from saamge_jax.fem.mesh import hex_mesh
from saamge_jax.topology.part import partition_cartesian_3d
from saamge_jax.solve import compiled as C
from saamge_jax.solve.structured import (BrickGeometry, compile_structured,
                                         struct_pcg_solve,
                                         struct_vcycle_apply)


def _setup(n=8, nb=2, num_levels=2, coef=1.0):
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coef, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)
    opts = SolverOptions(num_levels=num_levels, correct_nulspace=False,
                         elems_per_agg=4, device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                         partitioning=part)
    geo = BrickGeometry((nb, nb, nb), (n // nb,) * 3)
    return s, b, geo


@pytest.mark.parametrize("num_levels", [2, 3])
def test_struct_matches_generic_vcycle(num_levels):
    s, b, geo = _setup(8, 2, num_levels)
    h_gen = C.compile_hierarchy(s.ml)
    h_st = compile_structured(s.ml, geo)
    bdev = jnp.asarray(b, jnp.float32)
    y_gen = np.asarray(C.vcycle_apply(h_gen, bdev))
    y_st = np.asarray(struct_vcycle_apply(h_st, bdev))
    # same cycle up to the coarsest-solve difference (Cholesky vs dense
    # inverse) and f32 arithmetic order
    ref = np.abs(y_gen).max()
    assert np.abs(y_gen - y_st).max() <= 5e-4 * ref


@pytest.mark.parametrize("num_levels", [2, 3])
def test_struct_pcg_iteration_parity(num_levels):
    s, b, geo = _setup(8, 2, num_levels)
    h_gen = C.compile_hierarchy(s.ml)
    h_st = compile_structured(s.ml, geo)
    bdev = jnp.asarray(b, jnp.float32)
    x1, it1, _ = C.pcg_solve(h_gen, bdev, max_iter=60)
    x2, it2, _ = struct_pcg_solve(h_st, bdev, max_iter=60)
    assert int(it2) == int(it1)
    assert np.allclose(np.asarray(x1), np.asarray(x2),
                       atol=1e-3 * np.abs(np.asarray(x1)).max())


def test_struct_pcg_runtime_tolerance_no_retrace():
    s, b, geo = _setup(8, 2, 2)
    h_st = compile_structured(s.ml, geo)
    bdev = jnp.asarray(b, jnp.float32)
    _, it_loose, _ = struct_pcg_solve(h_st, bdev, rel_tol=1e-2,
                                      max_iter=60)
    _, it_tight, _ = struct_pcg_solve(h_st, bdev, rel_tol=1e-8,
                                      max_iter=60)
    assert int(it_tight) > int(it_loose)


def test_struct_R_P_match_tent(num_levels=2):
    """apply_R / apply_P against the host tent CSR directly."""
    s, b, geo = _setup(8, 2, num_levels)
    h_st = compile_structured(s.ml, geo)
    tg0 = s.ml.levels[0].tg_data
    P = tg0.tent_interp.tocsr()
    from saamge_jax.solve.structured import coarse_brick_numbering
    cd_brick, slot, bs, _ = coarse_brick_numbering(
        s.ml.levels[0].rels, tg0.interp_data.mis_numcoarsedof)
    # slot-major padded coarse layout
    flat_id = slot * geo.num_bricks + cd_brick

    rng = np.random.default_rng(0)
    r = rng.standard_normal(P.shape[0]).astype(np.float32)
    rc_ref = P.T @ r
    rc = np.asarray(h_st.apply_R(jnp.asarray(r)))
    assert np.allclose(rc[flat_id], rc_ref, atol=1e-4 * max(
        1.0, np.abs(rc_ref).max()))
    # padded slots stay zero
    mask = np.ones(len(rc), bool)
    mask[flat_id] = False
    assert np.all(rc[mask] == 0)

    xc = rng.standard_normal(P.shape[1]).astype(np.float32)
    xc_flat = np.zeros(h_st.n_flat, dtype=np.float32)
    xc_flat[flat_id] = xc
    y_ref = P @ xc
    y = np.asarray(h_st.apply_P(jnp.asarray(xc_flat)))
    assert np.allclose(y, y_ref, atol=1e-4 * max(1.0, np.abs(y_ref).max()))


@pytest.mark.parametrize("fine_layout", ["flat", "zlane"])
@pytest.mark.parametrize("mid_format", ["dense", "brickblock"])
def test_struct_layout_variants_match(fine_layout, mid_format):
    """Every (fine layout, mid format) combination is the same
    preconditioner: identical V-cycle output (up to f32 order) and PCG
    iteration counts."""
    s, b, geo = _setup(8, 2, 3)
    h_ref = compile_structured(s.ml, geo, mid_format="dense",
                               fine_layout="flat")
    h = compile_structured(s.ml, geo, mid_format=mid_format,
                           fine_layout=fine_layout)
    bdev = jnp.asarray(b, jnp.float32)
    y_ref = np.asarray(struct_vcycle_apply(h_ref, bdev))
    y = np.asarray(struct_vcycle_apply(h, bdev))
    assert np.abs(y - y_ref).max() <= 5e-4 * np.abs(y_ref).max()
    _, it_ref, _ = struct_pcg_solve(h_ref, bdev, max_iter=60)
    _, it, _ = struct_pcg_solve(h, bdev, max_iter=60)
    assert int(it) == int(it_ref)


def test_struct_bf16_mid_level_iterations():
    """bf16 mid-level operator (bench configuration) only mildly perturbs
    the preconditioner: iteration count within +2 of the f32 variant."""
    import jax.numpy as jnp
    s, b, geo = _setup(8, 2, 3)
    h32 = compile_structured(s.ml, geo)
    h16 = compile_structured(s.ml, geo, mid_dtype=jnp.bfloat16)
    bdev = jnp.asarray(b, jnp.float32)
    _, it32, _ = struct_pcg_solve(h32, bdev, max_iter=60)
    _, it16, _ = struct_pcg_solve(h16, bdev, max_iter=60)
    assert int(it16) <= int(it32) + 2


def test_struct_full_bf16_preconditioner_iterations():
    """The full bench configuration — bf16 smoother diagonals, bf16
    Rst, bf16 mid blocks — still converges within +2 iterations of the
    all-f32 preconditioner (PCG's operator matvec stays f32; only the
    preconditioner is perturbed)."""
    s, b, geo = _setup(8, 2, 3)
    h32 = compile_structured(s.ml, geo)
    h16 = compile_structured(s.ml, geo, mid_dtype=jnp.bfloat16,
                             smoother_dtype=jnp.bfloat16,
                             rp_dtype=jnp.bfloat16)
    bdev = jnp.asarray(b, jnp.float32)
    x32, it32, _ = struct_pcg_solve(h32, bdev, max_iter=60)
    x16, it16, _ = struct_pcg_solve(h16, bdev, max_iter=60)
    assert int(it16) <= int(it32) + 2
    # both solve the SAME f32 operator to the same tolerance
    assert np.allclose(np.asarray(x16), np.asarray(x32),
                       atol=1e-3 * np.abs(np.asarray(x32)).max())


def test_extract_boxes_matches_conv_patches():
    """extract_boxes (reshape+concat overlap decomposition) must equal
    conv_general_dilated_patches window extraction for several brick
    geometries (the conv is the semantics reference; the decomposition
    replaced it for speed — CLAUDE.md round-3 facts)."""
    from saamge_jax.solve.structured import extract_boxes
    rng = np.random.default_rng(2)
    for (bricks, be) in [((2, 2, 2), (2, 2, 2)), ((3, 2, 1), (2, 3, 4)),
                         ((1, 1, 2), (5, 2, 3))]:
        nodes = tuple(B * b + 1 for B, b in zip(bricks, be))
        r3 = jnp.asarray(rng.standard_normal(nodes), jnp.float32)
        p = jax.lax.conv_general_dilated_patches(
            r3[None, None], filter_shape=tuple(b + 1 for b in be),
            window_strides=be, padding="VALID")[0]
        box = np.prod([b + 1 for b in be])
        ref = np.asarray(p.reshape(box, -1))
        got = np.asarray(extract_boxes(r3, be, bricks))
        np.testing.assert_array_equal(got, ref)


def test_structured_coarsest_restriction_matches_dense():
    """super_bricks mode (block-diagonal per-superbrick R1 tent blocks,
    build_structured_interp2) must reproduce the dense-R1 cycle: both
    apply the same tent restriction operator."""
    from saamge_jax.topology.part import partition_cartesian_bricks
    n, nb, sb = 8, 4, 2
    mesh = hex_mesh(n)
    ess = np.ones(mesh.max_bdr_attr(), dtype=np.int64)
    rng = np.random.default_rng(3)
    coefs = 10.0 ** rng.uniform(-1, 1, mesh.num_elements)
    A, b, em, _, _ = assemble.build_discrete_problem(
        mesh, coef=coefs, rhs=1.0, ess_attr_marker=ess)
    part = partition_cartesian_3d(mesh.elem_centers(), nb, nb, nb)

    def override(i):
        assert i == 1
        return partition_cartesian_bricks((nb,) * 3, (sb,) * 3)

    opts = SolverOptions(num_levels=3, correct_nulspace=False,
                         elems_per_agg=4, device_setup=False)
    s = SpectralAMGSolver(A, mesh, em, opts, ess_attr_marker=ess,
                          partitioning=part,
                          coarse_part_override=override)
    geo = BrickGeometry((nb,) * 3, (n // nb,) * 3)
    h_dense = compile_structured(s.ml, geo)
    h_st = compile_structured(s.ml, geo, super_bricks=(sb,) * 3)
    assert h_st.Rst1 is not None and h_st.R1 is None
    bdev = jnp.asarray(b, jnp.float32)
    y_d = np.asarray(struct_vcycle_apply(h_dense, bdev))
    y_s = np.asarray(struct_vcycle_apply(h_st, bdev))
    ref = np.abs(y_d).max()
    assert np.abs(y_d - y_s).max() <= 1e-5 * ref
    x1, it1, _ = struct_pcg_solve(h_dense, bdev, max_iter=60)
    x2, it2, _ = struct_pcg_solve(h_st, bdev, max_iter=60)
    assert int(it1) == int(it2)
