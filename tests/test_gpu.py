"""Tests that need the card: the Pallas-Triton stencil pass compiled for
the GPU (no interpret mode) against the XLA fusion, and the chip smoke
phases at a small size on the GPU.  They skip where JAX's default device
is not a GPU; run them with JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_gpu.py."""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode", ["spmv", "residual", "root"])
def test_triton_pass_matches_xla(gpu, mode):
    from saamge_jax.ops.sparse import DeviceDIA
    from saamge_jax.ops.stencil import StencilDIA
    from test_pallas_stencil import _grid_stencil
    A = _grid_stencil((17, 18, 19))
    dia = DeviceDIA.try_from_csr(A, jnp.float32)
    ops = {be: StencilDIA.from_dia(dia, dtype=jnp.bfloat16, backend=be)
           for be in ("xla", "triton")}
    rng = np.random.default_rng(0)
    x, b, d = (jnp.asarray(rng.standard_normal(A.shape[0]), jnp.float32)
               for _ in range(3))
    out = {}
    for be, p in ops.items():
        xh, bh, dh = p.pad(x), p.pad(b), p.pad(d)
        if mode == "spmv":
            out[be] = p.matvec_h(xh)
        elif mode == "residual":
            out[be] = p.residual_h(bh, xh)
        else:
            out[be] = p.root_h(jnp.asarray([0.7], jnp.float32), bh, dh, xh)
    ref = np.asarray(out["xla"])
    assert np.abs(np.asarray(out["triton"]) - ref).max() \
        <= 1e-6 * np.abs(ref).max()


def test_chip_smoke_phases_small(gpu):
    import chip_smoke
    ctx = chip_smoke.phase_structured(16)
    chip_smoke.phase_setup_dims(16)
    chip_smoke.phase_general(16)
    chip_smoke.phase_kernels(16, ctx)
