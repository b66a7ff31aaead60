"""chip_smoke.py rehearsed on the CPU at a small size.

Phases 2-5 are functions of the problem size, so the same checks that
run on the card at n=96/48 run here at n=16 (the Pallas kernels in
interpret mode), and the four-device phases on four virtual CPU
devices.  main() itself must refuse to run without a GPU."""

import os
import sys

import pytest

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

N = 16


@pytest.fixture(scope="module")
def structured():
    return chip_smoke.phase_structured(N)


def test_phase_structured(structured):
    it6, it8 = structured["iters"]
    assert 0 < it6 <= it8
    assert structured["vcycle_f32_diff"] <= chip_smoke.VCYCLE_F32_MAX


def test_phase_setup_dims():
    dims = chip_smoke.phase_setup_dims(N)
    assert dims[0] == (N + 1) ** 3 and len(dims) == 3


def test_phase_general():
    out = chip_smoke.phase_general(N)
    assert out["iters"][1] <= out["host_iters8"] + 1


def test_phase_kernels(structured):
    res = chip_smoke.phase_kernels(N, structured, interpret=True)
    assert {"tent.R", "tent.P", "mid.matvec"} <= set(res)
    assert max(res.values()) <= chip_smoke.KERNEL_MAX


def test_main_fails_without_gpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)


def test_four_device_phases_on_cpu():
    """The --chips 4 phases on four virtual CPU devices (x-slab needs
    4 | bricks per side: n=32 with brick 8)."""
    devs = jax.devices("cpu")
    if len(devs) < 4:
        pytest.skip("needs the virtual 4-device CPU mesh")
    chip_smoke.run_four(N, 32, devs)
