"""Smoke tests for the reference-mirroring driver scripts.

The subprocesses are pinned to the CPU (JAX_PLATFORMS=cpu) so the smoke
tests are hermetic."""

import os
import subprocess
import sys

import pytest

DRIVERS = [
    ("scripts/run_mltest.py", ["--num-levels", "2"], "converged"),
    ("scripts/run_algebraic.py", ["--elems-per-agg", "128"], "iterations"),
    ("scripts/run_leastsquare.py", ["-k", "-20"], "csv_data:2,-20,2,803"),
    ("scripts/run_leastsquare_geometric.py", [], "n_iterations:"),
    ("scripts/run_upscale.py", ["--n", "16"], "upscaling energy error"),
    ("scripts/run_encapsulate.py", ["--n", "12"], "converged: True"),
    ("scripts/run_startfromcoarse.py", ["--n", "24"], '"converged": true'),
    ("scripts/run_parttest.py", [], "nparts=2"),
    ("scripts/run_partialsmooth.py", ["--n", "20", "--num-levels", "3"],
     "converged: True"),
    ("scripts/run_scale_setup.py", ["--n", "12", "--brick", "4",
                                    "--levels", "2"],
     '"peak_rss_gb"'),
    ("scripts/run_sharded.py", ["--n", "12", "--devices", "4"],
     "device-count invariance holds"),
    ("scripts/run_spmd_setup.py", ["--n", "10", "--ranks", "4",
                                   "--levels", "2"],
     "converged"),
    ("scripts/run_general_bench.py",
     ["--problem", "tet", "--refs", "1", "--elems-per-agg", "64",
      "--reps", "3", "--no-cache"],
     '"metric": "3d_general_tet'),
]


@pytest.mark.parametrize("script,args,expect",
                         DRIVERS, ids=[d[0].split("/")[-1] for d in DRIVERS])
def test_driver(script, args, expect):
    out = subprocess.run(
        [sys.executable, script, *args], capture_output=True, text=True,
        timeout=240, cwd=".",
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-800:]
    assert expect in out.stdout, out.stdout[-800:]
