"""bench.py supervisor mechanics: a caller must ALWAYS get one JSON
line, under any budget/timeout."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), *args],
        capture_output=True, timeout=timeout, env=env, cwd=REPO)
    return r


def test_budget_overrun_still_emits_json():
    # 10 s budget cannot even finish setup: the supervisor must kill the
    # child and print the last milestone snapshot with rc 0
    r = _run(["--small", "--budget", "10", "--no-cache"], timeout=120)
    assert r.returncode == 0, r.stderr[-500:]
    line = r.stdout.decode().strip().splitlines()[-1]
    d = json.loads(line)
    assert d["extra"]["budget_exceeded"] is True
    assert {"metric", "value", "unit", "vs_baseline"} <= set(d)


def test_supervisor_never_imports_jax():
    # the measurement child must be the only JAX process on the card: the
    # supervisor (here with a stub child that exits at once) never
    # imports JAX
    code = ("import subprocess, sys\n"
            "import bench\n"
            "class Child:\n"
            "    def poll(self):\n"
            "        return 0\n"
            "subprocess.Popen = lambda *a, **k: Child()\n"
            "sys.argv = ['bench.py', '--small']\n"
            "assert bench.main() == 0\n"
            "assert 'jax' not in sys.modules, 'supervisor imported jax'\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr.decode()[-500:]
    d = json.loads(r.stdout.decode().strip().splitlines()[-1])
    assert d["extra"]["stage"] == "no_snapshot"
