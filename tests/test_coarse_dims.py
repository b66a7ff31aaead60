"""Coarse-space dimension regression at fixed theta (SURVEY §4
implication (b); BASELINE 'same coarse-space dimensions at fixed theta').

The reference publishes no machine-readable coarse dimensions (its
testmesh dumps are debugging artifacts produced at run time), so these
are SELF-golden: the dimensions our deterministic setup produced when
iteration parity with the reference ctest expectations was established
(tests/test_parity.py).  Any change to the theta-cut, MIS-SVD dedup or
tent assembly that alters the coarse space now fails loudly instead of
hiding behind a '<= reference iterations' bound."""

import numpy as np

from tests.test_parity import (ANISO, TESTMESH_COARSE, TESTMESH_PARTITION,
                               _mltest_setup, _solver)


def _dims(s):
    return [lv.tg_data.Ac.shape[0] for lv in s.ml.levels]


def test_mltest_two_level_dims():
    mesh, ess, A, b, em, _ = _mltest_setup()
    s = _solver(mesh, ess, A, em)
    assert _dims(s) == [10]


def test_mltest_three_level_dims():
    mesh, ess, A, b, em, _ = _mltest_setup()
    s = _solver(mesh, ess, A, em, num_levels=3)
    assert _dims(s) == [10, 4]


def test_mltest_order2_dims():
    mesh, ess, A, b, em, _ = _mltest_setup(order=2)
    s = _solver(mesh, ess, A, em, order=2)
    d = _dims(s)
    assert len(d) == 1 and d[0] == 14


def test_algebraic_dims():
    from saamge_jax.api import SAAMGeAlgPC
    from saamge_jax.config import SolverOptions
    from saamge_jax.setup.algebraic import read_hypre_matrix
    A = read_hypre_matrix(ANISO)
    pc = SAAMGeAlgPC(A, SolverOptions(theta=0.01, first_elems_per_agg=128,
                                      correct_nulspace=False))
    assert pc.tg.Ac.shape[0] == 133
