"""Hierarchy serialization (checkpoint/resume of setup products).

The reference persists setup artifacts ad hoc through binary matrix/array
file I/O (mbox_read/write_* mbox.hpp:344-516, helpers_read/write_*
helpers.hpp:138-176, testmesh dumps).  Here hierarchy serialization is
first-class (SURVEY §5): one ``.npz`` holds every level's operators
(A, P, R, Ac), smoother data, and scaling_P, enough to reconstruct the
solve-phase preconditioner (host VCycleSolver or the compiled device
hierarchy) without re-running setup.

Topology (AggPartRels) is NOT stored: it is only needed to EXTEND a
hierarchy (more levels / adaptivity), not to apply it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp


def _put_csr(store: dict, key: str, A: Optional[sp.spmatrix]) -> None:
    if A is None:
        return
    A = A.tocsr()
    store[f"{key}.data"] = A.data
    store[f"{key}.indices"] = A.indices
    store[f"{key}.indptr"] = A.indptr
    store[f"{key}.shape"] = np.asarray(A.shape)


def _get_csr(store, key: str) -> Optional[sp.csr_matrix]:
    if f"{key}.data" not in store:
        return None
    return sp.csr_matrix(
        (store[f"{key}.data"], store[f"{key}.indices"],
         store[f"{key}.indptr"]),
        shape=tuple(store[f"{key}.shape"]))


def save_hierarchy(path: str, ml) -> None:
    """Serialize an MLData solve hierarchy to ``path`` (.npz)."""
    store: dict = {"num_levels": np.asarray(len(ml.levels))}
    for i, level in enumerate(ml.levels):
        tg = level.tg_data
        p = f"level{i}"
        _put_csr(store, f"{p}.A", level.A)
        _put_csr(store, f"{p}.interp", tg.interp)
        _put_csr(store, f"{p}.restr", tg.restr)
        _put_csr(store, f"{p}.tent_interp", tg.tent_interp)
        _put_csr(store, f"{p}.Ac", tg.Ac)
        _put_csr(store, f"{p}.scaling_P", tg.scaling_P)
        store[f"{p}.dinv"] = tg.poly_data.dinv
        store[f"{p}.roots"] = tg.poly_data.roots
        store[f"{p}.theta"] = np.asarray(tg.theta)
        store[f"{p}.smooth_interp"] = np.asarray(tg.smooth_interp)
    np.savez_compressed(path, **store)


def load_hierarchy(path: str):
    """Load a solve-ready MLData (VCycleSolver/compile_hierarchy input)."""
    from saamge_jax.setup.interp import InterpData
    from saamge_jax.setup.ml import Level, MLData, ml_impose_cycle
    from saamge_jax.setup.tg import TGData
    from saamge_jax.solve.coarse import DirectSolver
    from saamge_jax.solve.smoothers import PolyData

    store = np.load(path, allow_pickle=False)
    n = int(store["num_levels"])
    ml = MLData()
    for i in range(n):
        p = f"level{i}"
        A = _get_csr(store, f"{p}.A")
        interp = _get_csr(store, f"{p}.interp")
        pd = PolyData(nu=max((len(store[f"{p}.roots"]) - 1) // 3, 0),
                      roots=store[f"{p}.roots"], dinv=store[f"{p}.dinv"])
        idata = InterpData(nparts=0, nu_pro=0,
                           interp_smoother_roots=np.zeros(0))
        tg = TGData(interp_data=idata, poly_data=pd,
                    theta=float(store[f"{p}.theta"]),
                    smooth_interp=bool(store[f"{p}.smooth_interp"]))
        tg.interp = interp
        tg.restr = _get_csr(store, f"{p}.restr")
        tg.tent_interp = _get_csr(store, f"{p}.tent_interp")
        tg.Ac = _get_csr(store, f"{p}.Ac")
        tg.scaling_P = _get_csr(store, f"{p}.scaling_P")
        ml.levels.append(Level(rels=None, tg_data=tg, A=A))
    ml_impose_cycle(ml)
    ml.coarsest.tg_data.coarse_solver = DirectSolver(ml.coarsest.tg_data.Ac)
    return ml
