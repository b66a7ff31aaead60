"""Leveled logging + phase timers.

Replaces the reference's SA_PRINTF/SA_RPRINTF macro family (common.hpp:365-455)
and StopWatch phase instrumentation (mltest.cpp:624-625, tg.cpp:436-460).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

from saamge_jax.config import CONFIG


def sa_print(level: int, msg: str, *args) -> None:
    """Print when CONFIG.output_level >= level (SA_PRINTF_L analog)."""
    if CONFIG.output_level >= level:
        print("[saamge_jax] " + (msg % args if args else msg),
              file=CONFIG.stream, flush=True)


def sa_assert(level: int, cond, msg: str = "", *args) -> None:
    """Leveled invariant check (the reference's SA_ASSERT ladder:
    asserts compile in only under SA_IS_DEBUG_LEVEL(1),
    common.hpp:66-656; here the ladder is runtime CONFIG.debug_level).

    ``cond`` may be a bool or a ZERO-ARG CALLABLE — expensive invariants
    (O(nnz) norms, full-matrix symmetry) are passed as callables so they
    cost nothing below their ladder level.  Levels in use:
      1-5  cheap shape/contract checks (default level 5 runs them)
      6    O(N) structural invariants (coverage, disjointness)
      7+   O(nnz)+ numerical invariants (RAP symmetry, P orthonormality)
    """
    if CONFIG.debug_level < level:
        return
    ok = cond() if callable(cond) else cond
    if not ok:
        raise AssertionError(
            "sa_assert[L%d]: %s" % (level, (msg % args if args else msg)))


class PhaseTimers:
    """Accumulating named wall-clock timers (SA_*TIMER analog)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # active phase stack (innermost last) — read by observability
        # probes (e.g. run_scale_setup's RSS sampler) to attribute
        # resource peaks to a phase
        self.stack: list = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        self.stack.append(name)
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if self.stack and self.stack[-1] == name:
                self.stack.pop()
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            sa_print(4, "TIMING: %s %f seconds.", name, dt)

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def report(self) -> str:
        lines = ["TIMING report:"]
        for name in sorted(self.totals):
            lines.append("  %-40s %10.4f s  (%d calls)"
                         % (name, self.totals[name], self.counts[name]))
        return "\n".join(lines)


TIMERS = PhaseTimers()


def agg_print_stats(rels, level: int = 1) -> None:
    """agg_print_data (aggregates.hpp:698-762): AE / MIS size statistics."""
    import numpy as np
    ae_sizes = np.asarray([rels.AE_to_dof.row_size(i)
                           for i in range(rels.nparts)])
    sa_print(level, "Agglomerates: %d; dofs per AE min/avg/max: %d/%.1f/%d",
             rels.nparts, ae_sizes.min(), ae_sizes.mean(), ae_sizes.max())
    if getattr(rels, "mis_to_dof", None) is not None:
        mis_sizes = np.asarray([rels.mis_to_dof.row_size(i)
                                for i in range(rels.num_mises)])
        sa_print(level, "MISes: %d; dofs per MIS min/avg/max: %d/%.1f/%d",
                 rels.num_mises, mis_sizes.min(), mis_sizes.mean(),
                 mis_sizes.max())


class device_trace:
    """jax profiler trace context (the SA_TIMERS/jax-profiler analog):
    ``with device_trace('/tmp/trace'): ...`` writes a TensorBoard-viewable
    trace of the device work; no-op if the profiler is unavailable."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._active = False

    def __enter__(self):
        try:
            import jax
            jax.profiler.start_trace(self.logdir)
            self._active = True
        except Exception:
            pass
        return self

    def __exit__(self, *exc):
        if self._active:
            try:
                import jax
                jax.profiler.stop_trace()
            except Exception:
                pass
        return False
