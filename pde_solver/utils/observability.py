"""Tracing, profiling and logging (SURVEY.md §5 upgrades).

The reference's observability is ad-hoc ``print("[DEBUG] ...")`` markers and
stdout-suppression shims (fenics_mcp_server.py:72-159, dispatcher debug
prints :202-206).  Here:

* a real ``logging`` logger (stderr, level via PDE_LOG_LEVEL) — stdout
  stays clean for the MCP JSON-RPC channel by construction;
* :func:`phase_timer` — nested wall-clock phase timers that accumulate into
  a dict (solvers attach them to ``solver_stats``);
* :func:`device_trace` — optional ``jax.profiler`` trace capture gated by
  PDE_TRACE_DIR (written as a TensorBoard trace).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Dict, Iterator, Optional

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("pde_solver")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            logger.addHandler(handler)
        logger.setLevel(os.environ.get("PDE_LOG_LEVEL", "WARNING").upper())
        logger.propagate = False
        _LOGGER = logger
    return _LOGGER


@contextlib.contextmanager
def phase_timer(stats: Dict[str, float], name: str) -> Iterator[None]:
    """Accumulate wall time of a phase into ``stats[name + '_seconds']``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        key = f"{name}_seconds"
        stats[key] = stats.get(key, 0.0) + (time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(label: str = "solve") -> Iterator[None]:
    """Capture a jax.profiler trace when PDE_TRACE_DIR is set."""
    trace_dir = os.environ.get("PDE_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    path = os.path.join(trace_dir, label)
    os.makedirs(path, exist_ok=True)
    get_logger().info("capturing device trace into %s", path)
    with jax.profiler.trace(path):
        yield
