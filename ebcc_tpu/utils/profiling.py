"""Profiling hooks.

Parity: the reference offers (a) per-trial TRACE logging inside its search
loops (ebcc_codec.c:554-803) — our analog is the error-vs-cut curve logged
at TRACE by the host orchestration — and (b) an ``ENABLE_PERF`` build
option wrapping ``ebcc_encode`` in prctl(PR_TASK_PERF_EVENTS_*) so an
external ``perf stat`` counts only codec work (CMakeLists.txt:21,
ebcc_codec.c:8-10).  The analog of (b) here is the JAX profiler: wrap any
codec call in :func:`trace` and inspect the trace in TensorBoard/XProf.

Enable implicitly with ``EBCC_PROFILE_DIR=/path`` — every encode/decode
call is then captured — or use the context manager explicitly.
"""

from __future__ import annotations

import contextlib
import os

PROFILE_DIR = os.environ.get("EBCC_PROFILE_DIR")


@contextlib.contextmanager
def trace(name: str = "ebcc_tpu", profile_dir: str | None = None):
    """JAX profiler trace context around codec work (no-op when no
    directory is configured)."""
    target = profile_dir or PROFILE_DIR
    if not target:
        yield
        return
    import jax

    with jax.profiler.trace(target):
        with jax.profiler.TraceAnnotation(name):
            yield


def annotate(name: str):
    """Named sub-region annotation inside an active trace."""
    import jax

    return jax.profiler.TraceAnnotation(name)
