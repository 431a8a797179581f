"""Kernel-level tracing (the replacement for the reference's compile-time
QWEN3_TTS_TIMING instrumentation, SURVEY.md §5).

The reference wraps every scheduler call in std::chrono and prints a per-frame
breakdown table; under jit there is no per-op host boundary to time, so the
canonical artifact is a ``jax.profiler`` trace viewable in XProf/TensorBoard
(per-kernel device timings, fusion views).

    from qwen3tts_tpu.utils.profiling import trace
    with trace("/tmp/qwen3tts-trace"):
        result = tts.synthesize(...)

Stage-level wall times + RSS stay in runtime/timing.py (always on, like the
reference's tts_result counters).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2):
    """Profile the enclosed block to ``log_dir`` (TensorBoard/XProf format)."""
    options = jax.profiler.ProfileOptions()
    options.host_tracer_level = host_tracer_level
    jax.profiler.start_trace(log_dir, profiler_options=options)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return jax.profiler.TraceAnnotation(name)
