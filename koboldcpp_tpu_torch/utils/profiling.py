"""Profiler hook on torch.profiler (the tracing aux subsystem).

Port of koboldcpp_tpu/utils/profiling.py: the same start / stop /
is_active contract and errors, which the server exposes at
/api/extra/profiler/{start,stop}. The reference has printf timing splits
behind --debugmode (gpttype_adapter.cpp:2467-2470); here a session records
the host ops and, on the card, every CUDA kernel (CUPTI), and `stop` writes
one Chrome / Perfetto JSON trace, `trace.json`, into the returned
directory.
"""
from __future__ import annotations

import os
import tempfile
import threading

_lock = threading.Lock()
_active_dir: str | None = None
_prof = None


def start(trace_dir: str | None = None) -> str:
    """Begin a profiler session; returns the trace directory. Raises
    RuntimeError if already tracing."""
    global _active_dir, _prof
    import torch

    with _lock:
        if _active_dir is not None:
            raise RuntimeError(f"profiler already tracing to {_active_dir}")
        d = trace_dir or tempfile.mkdtemp(prefix="kcpp_trace_")
        os.makedirs(d, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        _prof, _active_dir = prof, d
        return d


def stop() -> dict:
    """End the session and write its trace; returns {dir, files} of the
    captured artifacts."""
    global _active_dir, _prof
    import torch

    with _lock:
        if _active_dir is None:
            raise RuntimeError("profiler is not tracing")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, d = _prof, _active_dir
        _prof, _active_dir = None, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
    files: list[str] = []
    for root, _, names in os.walk(d):
        for n in names:
            files.append(os.path.relpath(os.path.join(root, n), d))
    return {"dir": d, "files": sorted(files)}


def is_active() -> bool:
    return _active_dir is not None
