"""Opt-in profiler hooks of the port (the JAX package's ``obs/profile.py``
on ``torch.profiler``).

Two layers, both free when unused:

- :func:`profile_trace` wraps ``torch.profiler.profile`` for a whole run
  (``serve --profile-dir``): host activity always, the card's kernels too
  when a card is in use; on exit it writes a Chrome trace (``trace.json``,
  viewable in Perfetto or ``chrome://tracing``) into the directory. A
  ``None`` directory is a null context.
- :func:`annotate` names a host span with
  ``torch.profiler.record_function`` (a plain range; the engine and the
  runtime name their phases through ``obs.phases.Marks`` instead, which
  opens such ranges only while their tracer is on: ``serve
  --profile-dir`` gives them one).
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(profile_dir: Optional[str]):
    """Profile the body into ``profile_dir/trace.json`` (Chrome trace
    format). ``None`` disables."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))


def annotate(name: str):
    """A named host span on the profiler's timeline (inert, bar one cheap
    call, when no profiler runs)."""
    return torch.profiler.record_function(name)
