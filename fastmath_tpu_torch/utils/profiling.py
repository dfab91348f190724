"""Tracing and timing helpers: ``annotate``, ``trace_to`` and
``device_timer``.

PyTorch counterpart of ``fastmath_tpu/utils/profiling.py``: JAX's
profiler annotations and trace dumps become ``torch.profiler`` ones, plus
an NVTX range where CUDA is available (for an external profiler).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["annotate", "trace_to", "device_timer"]


class annotate(contextlib.ContextDecorator):
    """Named range, as a context manager or a decorator: a
    ``torch.profiler.record_function`` (it shows in :func:`trace_to`'s
    trace) and, where CUDA is available, an NVTX range."""

    def __init__(self, name: str):
        self.name = name
        self._open = []

    def __enter__(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        nvtx = torch.cuda.is_available()
        if nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._open.append((rf, nvtx))
        return self

    def __exit__(self, *exc):
        rf, nvtx = self._open.pop()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def trace_to(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA where available) and write its
    trace into ``logdir`` (``tensorboard_trace_handler``: a Chrome trace
    JSON that TensorBoard and Perfetto read). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


@contextlib.contextmanager
def device_timer(label: str = "", sink: Optional[list] = None):
    """Wall-clock timer for device work. On exit it waits for the device
    of ``t.result``'s first tensor and reads one value of it, so the time
    covers the work that made it::

        with device_timer("solve") as t:
            t.result = fn(x)
        t.elapsed  # seconds

    ``sink``: a list that gets ``(label, elapsed)``.
    """

    class _T:
        result = None
        elapsed = None

    t = _T()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        leaves = [x for x in tree_leaves(t.result) if isinstance(x, torch.Tensor)]
        if leaves:
            first = leaves[0]
            if first.is_cuda:
                torch.cuda.synchronize(first.device)
            if first.numel():
                first.reshape(-1)[0].item()
        t.elapsed = time.perf_counter() - t0
        if sink is not None:
            sink.append((label, t.elapsed))
