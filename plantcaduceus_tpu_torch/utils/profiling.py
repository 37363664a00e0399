"""Profiling hooks on ``torch.profiler``.

Counterpart of ``plantcaduceus_tpu.utils.profiling``: a trace around a
block (:func:`trace`), a window of training steps (:class:`StepWindowProfiler`,
which the training loop steps), and the device's memory statistics
(:func:`device_memory_stats`). A trace records the host's operators and, on
a card, its kernels, and is written into ``log_dir`` as a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``, the file TensorBoard's profiler plugin
and Perfetto read).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

log = logging.getLogger(__name__)


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start(log_dir: str) -> profile:
    prof = profile(activities=_activities(), on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def _stop(prof: profile, log_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()  # on_trace_ready writes the trace
    log.info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace around a block into ``log_dir``."""
    prof = _start(str(log_dir))
    log.info("profiler trace started -> %s", log_dir)
    try:
        yield prof
    finally:
        _stop(prof, str(log_dir))


class StepWindowProfiler:
    """Trace a window of training steps: call ``.step(i)`` every iteration
    (before step ``i`` runs) and ``.close()`` at the end."""

    def __init__(self, log_dir: Optional[str], start_step: int = 10, num_steps: int = 3):
        self.log_dir = None if log_dir is None else str(log_dir)
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof: Optional[profile] = None

    def step(self, i: int) -> None:
        if self.log_dir is None:
            return
        if i == self.start and self._prof is None:
            self._prof = _start(self.log_dir)
        elif i >= self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            _stop(self._prof, self.log_dir)
            self._prof = None


def device_memory_stats() -> dict:
    """Memory statistics per card (``torch.cuda.memory_stats``), the
    MemoryMonitor analogue; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
