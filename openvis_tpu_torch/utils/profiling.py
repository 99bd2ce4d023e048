"""Step timing and tracing of the train loop.

Port of ``openvis_tpu/utils/profiling.py``:

  * ``StepTimer`` writes one ``metrics.jsonl`` line a step: the step, the
    host rate (an EMA of steps/s), the loader's wait, the step's device time
    and its metrics.  The JAX timer reads its metrics when it ticks; here the
    step's time comes from CUDA events and the metrics stay on the device
    until ``flush``, so the loop never waits for the card between flushes
    (the caller flushes where it already waits: at a log period, a checkpoint
    or the end);
  * ``trace(logdir, device)``: a ``torch.profiler`` trace (CPU, and CUDA on a
    card) written as a Chrome trace in ``logdir``, in place of
    ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, device, name: str = "trace"):
    """Profile the enclosed steps; writes ``logdir/<name>.json``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:  # the enclosed steps' kernels finish inside the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


class StepTimer:
    """``start()`` before a step, ``tick(step, metrics, data_s)`` after it;
    ``flush()`` writes the pending steps (``log_path`` None: nothing is
    written, the records are still returned)."""

    def __init__(self, log_path: Optional[str], device, ema: float = 0.9):
        self.ema = ema
        self.rate: Optional[float] = None
        self.cuda = torch.device(device).type == "cuda"
        self._last: Optional[float] = None
        self._start = None
        self._pending: List[Dict] = []
        self._file = open(log_path, "a") if log_path else None

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def tick(self, step: int, metrics: Dict[str, torch.Tensor], data_s: float) -> None:
        now = time.perf_counter()
        if self._last is not None:
            inst = 1.0 / max(now - self._last, 1e-9)
            self.rate = inst if self.rate is None else self.ema * self.rate + (1 - self.ema) * inst
        self._last = now
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = now
        self._pending.append({"step": step, "steps_per_sec": self.rate, "data_wait_s": data_s,
                              "_span": (self._start, end), "_metrics": metrics})

    def flush(self) -> List[Dict]:
        """Waits for the pending steps and writes their lines; returns them."""
        if self.cuda and self._pending:
            torch.cuda.synchronize()
        out = []
        for rec in self._pending:
            start, end = rec.pop("_span")
            rec["step_s"] = (start.elapsed_time(end) / 1e3 if self.cuda else end - start)
            rec.update({k: float(v) for k, v in rec.pop("_metrics").items()})
            out.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")
        if self._file is not None:
            self._file.flush()
        self._pending = []
        return out

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None
