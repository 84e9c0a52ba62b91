"""Profiling and observability on the card.  Counterpart of
``jefferson_tpu/utils/profiling.py``.

The reference's instrumentation (SURVEY.md section 5): cudaProfilerStart/Stop
brackets -> ``trace()`` (``torch.profiler``, CPU and CUDA activities, a
Chrome trace per bracket); the sum_ms/avg_ms/num_calls counters on
SoundSource (reference: Jefferson/src/SoundSource.cuh:42-44) -> ``RTFMeter``,
a copy of the JAX package's, pinned to it by ``tests/test_torch_profiling.py``;
the GPU memory report printSize() (reference: Jefferson/src/main.cu:7-11) ->
``device_memory_report`` from the CUDA caching allocator.  ``span(name)``
marks a host stage in a trace (``torch.profiler.record_function``); outside
a ``trace`` it records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from pathlib import Path


@dataclasses.dataclass
class RTFMeter:
    """Per-block wall-clock counters: average ms/block and real-time factor."""

    sample_rate: int = 44_100
    frames_per_buffer: int = 128
    num_calls: int = 0
    sum_s: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, blocks: int = 1) -> float:
        if self._t0 is None:
            # stop-without-start (or a double stop) must not TypeError or
            # silently attribute the intervening gap to sum_s
            raise RuntimeError("RTFMeter.stop() without a matching start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.sum_s += dt
        self.num_calls += blocks
        return dt

    @contextlib.contextmanager
    def measure(self, blocks: int = 1):
        # exception-neutral: a raising body must still close the interval,
        # or a later stop() attributes the whole intervening gap
        self.start()
        try:
            yield
        finally:
            self.stop(blocks)

    @property
    def avg_ms(self) -> float:
        return 1e3 * self.sum_s / max(self.num_calls, 1)

    @property
    def rtf(self) -> float:
        """Real-time factor: >1 means faster than real time."""
        audio_s = self.num_calls * self.frames_per_buffer / self.sample_rate
        return audio_s / self.sum_s if self.sum_s else float("inf")

    def report(self, label: str = "engine", file=sys.stderr) -> None:
        print(
            f"{label}: {self.num_calls} blocks, avg {self.avg_ms:.4f} ms/block, "
            f"{self.rtf:,.1f}x real time",
            file=file,
        )


def span(name: str):
    """A named host span in the enclosing ``trace`` (a no-op outside one)."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler bracket (the cudaProfilerStart/Stop analogue): host
    spans, CUDA launches and kernels (CUDA activity where a card is
    present), written on exit as a Chrome trace
    ``<log_dir>/trace.<pid>.<ns>.json`` (chrome://tracing, Perfetto).

    As the JAX package's bracket, a profiler that will not start prints
    "profiler unavailable" and the body runs unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # profiling must never break a render
        print(f"profiler unavailable: {e}", file=sys.stderr)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            out = Path(log_dir)
            out.mkdir(parents=True, exist_ok=True)
            path = out / f"trace.{os.getpid()}.{time.time_ns()}.json"
            prof.export_chrome_trace(str(path))
            print(f"profiler trace: {path}", file=sys.stderr)


def device_memory_report(file=sys.stderr) -> dict:
    """Per-card byte counts from the CUDA caching allocator (printSize
    analogue): ``bytes_in_use`` (allocated), ``reserved`` (held by the
    allocator) and ``limit`` (the card's memory), keyed by device.  Empty,
    with a line saying so, without a card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        print("no CUDA device: no allocator stats", file=file)
        return out
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        stats = torch.cuda.memory_stats(d)
        free, total = torch.cuda.mem_get_info(d)
        rep = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "limit": int(total),
            "free": int(free),
        }
        out[str(d)] = rep
        print(f"{d}: {rep['bytes_in_use'] / 2**20:.1f} MiB in use, "
              f"{rep['reserved'] / 2**20:.1f} MiB reserved / {total / 2**20:.1f} MiB",
              file=file)
    return out
