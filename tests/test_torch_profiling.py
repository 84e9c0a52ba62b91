"""``jefferson_tpu_torch.utils.profiling``: ``RTFMeter`` pinned to the JAX
package's on the same call sequence, ``trace`` writing a Chrome trace with
the spans it was given, and ``device_memory_report`` without a card.
"""

import io
import json
import time

import pytest
import torch

from jefferson_tpu.utils import profiling as jprof
from jefferson_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _clock(monkeypatch, ticks):
    """Both modules read the same scripted clock."""
    it = iter(ticks)
    fake = lambda: next(it)
    monkeypatch.setattr(jprof.time, "perf_counter", fake)


def test_rtf_meter_equals_the_original(monkeypatch, capsys):
    """The same start/stop/measure sequence on one scripted clock: the same
    counters, averages, real-time factor and report line."""
    ticks = [0.0, 0.0021, 1.0, 1.0031, 2.0, 2.5, 3.0, 3.0002]
    meters = {}
    for name, mod in (("jax", jprof), ("torch", tprof)):
        _clock(monkeypatch, ticks)  # time is one module object: both read it
        m = mod.RTFMeter(44_100, 128)
        m.start()
        m.stop()
        with m.measure(blocks=3):
            pass
        with pytest.raises(ZeroDivisionError):
            with m.measure(blocks=2):
                1 / 0  # noqa: B018 (the interval still closes)
        m.start()
        m.stop(blocks=0)
        with pytest.raises(RuntimeError, match="without a matching start"):
            m.stop()
        m.report("x")
        meters[name] = (m.num_calls, m.sum_s, m.avg_ms, m.rtf, capsys.readouterr().err)
    assert meters["torch"] == meters["jax"]
    assert tprof.RTFMeter().rtf == jprof.RTFMeter().rtf == float("inf")


def test_trace_writes_a_chrome_trace_with_its_spans(tmp_path):
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.span("stage.one"):
            torch.ones(64).sum()
        with tprof.span("stage.two"):
            time.sleep(0.001)
    files = list((tmp_path / "prof").glob("trace.*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"stage.one", "stage.two"} <= spans


def test_span_outside_a_trace_records_nothing():
    with tprof.span("no.trace"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0


def test_trace_that_cannot_start_runs_the_body(tmp_path, monkeypatch, capsys):
    """As the JAX bracket: a profiler that will not start prints and the
    body runs unprofiled, with no trace written."""
    def refuse(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr("torch.profiler.profile", refuse)
    ran = []
    with tprof.trace(str(tmp_path / "prof")):
        ran.append(1)
    assert ran == [1]
    assert "profiler unavailable: no profiler here" in capsys.readouterr().err
    assert not (tmp_path / "prof").exists()


def test_device_memory_report_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = io.StringIO()
    assert tprof.device_memory_report(file=out) == {}
    assert "no CUDA device" in out.getvalue()
