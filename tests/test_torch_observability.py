"""PyTorch port, the observability and record-framing copies Cluster
Serving runs on, against the JAX package where both have them: the
metrics registry's Prometheus text, the pure-Python CRC-32C and the
TensorBoard event records; and the two parts rewritten for PyTorch, the
tracer's ``torch.profiler`` ties and the device telemetry gauges."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from analytics_zoo_tpu.native import crc32c as jcrc32c
from analytics_zoo_tpu.observability import metrics as jmetrics
from analytics_zoo_tpu.utils import tb_writer as jtb

from analytics_zoo_torch.observability import metrics as tmetrics
from analytics_zoo_torch.observability import telemetry
from analytics_zoo_torch.observability.tracing import Tracer
from analytics_zoo_torch.utils import tb_writer as ttb


@pytest.mark.parametrize("n", [0, 1, 31, 4096])
def test_crc32c_matches_reference(n):
    data = np.random.RandomState(n).bytes(n)
    assert ttb.crc32c(data) == jcrc32c(data)
    # chained: the running value of a split buffer is the whole's
    head = ttb.crc32c(data[:n // 2])
    assert ttb.crc32c(data[n // 2:], head) == jcrc32c(data)


@pytest.mark.parametrize("tag,value,step", [
    ("Serving Throughput", 123.25, 64), ("Total Records Number", 72.0, 72),
    ("loss", -1.5e-3, 0)])
def test_tensorboard_event_records_are_byte_identical(tag, value, step):
    wall = 1.7e9 + 0.125
    assert ttb.frame_record(ttb.encode_scalar_event(tag, value, step, wall)) \
        == jtb.frame_record(jtb.encode_scalar_event(tag, value, step, wall))
    assert ttb.frame_record(ttb.encode_file_version(wall)) == \
        jtb.frame_record(jtb.encode_file_version(wall))


def _drive(mod):
    """The same counter, gauge and histogram traffic into a fresh
    registry of either package; its exposition text."""
    reg = mod.MetricsRegistry()
    calls = reg.counter("inference_predict_total", "predict calls",
                        labels=("backend",))
    calls.labels("f32").inc()
    calls.labels("f32").inc(2)
    reg.gauge("serving_batch_fill_ratio", "fill").set(0.75)
    hist = reg.histogram("serving_request_latency_seconds", "latency")
    for v in (0.004, 0.02, 0.02, 0.3, 7.0):
        hist.observe(v)
    return reg.prometheus_text()


def test_prometheus_text_matches_reference():
    text = _drive(tmetrics)
    assert 'inference_predict_total{backend="f32"} 3' in text
    assert text == _drive(jmetrics)


def test_span_with_device_annotation_is_a_profiler_range():
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("serving_execute", device_annotation=True,
                         records=8):
            torch.ones(4).add_(1)
    assert "serving_execute" in {e.key for e in prof.key_averages()}
    (event,) = tracer.events()
    assert event["name"] == "serving_execute"
    assert event["args"] == {"records": 8} and event["dur"] >= 0


def test_profiler_trace_writes_a_chrome_trace_under_a_span(tmp_path):
    tracer = Tracer()
    with tracer.profiler_trace(str(tmp_path), name="capture"):
        with tracer.span("inner", device_annotation=True):
            torch.ones(4).mul_(2)
    with open(tmp_path / "capture.json") as f:
        trace = json.load(f)
    assert "inner" in {e.get("name") for e in trace["traceEvents"]}
    names = [e["name"] for e in tracer.events()]
    assert names == ["inner", "capture"]
    assert tracer.events()[1]["args"] == {"log_dir": str(tmp_path)}


def test_telemetry_samples_no_device_gauge_on_the_cpu(monkeypatch):
    reg = tmetrics.MetricsRegistry()
    monkeypatch.setattr(telemetry, "_context_device",
                        lambda: torch.device("cpu"))
    assert telemetry.sample_device_telemetry(reg) == {}
    monkeypatch.setattr(telemetry, "_context_device", lambda: None)
    assert telemetry.sample_device_telemetry(reg) == {}
    assert "device_bytes_in_use" not in reg.prometheus_text()


def test_telemetry_gauges_read_the_contexts_cuda_device(monkeypatch):
    """The allocator counters of the context's card, labelled by its
    index (mocked: no card is touched)."""
    asked = []

    def counter(value):
        def fn(device):
            asked.append(device)
            return value
        return fn

    monkeypatch.setattr(telemetry, "_context_device",
                        lambda: torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "memory_allocated", counter(100))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", counter(300))
    monkeypatch.setattr(torch.cuda, "memory_reserved", counter(512))
    reg = tmetrics.MetricsRegistry()
    assert telemetry.sample_device_telemetry(reg) == {
        "device_bytes_in_use{1}": 100.0,
        "device_peak_bytes_in_use{1}": 300.0,
        "device_pool_bytes{1}": 512.0}
    assert asked == [torch.device("cuda", 1)] * 3
    assert 'device_pool_bytes{device="1"} 512' in reg.prometheus_text()
