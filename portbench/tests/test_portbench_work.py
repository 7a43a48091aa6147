"""The yardstick's work counts against hand counts, and the trace reader
and per-layer metrics on a hand-made trace."""

import importlib.util

import pytest

from portbench import tracing
from portbench import yardstick
from portbench.runners import index_serving
from portbench.tests.shared import ROOT


def test_bucketed_work_by_hand():
    settings = {"buckets": 128, "chunk": 256}
    # 1000 rows on the 256 grid: 1024 stored; Q = 8, D = 16.
    w = yardstick.bucketed_work(settings, rows=1000, dim=16, queries=8)
    assert w["K3"]["ops"] == 2 * 8 * 1024 * 16
    assert w["K3"]["bytes"] == 8 * 16 * 4 + 1024 * (16 + 4) + 8 * 128 * 8
    assert w["flops"] == w["K3"]["ops"]


def test_scann_work_by_hand():
    settings = {"leaf_capacity": 256, "scoring_buckets": 512,
                "probe_tile": 4, "num_leaves_to_search": 3,
                "num_leaves": 10}
    # Two tiles of 4 queries: leaves {1, 2, 3} and {3, 4}; D = 8.
    w = yardstick.scann_work(settings, dim=8, queries=8,
                             tile_leaves=[[1, 2, 3], [3, 4]])
    b = 256                    # buckets clamp to the capacity
    assert w["K5"]["ops"] == 2 * 8 * 4 * (3 + 2) * 256
    assert w["K5"]["bytes"] == (4 * 256 * (8 + 4 + 4) + 8 * 8 * 4
                                + 2 * 3 * 4 + 8 * b * 8)
    assert w["flops"] == w["K5"]["ops"] + 2 * 8 * 8 * 10


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_kernel_families():
    assert yardstick.family(
        "void bucketed_int8_kernel<128, 4>(bf16 const*)") == "K3"
    assert yardstick.family("merge_splits_kernel(float const*)") == "K3"
    assert yardstick.family(
        "void probed_bucketed_int8_kernel<32>(float const*)") == "K5"
    assert yardstick.family("finalize_int8_kernel(float const*)") == "K5"
    assert yardstick.family(
        "merge_probe_splits_kernel(float const*)") == "K5"
    assert yardstick.family("void at::native::sort_kernel") is None


def _events():
    span = {"ph": "X", "cat": "user_annotation",
            "name": tracing.REQUEST_SPAN}
    return [
        dict(span, ts=0.0, dur=100.0), dict(span, ts=100.0, dur=100.0),
        # A device copy of the span must not count as a request.
        {"ph": "X", "cat": "gpu_user_annotation",
         "name": tracing.REQUEST_SPAN, "ts": 0.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "probed_bucketed_int8_kernel",
         "ts": 10.0, "dur": 60.0},
        {"ph": "X", "cat": "kernel", "name": "at::topk_kernel",
         "ts": 60.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "probed_bucketed_int8_kernel",
         "ts": 110.0, "dur": 60.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 80.0,
         "dur": 30.0},
        {"ph": "X", "cat": "user_annotation", "name": "scann.probe",
         "ts": 120.0, "dur": 4.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 190.0,
         "dur": 50.0},
    ]


def test_trace_reader_by_hand():
    trace = tracing.read(_events())
    assert trace.requests == 2
    assert trace.window_s == pytest.approx(200e-6)
    # Busy: [10, 80] ∪ [110, 170] ∪ [190, 200] (the late copy clipped).
    assert trace.busy_s == pytest.approx(140e-6)
    assert trace.seconds("K5") == pytest.approx(120e-6)
    assert trace.seconds(other=True) == pytest.approx(30e-6)
    assert trace.launches() == 3
    assert trace.spans == [("scann.probe", pytest.approx(4e-6))]
    # Gaps: [0, 10] and [170, 190] under the request span, [80, 110]
    # under aten::sort.
    assert trace.idle["aten::sort"] == pytest.approx(30e-6)
    assert trace.idle[tracing.REQUEST_SPAN] == pytest.approx(30e-6)
    ops = dict((n, s) for n, s in trace.breakdown()["device_ops"])
    assert ops["probed_bucketed_int8_kernel"] == pytest.approx(120e-6)


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_metrics_by_hand():
    trace = tracing.read(_events())
    least = 60e-6
    reading = index_serving.Reading(
        trace, {"K5": {"ops": 1.0, "bytes": 2.0, "least_s": least},
                "flops": 989e12 * 100e-6}, {})
    assert _metric("k5_roofline")(reading) == pytest.approx(50.0)
    assert _metric("k3_roofline")(reading) is None
    assert _metric("mfu")(reading) == pytest.approx(50.0)
    assert _metric("device.idle_share")(reading) == pytest.approx(30.0)
    assert _metric("index.other_device_ms")(reading) == pytest.approx(
        0.015)
    assert _metric("index.launches")(reading) == pytest.approx(1.5)


def test_metrics_read_nothing_from_an_empty_trace():
    empty = index_serving.Reading(tracing.read([]), {}, {})
    for name in ("k5_roofline", "k3_roofline", "mfu", "device.idle_share",
                 "index.other_device_ms", "index.launches"):
        assert _metric(name)(empty) is None
