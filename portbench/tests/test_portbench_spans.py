"""The readers of the program's spans and phases: each on a hand-made
trace (and hand-made phase records) gives the number counted by hand, and
nothing without its spans; a traced CPU run prints those its cell lists
and leaves out the launch spans, which the CPU twins do not record."""

import importlib.util
import json
import re
import time

import pytest
import torch

from portbench import run
from portbench import tracing
from portbench.runners import index_serving
from portbench.tests.shared import ROOT
from portbench.tests.shared import tiny
from recommenders_tpu_torch.utils import profiling

SPAN_METRICS = ("index.host_ms", "index.probe_host_ms", "ops.launch_us")
SETUP = {"setup.kmeans_s": "scann.build.kmeans",
         "setup.assign_s": "scann.build.assign",
         "setup.scatter_s": "scann.build.scatter"}


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _reading(events):
    return index_serving.Reading(tracing.read(events), {}, {})


def _requests():
    return [_span(tracing.REQUEST_SPAN, 0.0, 100.0),
            _span(tracing.REQUEST_SPAN, 100.0, 100.0)]


def _scann_events():
    """Two ScaNN requests: search 90 + 90 us, probe 15 + 20, launch
    8 + 4, and spans after the window that no reader may count."""
    return _requests() + [
        _span("scann.search", 5.0, 90.0), _span("scann.probe", 5.0, 15.0),
        _span("k5.launch", 22.0, 8.0), _span("scann.merge", 60.0, 30.0),
        _span("scann.search", 105.0, 90.0),
        _span("scann.probe", 105.0, 20.0), _span("k5.launch", 127.0, 4.0),
        _span("scann.merge", 160.0, 30.0),
        _span("scann.search", 200.0, 500.0), _span("k5.launch", 210.0, 90.0),
        # The device's copy of a span is not a host span.
        {"ph": "X", "cat": "gpu_user_annotation", "name": "k5.launch",
         "ts": 30.0, "dur": 50.0},
    ]


def _bucketed_events():
    """Two Bucketed requests: search 40 + 60 us, launch 10 + 20."""
    return _requests() + [
        _span("bucketed.search", 10.0, 40.0), _span("k3.launch", 12.0, 10.0),
        _span("bucketed.merge", 30.0, 15.0),
        _span("bucketed.search", 120.0, 60.0),
        _span("k3.launch", 125.0, 20.0),
        _span("bucketed.merge", 150.0, 25.0),
    ]


def test_span_metrics_on_a_scann_trace_by_hand():
    reading = _reading(_scann_events())
    assert _metric("index.host_ms")(reading) == pytest.approx(0.090)
    assert _metric("index.probe_host_ms")(reading) == pytest.approx(0.0175)
    assert _metric("ops.launch_us")(reading) == pytest.approx(6.0)


def test_span_metrics_on_a_bucketed_trace_by_hand():
    reading = _reading(_bucketed_events())
    assert _metric("index.host_ms")(reading) == pytest.approx(0.050)
    assert _metric("index.probe_host_ms")(reading) is None
    assert _metric("ops.launch_us")(reading) == pytest.approx(15.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_without_their_spans(name):
    assert _metric(name)(None) is None
    assert _metric(name)(_reading(_requests())) is None
    assert _metric(name)(_reading([])) is None


@pytest.fixture
def no_phases():
    profiling.clear_phases()
    yield
    profiling.clear_phases()


@pytest.mark.parametrize("name", sorted(SETUP))
def test_setup_metrics_read_the_last_build_by_hand(name, no_phases):
    reading = _reading(_scann_events())
    assert _metric(name)(reading) is None
    for pause in (0.0, 0.02):
        with profiling.phase("other"):
            pass
        with profiling.phase(SETUP[name]):
            time.sleep(pause)
    last = [p for p in profiling.phases() if p.name == SETUP[name]][-1]
    assert last.seconds >= 0.02
    assert _metric(name)(reading) == pytest.approx(last.seconds)
    assert _metric(name)(None) is None


@pytest.mark.parametrize("name", sorted(SETUP))
def test_setup_metrics_read_nothing_from_a_program_without_phases(
        name, monkeypatch, no_phases):
    with profiling.phase(SETUP[name]):
        pass
    monkeypatch.delattr(profiling, "phases")
    assert _metric(name)(_reading(_scann_events())) is None


def _traced_run(cell, capsys):
    rc = run.main(["--workload", cell, "--seed", "3000000019", "--seconds",
                   "0.6", "--trace", "1"], device=torch.device("cpu"),
                  sizes=tiny(cell))
    assert rc == 0
    captured = capsys.readouterr()
    build = float(re.search(r"build ([0-9.]+) s", captured.err).group(1))
    return json.loads(captured.out.strip().splitlines()[-1]), build


def test_a_traced_scann_run_prints_its_span_and_setup_metrics(capsys):
    result, build = _traced_run("scann-int8-100m.q256", capsys)
    metrics = result["metrics"]
    assert result["correct"]
    for name in ("index.host_ms", "index.probe_host_ms", *SETUP):
        assert metrics[name]["value"] > 0, name
    assert "ops.launch_us" not in metrics
    assert metrics["index.probe_host_ms"]["value"] < metrics[
        "index.host_ms"]["value"]
    # The log gives the build to the millisecond, rounded.
    assert sum(metrics[n]["value"] for n in SETUP) <= build + 5e-4
    assert metrics["setup.assign_s"]["unit"] == "s"


def test_a_traced_bucketed_run_prints_its_host_time(capsys):
    result, _ = _traced_run("bucketed-int8-100m.q256", capsys)
    metrics = result["metrics"]
    assert result["correct"]
    assert metrics["index.host_ms"]["value"] > 0
    assert not {"ops.launch_us", "index.probe_host_ms", *SETUP} & set(
        metrics)
