"""The port's `utils/profiling.py` on the CPU, beside the JAX module:
`StepTimer` gives the same summary keys and warm-up accounting for the
same step times, `annotate` names a region in the trace (nested spans
nest; with no profiler recording, and inside an export, it records
nothing), `phase` keeps bounded set-up records, and `trace` writes a
Chrome-trace JSON (host events only here; the card's kernels show where
CUDA is)."""

import glob
import json
import os
import time

import pytest
import torch

from recommenders_tpu.utils import profiling as jax_profiling
from recommenders_tpu_torch.utils import profiling
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_step_timer_matches_the_jax_timer():
    ours, theirs = profiling.StepTimer(warmup=2), jax_profiling.StepTimer(
        warmup=2)
    for i in range(5):
        for timer in (ours, theirs):
            with timer.step(batch_size=100):
                time.sleep(0.01)
    a, b = ours.summary(), theirs.summary()
    assert set(a) == set(b) == {"steps_timed", "mean_step_ms",
                                "examples_per_sec"}
    assert a["steps_timed"] == b["steps_timed"] == 3
    assert 5 <= a["mean_step_ms"] < 100
    assert abs(a["examples_per_sec"] - b["examples_per_sec"]) < 0.5 * (
        b["examples_per_sec"])


def test_step_timer_counts_examples_only_when_given():
    timer = profiling.StepTimer(warmup=0)
    with timer.step():
        pass
    assert timer.summary()["steps_timed"] == 1
    assert timer.examples_per_sec == 0.0


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    logdir = str(tmp_path / "prof")
    with profiling.trace(logdir):
        with profiling.annotate("matmul_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matmul_region" in names
    assert any("mm" in str(n) for n in names)


@pytest.fixture
def no_phases():
    profiling.clear_phases()
    yield
    profiling.clear_phases()


def _complete_events(path):
    """{name: [(start, end), ...]} of the trace's complete host events."""
    out = {}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            start = float(e["ts"])
            out.setdefault(e["name"], []).append((start,
                                                  start + float(e["dur"])))
    return out


def test_annotate_is_free_when_no_profiler_records(monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.annotate("a"), profiling.annotate("b")
    assert first is second
    with first:
        with second:
            torch.ones(4).sum()


def test_annotate_emits_nothing_when_no_profiler_records(tmp_path):
    with profiling.annotate("before_the_trace"):
        torch.ones(4).sum()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("inside_the_trace"):
            torch.ones(4).sum()
    with profiling.annotate("after_the_trace"):
        torch.ones(4).sum()
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    names = set(_complete_events(path))
    assert "inside_the_trace" in names
    assert not names & {"before_the_trace", "after_the_trace"}


def test_nested_annotations_nest_in_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum().item()
            with profiling.annotate("second"):
                torch.ones(8).sum().item()
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    spans = _complete_events(path)
    (outer,), (inner,), (second,) = (spans["outer"], spans["inner"],
                                     spans["second"])
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    assert outer[0] <= second[0] and second[1] <= outer[1]
    assert inner[1] <= second[0]


def test_phase_records_name_seconds_and_parent(no_phases):
    start = time.perf_counter()
    with profiling.phase("outer"):
        with profiling.phase("inner", device="cpu"):
            time.sleep(0.01)
        with profiling.phase("next", device=torch.device("cpu")):
            pass
    wall = time.perf_counter() - start
    inner, following, outer = profiling.phases()
    assert [p.name for p in (inner, following, outer)] == [
        "inner", "next", "outer"]
    assert (inner.parent, following.parent, outer.parent) == (
        "outer", "outer", None)
    assert 0.01 <= inner.seconds <= outer.seconds <= wall
    assert outer.start <= inner.start <= inner.end <= following.start
    assert following.end <= outer.end


def test_a_phase_that_raises_is_not_recorded(no_phases):
    with pytest.raises(ValueError):
        with profiling.phase("outer"):
            with profiling.phase("failing"):
                raise ValueError("no")
    assert profiling.phases() == []
    with profiling.phase("after"):
        pass
    (after,) = profiling.phases()
    assert after.parent is None


def test_phases_stay_bounded_and_clear(no_phases):
    for i in range(profiling.MAX_PHASES + 10):
        with profiling.phase(f"p{i}"):
            pass
    kept = profiling.phases()
    assert len(kept) == profiling.MAX_PHASES
    assert kept[0].name == "p10"
    assert kept[-1].name == f"p{profiling.MAX_PHASES + 9}"
    profiling.clear_phases()
    assert profiling.phases() == []


def test_a_phase_is_a_span_while_a_profiler_records(tmp_path, no_phases):
    with profiling.trace(str(tmp_path)):
        with profiling.phase("set_up_pass"):
            torch.ones(8).sum().item()
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    assert "set_up_pass" in _complete_events(path)
    (record,) = profiling.phases()
    assert record.name == "set_up_pass"


def test_an_export_under_a_profiler_holds_no_profiler_op(tmp_path,
                                                         monkeypatch):
    """ScaNN's `search` exported through `utils/export.py` while a
    profiler records: the trace asks for none of the program's spans, the
    program holds no profiler op, and it answers as the eager index."""
    from recommenders_tpu_torch.layers import approximate
    from recommenders_tpu_torch.utils import export as export_lib

    gen = torch.Generator().manual_seed(5)
    corpus = torch.randn(3000, 128, generator=gen)
    queries = torch.randn(8, 128, generator=gen)
    index = approximate.ScaNN(k=10, num_leaves=16, num_leaves_to_search=8,
                              quantize="int8", scoring_buckets=512,
                              probe_tile=4, device="cpu").index(corpus)
    asked = []
    record_function = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        asked.append(name)
        return record_function(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    spans = {"scann.search", "scann.probe", "scann.merge"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        export_lib.export_index(str(tmp_path), index, queries, k=10)
        assert not spans & set(asked)
        eager = index(queries, k=10)
        assert spans <= set(asked)
    program = export_lib.load_program(str(tmp_path))
    targets = [str(node.target) for node in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t
                or "record_function" in t]
    got = export_lib.load_index(str(tmp_path))(queries)
    for a, b in zip(got, eager):
        assert torch.equal(a, b)
