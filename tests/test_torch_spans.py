"""The spans the port records on its served paths and the phases of
ScaNN's streamed build, on the CPU: under `torch.profiler` a ScaNN
request (bucketed int8, probe tiles of 4) gives `scann.search` holding
`scann.probe` and then `scann.merge`, a Bucketed int8 request gives
`bucketed.search` holding `bucketed.merge`, the CPU twins record no
launch span, answers are the same with spans on and off, and a streamed
build records its three passes in order within its wall time."""

import json
import time

import pytest
import torch

from recommenders_tpu_torch.layers import approximate
from recommenders_tpu_torch.layers import factorized_top_k
from recommenders_tpu_torch.utils import profiling
from torch_threads import torch_threads  # noqa: F401 (autouse)

D = 128


def _data(rows, queries, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, D, generator=gen),
            torch.randn(queries, D, generator=gen))


def _scann(**settings):
    return approximate.ScaNN(k=10, num_leaves=16, num_leaves_to_search=8,
                             quantize="int8", scoring_buckets=256,
                             probe_tile=4, leaf_capacity=512, device="cpu",
                             **settings)


def _spans(tmp_path, call):
    """(what `call` returns, {name: [(start, end), ...]}) of the program
    spans a profiled call records, each list in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = {}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            start = float(e["ts"])
            spans.setdefault(e["name"], []).append(
                (start, start + float(e["dur"])))
    return out, {name: sorted(s) for name, s in spans.items()}


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.fixture(scope="module")
def scann():
    corpus, _ = _data(4000, 8, seed=1)
    return _scann().index(corpus)


@pytest.fixture(scope="module")
def bucketed():
    corpus, _ = _data(4096, 8, seed=2)
    return factorized_top_k.Bucketed(k=10, buckets=512, chunk=1024,
                                     quantize="int8", device="cpu").index(
        corpus)


def test_a_scann_request_records_probe_then_merge_inside_search(
        tmp_path, scann):
    _, queries = _data(0, 8, seed=3)
    _, spans = _spans(tmp_path, lambda: scann(queries, k=10))
    (search,), (probe,), (merge,) = (spans["scann.search"],
                                     spans["scann.probe"],
                                     spans["scann.merge"])
    assert _within(probe, search) and _within(merge, search)
    assert probe[1] <= merge[0]
    # The CPU twins launch nothing, so no launch span is recorded.
    assert not {"k5.launch", "k3.launch"} & set(spans)


def test_each_chunk_of_a_scann_request_records_its_probe_and_merge(
        tmp_path):
    corpus, queries = _data(4000, 12, seed=4)
    index = _scann(query_batch=4).index(corpus)
    _, spans = _spans(tmp_path, lambda: index(queries, k=10))
    (search,) = spans["scann.search"]
    probes, merges = spans["scann.probe"], spans["scann.merge"]
    assert len(probes) == len(merges) == 3
    for probe, merge in zip(probes, merges):
        assert _within(probe, search) and _within(merge, search)
        assert probe[1] <= merge[0]
    for merge, probe in zip(merges, probes[1:]):
        assert merge[1] <= probe[0]


def test_a_bucketed_request_records_merge_inside_search(tmp_path,
                                                         bucketed):
    _, queries = _data(0, 8, seed=5)
    _, spans = _spans(tmp_path, lambda: bucketed(queries, k=10))
    (search,), (merge,) = spans["bucketed.search"], spans["bucketed.merge"]
    assert _within(merge, search)
    assert not {"k5.launch", "k3.launch", "scann.search"} & set(spans)


@pytest.mark.parametrize("kind", ["scann", "bucketed"])
def test_answers_are_the_same_with_spans_on_and_off(tmp_path, kind,
                                                    request):
    index = request.getfixturevalue(kind)
    _, queries = _data(0, 8, seed=6)
    off = index(queries, k=10)
    on, spans = _spans(tmp_path, lambda: index(queries, k=10))
    assert f"{kind}.search" in spans
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_a_streamed_build_records_its_three_passes_in_order():
    corpus, queries = _data(4000, 8, seed=7)
    profiling.clear_phases()
    start = time.perf_counter()
    index = _scann().index_streamed(
        [corpus[i:i + 1000] for i in range(0, 4000, 1000)], num_rows=4000)
    wall = time.perf_counter() - start
    records = profiling.phases()
    profiling.clear_phases()
    assert [p.name for p in records] == [
        "scann.build.kmeans", "scann.build.assign", "scann.build.scatter"]
    assert all(p.parent is None and p.seconds > 0 for p in records)
    assert all(a.end <= b.start for a, b in zip(records, records[1:]))
    assert sum(p.seconds for p in records) <= wall
    # The phases leave the build whole: the index serves.
    scores, ids = index(queries, k=10)
    assert ids.shape == (8, 10) and bool((ids >= 0).all())
