"""`BENCHMARK.json` and the files it names keep to the benchmark's
contract. Each test takes the root it checks (`root`: the repo's), so a
test of a copy of the harness can hold the copy to the same rules."""

import json
import re

import pytest

from portbench.tests import shared

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# Keys that name a width, which no cut may change (the model-configs
# guide, section 4): a hidden, intermediate, latent, state or projection
# size, a `_dim` or `_rank`, a head size, an expansion factor, the
# experts each token takes.
WIDTH = re.compile(r"(^dim$|_dim$|^rank$|_rank$|hidden|intermediate|latent"
                   r"|state|projection|head_size|expansion|per_tok)")
CONTRACT = ("NUMBERS", "END_TO_END", "FAULTS", "CONTROL_FAILS", "control",
            "SILENT_ON_CPU", "SILENT_ON_CARD")


@pytest.fixture
def root():
    return shared.ROOT


def test_keys_names_and_units(root):
    manifest = shared.manifest(root)
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in manifest["configs"]:
        assert NAME.match(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in manifest["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


def _widths(published, kept, where: str) -> None:
    """No width inside a cut group differs from the published one."""
    for key, value in published.items():
        if isinstance(value, dict) and isinstance(kept.get(key), dict):
            _widths(value, kept[key], f"{where}.{key}")
        elif WIDTH.search(key):
            assert kept.get(key) == value, f"{where}.{key} is a width"


def test_cuts_as_the_guide_has_them(root):
    # Each key in a configuration's `reduced` is one its file changed
    # from the source, with the published value under the file's own
    # `reduced`, and never a width; the file states its deployment.
    for c in shared.manifest(root)["configs"]:
        config = shared.config_file(c["name"], root)
        cuts = config["reduced"]
        assert cuts == [] or isinstance(cuts, dict), c["name"]
        assert c["reduced"] == list(cuts), c["name"]
        assert len(c["reduced"]) <= 16
        deployment = config.get("deployment")
        assert isinstance(deployment, str) and deployment, (
            f"{c['name']} states no deployment")
        for key in c["reduced"]:
            assert NAME.match(key), key
            assert not WIDTH.search(key), f"{c['name']}: {key} is a width"
            assert key in config and config[key] != cuts[key], (c["name"],
                                                                key)
            if isinstance(cuts[key], dict):
                _widths(cuts[key], config[key], f"{c['name']}.{key}")


def test_end_to_end_bounds_and_sources(root):
    e2e = {m["name"]: m for m in shared.manifest(root)["end_to_end"]}
    assert set(e2e) == {"qps", "request_p95_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_moves_is_reported_by_its_cells(root):
    manifest = shared.manifest(root)
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]


def test_every_name_has_its_files(root):
    # A configuration's runner, its contract and its CPU sizes; a cell's
    # traffic, and limits on just the numbers its runner compares; a
    # metric's reader. A missing file fails here by its name.
    manifest = shared.manifest(root)
    bench = root / "portbench"
    for c in manifest["configs"]:
        config = shared.load(root / c["file"])
        assert config["name"] == c["name"]
        assert config["source"] == c["source"]
        runner = config["runner"]
        assert (bench / "runners" / f"{runner}.py").exists(), runner
        contract = shared.contract(runner, root)
        missing = [n for n in CONTRACT if not hasattr(contract, n)]
        assert not missing, f"contracts/{runner}.py lacks {missing}"
    for w in manifest["workloads"]:
        cell = shared.cell_file(w["name"], root)
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert (bench / "traffic" / f"{w['traffic']}.json").exists()
        shared.tiny(w["name"], root)
        contract = shared.contract_of(w["name"], root)
        assert set(cell["limits"]) == set(contract.NUMBERS), w["name"]
        assert set(contract.CONTROL_FAILS) <= set(contract.NUMBERS)
        reported = set(shared.applied("end_to_end", w["name"], root))
        assert "setup_s" in reported and len(reported) > 1
        assert reported <= set(contract.END_TO_END), w["name"]
    for m in manifest["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").exists(), m["name"]


def _leaves(sizes: dict, prefix: str = "") -> list:
    out = []
    for key, value in sizes.items():
        if isinstance(value, dict):
            out += _leaves(value, f"{prefix}{key}.")
        else:
            out.append(f"{prefix}{key}")
    return out


def test_tiny_files_change_known_keys_and_say_why(root):
    # Every CPU size changes a key the cell's own files have, and the
    # file says in a line what each cut leaves.
    for w in shared.manifest(root)["workloads"]:
        path = root / "portbench" / "tiny" / f"{w['config']}.json"
        shared.tiny(w["name"], root)
        sizes = shared.load(path)
        assert set(sizes) <= {*shared.SIZES, "cuts"}, path.name
        have = {"config": shared.config_file(w["config"], root),
                "traffic": shared.load(root / "portbench" / "traffic"
                                       / f"{w['traffic']}.json"),
                "check": shared.cell_file(w["name"], root)["check"]}
        leaves = [f"{kind}.{leaf}" for kind in shared.SIZES
                  for leaf in _leaves(sizes.get(kind, {}))]
        assert sorted(leaves) == sorted(sizes.get("cuts", {})), path.name
        for leaf in leaves:
            node = have
            for part in leaf.split("."):
                assert isinstance(node, dict) and part in node, (path.name,
                                                                 leaf)
                node = node[part]
        for line in sizes.get("cuts", {}).values():
            assert isinstance(line, str) and line and "\n" not in line


def test_paths_and_run_length_fit_the_check(root):
    manifest = shared.manifest(root)
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    seconds = manifest["run_seconds"]
    assert 1 <= seconds <= 51
    # A full check of 24 cells: 2 + 14 runs a cell, each with 60 s of
    # room, two compiles a cell, 1200 s spare.
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_the_manifest_fits_its_size(root):
    text = (root / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    json.loads(text)
