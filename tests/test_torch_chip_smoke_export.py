"""`chip_smoke.py`'s serving phases (1-8), its ScaNN phases (9-17), and
phases 35 (export and native serving) and 36 (product quantization)
rehearsed on the CPU at a tiny size; and `tools/kernel_ab.py k3`.

The serving and ScaNN phases run once for the module (`served`): their
reports and printed lines are checked here, and phases 35-36 export and
quantize the indexes they keep. On the CPU the exports trace the
kernels' plain twins, the packages are compiled (one process each, all
at once) and the C++ host is built against the CPU wheel; every check of
the phases must pass. The CUDA path (the dispatcher ops in the exported
graphs, the host's launch counts) runs on the card.
"""

import contextlib
import dataclasses
import io
import re
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

import chip_smoke
from recommenders_tpu_torch.tools import kernel_ab
from test_torch_chip_smoke import REPORT_KEYS, ROOT
from torch_threads import torch_threads  # noqa: F401 (autouse)

SERVING_SIZE = chip_smoke.Size(users=256, items=20_000, batch=32, requests=2)
# 10 leaves for the reorder index keep every probed leaf above k rows at
# this corpus size, as 2,000 do at 1M rows.
SCANN_SIZE = chip_smoke.ScannSize(items=30_000, batch=64, requests=2,
                                  leaves=32, leaves_2000=10, users=256)


@dataclasses.dataclass
class Served:
    serving: list       # `run`'s kernel rows
    serving_out: str    # what `run` printed
    scann: list         # `scann`'s kernel rows
    scann_out: str      # what `scann` printed
    kept: dict          # what both keep for phases 35-36


@pytest.fixture(scope="module")
def served():
    cpu = torch.device("cpu")
    kept = {}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        serving = chip_smoke.run(cpu, SERVING_SIZE, 0, kept)
    with contextlib.redirect_stdout(io.StringIO()) as scann_out:
        scann = chip_smoke.scann(cpu, SCANN_SIZE, 0, kept)
    return Served(serving, out.getvalue(), scann, scann_out.getvalue(), kept)


@pytest.fixture(scope="module")
def kept(served):
    return served.kept


def test_smoke_phases_pass_on_cpu_at_a_tiny_size(served):
    size, report = SERVING_SIZE, served.serving
    assert [r["name"] for r in report] == [
        f"bucketed_scores[{fmt}]" for fmt in chip_smoke.BUCKETED
    ]
    for row in report:
        assert REPORT_KEYS <= set(row)
        assert row["route"] == "cuda"
        assert (ROOT / row["source"]).is_file()
        path, line = row["replaces"].split(":")
        # The line that defines the TPU kernel's body.
        assert (ROOT / path).read_text().splitlines()[
            int(line) - 1
        ].startswith("def _bucket_kernel")
        assert row["bound_by"] in ("bytes", "operations")
        assert row["bound_ms"] > 0
    # f32 rows' bound is six bf16 passes at the bf16 peak, every other
    # format's one; the f32 CUDA-core figure is printed beside it.
    ops = 2.0 * size.batch * size.items * chip_smoke.DIM
    for row in report:
        fmt = row["name"].split("[")[1].rstrip("]")
        passes = 6 if fmt == "f32" else 1
        assert chip_smoke.K3_PASSES[fmt] == passes
        assert row["bound_ms"] >= passes * ops / 989e12 * 1e3
    out = served.serving_out
    for name in ("build", "towers", "embed", "index", "serve", "outputs",
                 "kernels", "recall"):
        assert f"phase {name}: ok" in out
    line = re.search(r"kernel f32: .* bound (\S+) ms \(6 bf16 pass\(es\)\) "
                     r"\(f32 CUDA-core bound (\S+) ms\)", out)
    assert line is not None
    assert float(line[2]) == pytest.approx(ops / 67e12 * 1e3, rel=1e-3)


def test_scann_phases_pass_on_cpu_at_a_tiny_size(served):
    size, report = SCANN_SIZE, served.scann
    assert [r["name"] for r in report] == [
        f"{name}[{fmt}]"
        for name in ("probed_leaf_scores", "probed_bucketed_scores")
        for fmt in ("f32", "bf16", "int8", "int4")
    ]
    for row in report:
        assert REPORT_KEYS <= set(row)
        assert row["route"] == "cuda"
        assert (ROOT / row["source"]).is_file()
        path, line = row["replaces"].split(":")
        assert (ROOT / path).read_text().splitlines()[
            int(line) - 1
        ].startswith("def _kernel")
        assert row["bound_by"] in ("bytes", "operations")
        assert row["bound_ms"] > 0
        assert row["library_ms"] is None
        assert row["gather_matmul_ms"] > 0
        assert row["graph_ms"] > 0   # beside `ms`, the eager wrapper call
        assert row["max_abs_err"] == 0.0   # the twin against itself
        assert row["on_main_path"] is True   # f32 too: f32_gather, f32_bucketed
    out = served.scann_out
    for name in ("scann data", "scann build", "scann serve",
                 "scann outputs", "scann kernels", "scann recall"):
        assert f"phase {name}: ok" in out
    for name in chip_smoke.scann_configs(size):
        assert f"recall@100 {name}:" in out
    assert "0 differ beyond a tie" in out


def test_serving_phases_keep_what_phase_35_exports(kept):
    assert set(kept["serving"]["indexes"]) == {"brute_force", "int8", "f32"}
    assert set(kept["scann"]["indexes"]) == {chip_smoke.MAIN_INDEX,
                                             "int8_reorder"}
    for source, key, row in chip_smoke.EXPORTS.values():
        assert key in kept[source]["indexes"]
        assert row is None or row in chip_smoke.OP_OF_ROW


def test_export_phase_passes_on_cpu_at_a_tiny_size(kept, capsys):
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the host and the packages build with it")
    with tempfile.TemporaryDirectory() as root:
        paths = chip_smoke.export_serving(torch.device("cpu"), kept,
                                          Path(root))
    assert paths == {}   # no op library off the card
    out = capsys.readouterr().out
    assert "phase 35 export and native serving: ok" in out
    for name in chip_smoke.EXPORTS:
        assert f"  {name}: compile " in out
    assert "host bit-equal to the package in Python" in out
    assert 'empty slots decode to ""' in out


def test_product_quantization_phase_passes_on_cpu_at_a_tiny_size(kept,
                                                                  capsys):
    chip_smoke.product_quantization(torch.device("cpu"), kept, 0)
    out = capsys.readouterr().out
    assert "phase 36 product quantization: ok" in out
    for ds in chip_smoke.PQ_SUBSPACE_DIMS:
        assert f"pq ds={ds} " in out


def test_kernel_ab_k3_times_every_format_on_cpu():
    readings = kernel_ab.k3(chip_smoke, torch.device("cpu"), chip_smoke.Size(
        users=256, items=8192, batch=32, requests=1))["k3_ms"]
    assert sorted(readings) == sorted(f"K3 {f}" for f in chip_smoke.BUCKETED)
    for r in readings.values():
        assert len(r["call_ms"]) == kernel_ab.READS and r["graph_ms"] > 0


def test_export_compile_tool_fails_without_cuda():
    """`tools/export_compile.py` measures on a card only: without CUDA it
    exits non-zero and prints no readings."""
    import subprocess
    import sys

    root = Path(chip_smoke.__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, str(root / "recommenders_tpu_torch" / "tools"
                             / "export_compile.py")],
        capture_output=True, text=True, cwd=root,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
