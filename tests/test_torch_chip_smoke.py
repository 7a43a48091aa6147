"""`chip_smoke.py` rehearsed on the CPU at a tiny size.

The script's `main()` runs only where CUDA is; its phases take a device,
so here they run with `device="cpu"` (where each kernel's wrapper runs
its plain twin) on a small model. Every check of the script must pass,
and the kernels' report must carry every key the script promises.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
REPORT_KEYS = {
    "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
    "plain_ms", "bound_ms", "bound_by", "library_ms",
}


def test_smoke_phases_pass_on_cpu_at_a_tiny_size(capsys):
    size = chip_smoke.Size(users=256, items=20_000, batch=32, requests=2)
    report = chip_smoke.run(torch.device("cpu"), size, seed=0)
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
    out = capsys.readouterr().out
    for name in ("build", "towers", "embed", "index", "serve", "outputs",
                 "kernels", "recall"):
        assert f"phase {name}: ok" in out


def test_main_fails_without_cuda_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; this checks the CPU-only refusal")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr
