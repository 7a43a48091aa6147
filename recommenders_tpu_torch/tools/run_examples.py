"""Example runner: executes every ported example and reports pass/fail.

Port of `tools/run_examples.py` (the counterpart of the reference's
notebook CI harness, `tensorflow_recommenders/examples/nbtool.py:83-104`,
600 s a notebook): each `recommenders_tpu_torch/examples/<name>.py` runs
as a subprocess (`python -m recommenders_tpu_torch.examples.<name>
--device DEVICE`) with a timeout; failures print the tail of their
output. Exit code is the failure count.

Usage:
    python -m recommenders_tpu_torch.tools.run_examples               # all, on the card
    python -m recommenders_tpu_torch.tools.run_examples quickstart    # substring filter
    python -m recommenders_tpu_torch.tools.run_examples --device cpu
    python -m recommenders_tpu_torch.tools.run_examples --timeout 300

On CUDA the runner builds the port's kernels once before the first
example (`ops.cuda_build`), so no example pays the build in its budget.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


def example_names(pattern: str = "") -> list:
    return [p.stem for p in sorted((PACKAGE / "examples").glob("*.py"))
            if p.stem != "__init__" and pattern in p.name]


def build_kernels(device: str) -> float:
    """Builds every CUDA source and the op library (once; later runs
    reuse the built files); returns the seconds it took. Raises without
    a card when CUDA is asked for."""
    from recommenders_tpu_torch.ops import cuda_build
    from recommenders_tpu_torch.utils import device as device_lib

    if device_lib.resolve(device).type != "cuda":
        return 0.0
    start = time.perf_counter()
    cuda_build.build_torch_ops(cuda_build.SOURCES)
    return time.perf_counter() - start


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("filter", nargs="?", default="")
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument(
        "--budget", type=int, default=120,
        help="per-example time budget (s); overruns are reported "
        "(and FAIL the gate) even when the example passes",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="passed to every example as --device (default cuda; cpu "
        "runs them on the host)",
    )
    args = parser.parse_args(argv)

    names = example_names(args.filter)
    if not names:
        print("no examples matched", file=sys.stderr)
        return 1
    built = build_kernels(args.device)
    if built:
        print(f"kernels built in {built:.1f}s")

    failures = 0
    for name in names:
        start = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-m",
                 f"recommenders_tpu_torch.examples.{name}",
                 "--device", args.device],
                cwd=ROOT,
                capture_output=True,
                text=True,
                timeout=args.timeout,
            )
            ok = proc.returncode == 0
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-8:]
        except subprocess.TimeoutExpired:
            ok, tail = False, [f"TIMEOUT after {args.timeout}s"]
        elapsed = time.perf_counter() - start
        over = elapsed > args.budget
        status = "PASS" if ok else "FAIL"
        print(
            f"[{status}] {name}.py ({elapsed:.1f}s"
            f"{f' — OVER {args.budget}s budget' if over else ''})",
            flush=True,
        )
        if ok and over:
            failures += 1
        if not ok:
            failures += 1
            for line in tail:
                print(f"    {line}")
    print(f"{len(names) - failures}/{len(names)} examples passed")
    return failures


if __name__ == "__main__":
    sys.exit(main())
