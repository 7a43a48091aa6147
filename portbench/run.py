"""Runs one cell of `BENCHMARK.json` on the card and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's file `portbench/workloads/<cell>.json` names its configuration
(`BENCHMARK.json`'s `configs` entry gives the file), its traffic mix
(`portbench/traffic/<mix>.json`), the size of the check and the limits of
the numbers compared. The configuration's `runner` names the module of
`portbench/runners/` that sets up, serves the window and judges it.
With `--trace 0` the result carries the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, each read by `portbench/metrics/
<name>.py` from the profiled part of the window. The last line of
standard output is the result; the numbers compared, each with its
limit, close standard error and the result.

Exits 2 without a CUDA device (or fewer than the cell asks for), 3 if
JAX or the JAX package was loaded, 1 on any other error; a result whose
`correct` is false still exits 0.
"""

import time

T0 = time.perf_counter()   # set-up counts from here: before any import

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# Build and kernel caches stay at fixed paths inside the checkout, so a
# second run of a cell finds every kernel built.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench"
                                         / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare  # noqa: E402

# Compared by whole top-level module names: the port's own name begins
# with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "recommenders_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def merged(base: dict, changes: dict) -> dict:
    """`base` with `changes` merged in, nested dicts key by key."""
    out = dict(base)
    for key, value in changes.items():
        out[key] = (merged(out[key], value) if isinstance(value, dict)
                    and isinstance(out.get(key), dict) else value)
    return out


def main(argv=None, device=None, wrap=None, t0=T0, sizes=None) -> int:
    """Runs a cell. For tests at a size the CPU holds: `device` set skips
    the look for a card, `wrap` wraps the built index (a planted fault),
    and `sizes` ({"config": ..., "traffic": ..., "check": ...}) changes
    the cell's files as they are read."""
    sizes = sizes or {}
    args = parse(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    cell = cells[args.workload]
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    workload = load_json(BENCH / "workloads" / f"{args.workload}.json")
    configs = {c["name"]: c for c in manifest["configs"]}
    config = merged(load_json(ROOT / configs[cell["config"]]["file"]),
                    sizes.get("config", {}))
    traffic = merged(load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
                     sizes.get("traffic", {}))
    workload["check"] = merged(workload["check"], sizes.get("check", {}))
    runner = importlib.import_module(f"portbench.runners.{config['runner']}")
    outcome = runner.run(config, traffic, workload["check"], args.seed,
                         args.seconds, bool(args.trace), device, t0, wrap)

    if device.type == "cuda":
        print(f"card: {power_limit()} (peaks: 989 TFLOP/s bf16 dense, "
              "3.35 TB/s, at 700 W)", file=sys.stderr)

    metrics = {}
    if args.trace:
        for entry in manifest["per_layer"]:
            if not applies(entry, args.workload):
                continue
            value = load_metric(entry["name"]).read(outcome.reading)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for entry in manifest["end_to_end"]:
            if applies(entry, args.workload):
                metrics[entry["name"]] = {
                    "value": outcome.end_to_end[entry["name"]],
                    "unit": entry["unit"]}
    limits = workload["limits"]
    correct = outcome.failed == 0 and compare.verdict(outcome.numbers,
                                                      limits)
    device_info = dict(card(device),
                       memory_peak_bytes=outcome.memory_peak_bytes)
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_info}
    if args.trace and outcome.reading is not None:
        device_info["busy_s"] = outcome.reading.trace.busy_s
        device_info["window_s"] = outcome.reading.trace.window_s
        result["breakdown"] = outcome.reading.trace.breakdown()
    result["checks"] = {n: {"value": outcome.numbers[n], "limit": limits[n]}
                        for n in limits}
    for n in limits:
        print(f"{n} {outcome.numbers[n]!r} limit {limits[n]!r}",
              file=sys.stderr)
    # Last before the result: after every metric module has been loaded.
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
