"""The readings the limits of `correct` are set from, on the card.

    python3 portbench/control.py --config <name> --seeds 1 2 3 ... \\
        [--seconds 2] [--out FILE]

For each seed, in one process: builds the configuration's index once,
serves each of its cells' request shapes for a short window at the
cell's own load, and judges a sample of the answers as a run does (the
program's readings); then puts the reference in the program's place,
computed at the next precision down (int4 codes for int8), and judges
its answers and stored rows the same way (the control's readings); and
the same for the reference with one fault planted (the faults'
readings): every 100th catalog row left out of the scan, for ScaNN half
of the probes, and for ScaNN a partition whose centroids no longer
match their leaves (judged, as a run would be, against a reference that
follows that partition). One JSON line a seed and cell; the limits in
`workloads/<cell>.json` lie between the program's largest and the
control's smallest reading.
"""

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import generator  # noqa: E402
from portbench.run import merged  # noqa: E402
from portbench.runners import index_serving as serving  # noqa: E402

CONTROL_BITS = {8: 4, 4: None}


def fault_readings(config: dict, state, table, sample: list, refs: list,
                   k: int, seed: int) -> dict:
    """The numbers of each planted fault of the reference in the
    program's place, on the sampled requests."""
    stored = (state.rows, state.codes, state.scales)
    queries = [qs for qs, _, _ in sample]

    def answered(cfg, st, tab):
        out = []
        for qs in queries:
            scores, rows = serving.reference_answer(cfg, st, tab, qs, k)
            out.append((qs, scores.cpu(), rows.cpu()))
        return out

    dropped = serving.Table(table.codes, table.scales.clone())
    dropped.scales[::100] = 0.0   # those rows score 0: out of every top k
    out = {"dropped_rows": serving.numbers(
        answered(config, state, dropped), stored, table, refs)}
    del dropped
    if config["index"] != "ScaNN":
        return out
    s = config["settings"]
    half = merged(config, {"settings": {
        "num_leaves_to_search": s["num_leaves_to_search"] // 2}})
    out["half_probes"] = serving.numbers(answered(half, state, table),
                                         stored, table, refs)
    gen = generator.generator(seed, generator.SAMPLE_SALT + 1,
                              state.centroids.device)
    perm = torch.randperm(state.centroids.shape[0], generator=gen,
                          device=state.centroids.device)
    wrong = dataclasses.replace(state, centroids=state.centroids[perm])
    answers = answered(config, wrong, table)
    # A run's reference follows the partition the program built.
    wrong_refs = [(a[1].to(r[0].device), a[2].to(r[0].device), r[2])
                  for a, r in zip(answers, refs)]
    out["wrong_leaves"] = serving.numbers(answers, stored, table,
                                          wrong_refs)
    return out


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def readings(config: dict, cells: list, seed: int, seconds: float,
             device: torch.device) -> list:
    catalog = generator.Catalog(config["catalog"], seed, device)
    t = time.perf_counter()
    index = serving.build_index(config, catalog, device)
    serving.sync(device)
    build_s = time.perf_counter() - t
    samples = {}
    for name, traffic, check in cells:
        q, k = traffic["queries_per_request"], traffic["k"]
        pool = catalog.requests(traffic["pool_requests"], q,
                                generator.REQUEST_SALT)
        client = serving.Client(device)
        for r in catalog.requests(traffic["warmup_requests"], q,
                                  generator.WARMUP_SALT):
            client.request(index, r, k)
        answered, start, i = [], time.perf_counter(), 0
        while time.perf_counter() - start < seconds:
            j = i % pool.shape[0]
            answered.append((j,) + client.keep(
                *client.request(index, pool[j], k)))
            i += 1
        pick = np.random.default_rng(seed).permutation(len(answered))[
            :check["requests"]]
        samples[name] = (k, [(pool[answered[p][0]], answered[p][1],
                              answered[p][2]) for p in pick])
        del pool
    code_rows = max(check["code_rows"] for _, _, check in cells)
    state = serving.take_state(index, config, catalog, code_rows, seed)
    del index
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bad_rows = serving.misstored(state, catalog.rows)
    bits = serving.bits_of(config)
    ref = serving.reference_table(config, catalog, bits)
    low = serving.reference_table(config, catalog, CONTROL_BITS[bits])
    out = []
    for name, (k, sample) in samples.items():
        refs = [serving.judge(config, state, ref, qs, k)
                for qs, _, _ in sample]
        program = serving.numbers(
            sample, (state.rows, state.codes, state.scales), ref, refs)
        controlled = []
        for qs, _, _ in sample:
            s, r = serving.reference_answer(config, state, low, qs, k)
            controlled.append((qs, s.cpu(), r.cpu()))
        control = serving.numbers(
            controlled, (state.rows, low.codes[state.rows],
                         low.scales[state.rows]), ref, refs)
        out.append({"seed": seed, "cell": name, "build_s": build_s,
                    "requests_judged": len(sample),
                    "misstored_rows": bad_rows, "program": program,
                    "control": control,
                    "faults": fault_readings(config, state, ref, sample,
                                             refs, k, seed)})
    del ref, low, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None, device=None, sizes=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sizes = sizes or {}
    manifest = load(ROOT / "BENCHMARK.json")
    entry = {c["name"]: c for c in manifest["configs"]}[args.config]
    config = merged(load(ROOT / entry["file"]),
                           sizes.get("config", {}))
    cells = []
    for w in manifest["workloads"]:
        if w["config"] == args.config:
            traffic = merged(
                load(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"),
                sizes.get("traffic", {}))
            check = merged(
                load(ROOT / "portbench" / "workloads"
                     / f"{w['name']}.json")["check"], sizes.get("check", {}))
            cells.append((w["name"], traffic, check))
    if device is None:
        if not torch.cuda.is_available():
            print("control.py needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    lines = []
    for seed in args.seeds:
        t = time.perf_counter()
        for line in readings(config, cells, seed, args.seconds, device):
            line["seconds"] = time.perf_counter() - t
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
