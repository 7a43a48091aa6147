"""Serving a DLRM-DCNv2 ranking model: one client in a closed loop, each
request one query of S user-item pairs answered with S logits, timed
from the call until the logits are on the host.

Set-up builds the configuration's model through the port's own
constructors (`models.Ranking` over `PartialEmbedding` →
`TpuEmbedding`, `dcn.MultiLayerDCN`, `blocks.MLP`), each table drawn by
row blocks straight into its dtype through `TableConfig.initializer`,
and every weight drawn from (`--seed`, the tensor's salt) by the rule of
`reference/ranking.py` (the port's own initial draws are overwritten),
draws the request pool on the device, on the card captures the dense
stack in one CUDA graph for each request size in the pool
(`Ranking.capture`), and warms up. The window serves
the pool in order for `--seconds`. Then a sample of the answers, drawn
from the seed, is held against the reference, which redraws every
weight itself: `logit_gap`, the widest |got − ref| of a sampled request
over its largest |ref|. An answer that is not `[S]` finite f32 on the
host is malformed and counts in `failed`.

Requests: S uniform over `pairs_min`-`pairs_max`, stratified: a pool
of n requests holds the midpoints of n equal slices of that range in a
seeded order, so every seed's pool asks the same work (a mean of 400
pairs for the cell) and seeds differ in order, ids and features; each
feature's ids
Zipf (`zipf_exponent`) over its table's rows under a seeded affine
scramble (rank r → row (a·r + b) mod vocab, a prime to vocab), its
published bag size a pair; 13 dense features a pair, log1p of Exp(1).

    python3 -m portbench.runners.ranking_serving --config <name> \\
        --seeds 1 2 3

prints the control's readings (`control_readings`) on the card, one
JSON line a seed and cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from portbench import generator
from portbench import ranking_work
from portbench import tracing
from portbench.reference import ranking as ref

Tensor = torch.Tensor

SCRAMBLE_SALT = 1 << 45
# A pool drawn from `salt` draws feature t's ids from salt + FEATURE_SALT
# × (t + 1), its dense features from the next multiple; its sizes from salt.
FEATURE_SALT = 1 << 20


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def feature_names(config: dict) -> List[str]:
    return [f"cat_{t}" for t in range(len(config["vocab_sizes"]))]


def seeded_by(seed: int, device: torch.device):
    return lambda salt: generator.generator(seed, salt, device)


# --- The system under test ----------------------------------------------

def _table_initializer(config: dict, seed: int, table: int):
    """A `TableConfig.initializer` that fills the table by the reference's
    row blocks, straight into its dtype; padding rows are zero."""
    vocab = config["vocab_sizes"][table]

    def init(gen, shape, dtype, device):
        out = torch.empty(shape, dtype=dtype, device=device)
        out[vocab:].zero_()
        seeded = seeded_by(seed, out.device)
        for block, start in enumerate(range(0, vocab, ref.BLOCK_ROWS)):
            rows = ref.table_block(seeded, config, table, block, out.device)
            out[start:start + rows.shape[0]].copy_(rows)
        return out

    return init


def _dense_parameters(model, config: dict) -> dict:
    """The port's dense parameters under the reference's names."""
    out = {}
    for i, layer in enumerate(model.bottom.layers):
        out[f"bottom.{i}.weight"] = layer.weight
        out[f"bottom.{i}.bias"] = layer.bias
    cross = model.interaction
    for i in range(config["cross_layers"]):
        out[f"cross.{i}.u.weight"] = cross.dense_u[i].weight
        out[f"cross.{i}.v.weight"] = cross.dense_v[i].weight
        out[f"cross.{i}.v.bias"] = cross.dense_v[i].bias
    for i, layer in enumerate(model.top.layers):
        out[f"top.{i}.weight"] = layer.weight
        out[f"top.{i}.bias"] = layer.bias
    return out


def build_model(config: dict, seed: int, device: torch.device):
    """The configuration's `models.Ranking` on `device`, every weight the
    reference's draw, for serving (no gradients)."""
    from recommenders_tpu_torch.embedding import config as embedding_config
    from recommenders_tpu_torch.models import ranking

    stated = (config["pooled_dtype"], config["dense_dtype"], config["tf32"])
    if stated != ("float32", "float32", False):
        raise ValueError(f"the port pools and runs its dense layers in f32 "
                         f"with TF32 off; the configuration states {stated}")
    features = []
    for t, name in enumerate(feature_names(config)):
        table = embedding_config.TableConfig(
            config["vocab_sizes"][t], config["embedding_dim"],
            name=f"t_{name}", combiner=config["combiner"],
            initializer=_table_initializer(config, seed, t))
        features.append(embedding_config.FeatureConfig(table, name=name))
    model = ranking.Ranking(
        features, config["dense_features"],
        bottom_stack=ranking.mlp_stack(config["bottom_mlp"], "relu"),
        feature_interaction=ranking.multi_layer_dcn_interaction(
            config["cross_layers"], config["cross_rank"]),
        top_stack=ranking.mlp_stack(config["top_mlp"], None),
        interaction_takes_list=False, concat_dense=False, device=device,
        table_dtype=ref.table_dtype(config))
    model.eval().requires_grad_(False)
    drawn = ref.dense_weights(seeded_by(seed, device), config, device)
    params = _dense_parameters(model, config)
    if set(params) != set(drawn):
        raise RuntimeError(f"the model's dense tensors {sorted(params)} are "
                           f"not the reference's {sorted(drawn)}")
    for name, param in params.items():
        param.copy_(drawn[name])
    return model


def serve(model):
    """The served call: a batch's `[S]` logits."""
    return model.logits


# --- Requests --------------------------------------------------------------

def _scramble(config: dict, seed: int, table: int):
    """(a, b) of the affine scramble of table `table`'s rows."""
    vocab = config["vocab_sizes"][table]
    gen = generator.generator(seed, SCRAMBLE_SALT + table,
                              torch.device("cpu"))
    if vocab == 1:
        return 1, 0
    while True:
        a, b = torch.randint(0, vocab, (2,), generator=gen).tolist()
        if a > 0 and math.gcd(a, vocab) == 1:
            return a, b


def zipf_rows(u: Tensor, vocab: int, exponent: float, a: int,
              b: int) -> Tensor:
    """Rows of uniform draws `u` (f64 in [0, 1)): ranks by the continuous
    Zipf's inverse over [1, vocab + 1), then the affine scramble."""
    power = 1.0 - exponent
    span = (vocab + 1.0) ** power - 1.0
    rank = torch.floor((1.0 + u * span) ** (1.0 / power)).long() - 1
    rank = rank.clamp_(0, vocab - 1)
    return (rank * a + b) % vocab


@dataclasses.dataclass
class Requests:
    """A pool of requests: `pairs[j]` pairs from pair `starts[j]` of each
    feature's `[P, bag]` ids and the `[P, dense]` features."""
    pairs: List[int]
    starts: List[int]
    ids: List[Tensor]
    dense: Tensor

    def __len__(self):
        return len(self.pairs)

    def parts(self, j: int):
        """Request j's `(ids by feature, dense)`, views of the pool."""
        lo, hi = self.starts[j], self.starts[j] + self.pairs[j]
        return [x[lo:hi] for x in self.ids], self.dense[lo:hi]

    def batches(self, names: List[str]) -> list:
        out = []
        for j in range(len(self)):
            ids, dense = self.parts(j)
            batch = dict(zip(names, ids))
            batch["dense_features"] = dense
            out.append(batch)
        return out


def draw_requests(config: dict, traffic: dict, seed: int, salt: int,
                  count: int, device: torch.device) -> Requests:
    """`count` requests from (seed, salt), drawn on `device`."""
    cpu = torch.device("cpu")
    lo, span = traffic["pairs_min"], traffic["pairs_max"] + 1 - traffic[
        "pairs_min"]
    order = torch.randperm(count, generator=generator.generator(seed, salt,
                                                                cpu))
    pairs = [lo + (2 * int(k) + 1) * span // (2 * count) for k in order]
    starts = np.concatenate([[0], np.cumsum(pairs)[:-1]]).tolist()
    total = int(sum(pairs))
    ids = []
    for t, (vocab, bag) in enumerate(zip(config["vocab_sizes"],
                                         config["multi_hot_sizes"])):
        gen = generator.generator(seed, salt + FEATURE_SALT * (t + 1),
                                  device)
        u = torch.rand((total, bag), dtype=torch.float64, generator=gen,
                       device=device)
        ids.append(zipf_rows(u, vocab, traffic["zipf_exponent"],
                             *_scramble(config, seed, t)))
    gen = generator.generator(seed, salt + FEATURE_SALT * (len(ids) + 1),
                              device)
    dense = torch.empty((total, config["dense_features"]), device=device)
    dense.exponential_(generator=gen).log1p_()
    return Requests(pairs, starts, ids, dense)


# --- Judging ------------------------------------------------------------

def malformed(logits, pairs: int) -> bool:
    return (logits is None or not isinstance(logits, Tensor)
            or logits.device.type != "cpu" or logits.dtype != torch.float32
            or tuple(logits.shape) != (pairs,)
            or not bool(torch.isfinite(logits).all()))


def logit_gap(got: Tensor, want: Tensor) -> float:
    """max |got − want| over max |want|, for one request."""
    want = want.double().cpu()
    norm = want.abs().max().clamp_min(1e-30)
    gap = (got.double().cpu() - want).abs().max() / norm
    return float(torch.nan_to_num(gap, nan=float("inf")))


def judge(reference: "ref.Reference", answers: list, **control) -> float:
    """The widest `logit_gap` of `answers` [(ids, dense, logits)]; with
    `control`, of the reference's own answers so computed instead."""
    worst = 0.0
    for ids, dense, got in answers:
        want = reference.logits(ids, dense)
        if control:
            got = reference.logits(ids, dense, **control)
        worst = max(worst, logit_gap(got, want))
    return worst


# --- A run -----------------------------------------------------------------

@dataclasses.dataclass
class Reading:
    """What the ranking metrics read: the traced window, the least work
    of its requests, and the pooled lookup's launch counts over it."""
    trace: tracing.Trace
    work: dict
    counters: dict


@dataclasses.dataclass
class Outcome:
    end_to_end: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    reading: Optional[Reading] = None


def _launch_counters(device: torch.device) -> dict:
    from recommenders_tpu_torch.ops import cuda_build
    from recommenders_tpu_torch.ops import pooled_lookup

    out = {"wrapper.pooled_lookup":
           dict(pooled_lookup.pooled_lookup.launches_by_format)}
    if device.type == "cuda" and pooled_lookup.pooled_lookup.launches:
        out["pooled_lookup"] = cuda_build.pool_launches()
    return out


class Client:
    """The caller's side: logits land in a pinned host buffer of the
    largest request's size, reused, so a request's time holds no
    allocation of host memory."""

    def __init__(self, device: torch.device, most: int):
        self.device = device
        self.stage = torch.empty((most,), dtype=torch.float32,
                                 pin_memory=device.type == "cuda")

    def request(self, served: Callable, batch: dict, pairs: int):
        logits = served(batch)
        if (not isinstance(logits, Tensor) or logits.dtype != torch.float32
                or tuple(logits.shape) != (pairs,)):
            return logits.cpu() if isinstance(logits, Tensor) else None
        out = self.stage[:pairs]
        out.copy_(logits, non_blocking=True)
        sync(self.device)
        return out


def run(config: dict, traffic: dict, check: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, t0: float,
        wrap: Optional[Callable] = None) -> Outcome:
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("ranking_serving runs one client in a closed loop")
    t = time.perf_counter()
    marks = {"imports": t - t0}
    model = build_model(config, seed, device)
    sync(device)
    marks["model"] = time.perf_counter() - t
    t = time.perf_counter()
    names = feature_names(config)
    pool = draw_requests(config, traffic, seed, generator.REQUEST_SALT,
                         traffic["pool_requests"], device)
    warm = draw_requests(config, traffic, seed, generator.WARMUP_SALT,
                         traffic["warmup_requests"], device)
    batches, warm_batches = pool.batches(names), warm.batches(names)
    if device.type == "cuda":
        # One graph of the dense stack for each request size served.
        model.capture(set(pool.pairs) | set(warm.pairs))
    served = serve(model) if wrap is None else wrap(model)
    client = Client(device, traffic["pairs_max"])
    with torch.inference_mode():
        for j, batch in enumerate(warm_batches):
            client.request(served, batch, warm.pairs[j])
        if trace:
            # The profiler's first session pays its own start-up here.
            with torch.profiler.profile(activities=tracing.activities()):
                client.request(served, warm_batches[0], warm.pairs[0])
    sync(device)
    setup_s = time.perf_counter() - t0
    marks["requests and warm-up"] = time.perf_counter() - t
    log("setup " + ", ".join(f"{n} {v:.3f} s" for n, v in marks.items()))

    latencies, answered, first_error = [], [], None
    prof, counters, traced_n = None, {}, 0
    if trace:
        before = _launch_counters(device)
        prof = torch.profiler.profile(activities=tracing.activities())
        prof.__enter__()
    profiling = trace
    i = 0
    start = time.perf_counter()
    with torch.inference_mode():
        while True:
            now = time.perf_counter()
            if now - start >= seconds:
                break
            if profiling and now - start >= traffic["trace_seconds"]:
                prof.__exit__(None, None, None)
                counters = _delta(before, _launch_counters(device))
                traced_n, profiling = i, False
            j = i % len(pool)
            try:
                if profiling:
                    with torch.profiler.record_function(
                            tracing.REQUEST_SPAN):
                        got = client.request(served, batches[j],
                                             pool.pairs[j])
                else:
                    got = client.request(served, batches[j], pool.pairs[j])
            except Exception:  # noqa: BLE001 - a request that raises fails
                got = None
                if first_error is None:
                    first_error = traceback.format_exc()
            latencies.append(time.perf_counter() - now)
            answered.append((j, None if got is None else got.clone()))
            i += 1
    window_s = time.perf_counter() - start
    if profiling:
        prof.__exit__(None, None, None)
        counters = _delta(before, _launch_counters(device))
        traced_n = i
    if first_error is not None:
        log(f"first failed request:\n{first_error}")

    good = [(j, got) for j, got in answered
            if not malformed(got, pool.pairs[j])]
    failed = len(answered) - len(good)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    end_to_end = {
        "qps": len(good) / window_s,
        "request_p95_ms": float(np.percentile(latencies, 95) * 1e3),
        "setup_s": setup_s,
    }
    log(f"window {window_s:.6f} s: {len(answered)} requests of "
        f"{np.mean([pool.pairs[j] for j, _ in answered]):.1f} pairs on "
        f"average, {failed} failed; request ms p50 "
        f"{np.percentile(latencies, 50) * 1e3:.4f} p95 "
        f"{end_to_end['request_p95_ms']:.4f} max "
        f"{max(latencies) * 1e3:.4f}; setup {setup_s:.3f} s; peak "
        f"{memory_peak / 2**30:.3f} GiB")

    reading = None
    if trace:
        reading = _reading(config, pool, answered[:traced_n], counters,
                           prof)
    del model, served
    gc.collect()

    # The sample the reference judges, drawn from the seed.
    t = time.perf_counter()
    pick = np.random.default_rng(seed).permutation(len(good))[
        :check["requests"]]
    sample = [pool.parts(good[p][0]) + (good[p][1],) for p in pick]
    with torch.inference_mode():
        reference = ref.Reference(config, seeded_by(seed, device),
                                  [(ids, dense) for ids, dense, _ in sample],
                                  device)
        gap = judge(reference, sample) if sample else float("inf")
    sync(device)
    log(f"reference: {len(sample)} requests judged in "
        f"{time.perf_counter() - t:.3f} s; logit_gap {gap!r}")
    return Outcome(end_to_end, len(answered), failed, {"logit_gap": gap},
                   memory_peak, reading)


def _delta(before: dict, after: dict) -> dict:
    return {op: {fmt: n - before.get(op, {}).get(fmt, 0)
                 for fmt, n in fmts.items()}
            for op, fmts in after.items()}


def _reading(config: dict, pool: Requests, traced: list, counters: dict,
             prof) -> Reading:
    """The traced window's `Reading`: its profile, the least work of the
    requests it holds, and the launch counts over it."""
    t = time.perf_counter()
    trace = tracing.read_profile(prof)
    work = {"pool_bytes": 0, "pool_least_s": 0.0, "flops": 0}
    for j, _ in traced:
        for name, value in ranking_work.request_work(
                config, pool.parts(j)[0]).items():
            work[name] += value
    log(f"trace: {trace.requests} requests ({len(traced)} sent) in "
        f"{trace.window_s:.6f} s, {trace.launches()} kernels, busy "
        f"{trace.busy_s:.6f} s; least work {work}; launches {counters}; "
        f"read in {time.perf_counter() - t:.3f} s")
    return Reading(trace, work, counters)


# --- The control -----------------------------------------------------------

def control_readings(config: dict, traffic: dict, check: dict, seeds: list,
                     device: torch.device, faults: dict) -> list:
    """One dict a seed: the program's `logit_gap` on `check["requests"]`
    requests of the pool; the control's (the reference pooling in fp16);
    and each fault's: the reference's dense layers in TF32 (`tf32`), and
    every fault of `faults` planted in the program, in order (a fault
    that changes the model goes last)."""
    out = []
    names = feature_names(config)
    for seed in seeds:
        t = time.perf_counter()
        model = build_model(config, seed, device)
        pool = draw_requests(config, traffic, seed, generator.REQUEST_SALT,
                             check["requests"], device)
        batches = pool.batches(names)
        if device.type == "cuda":
            model.capture(pool.pairs)
        with torch.inference_mode():
            reference = ref.Reference(
                config, seeded_by(seed, device),
                [pool.parts(j) for j in range(len(pool))], device)

            def answers(served):
                return [pool.parts(j) + (served(batches[j]).float().cpu(),)
                        for j in range(len(pool))]

            sound = answers(serve(model))
            program = judge(reference, sound)
            control = judge(reference, sound, accumulate=torch.float16)
            found = {"tf32": {"logit_gap": judge(reference, sound,
                                                 tf32=True)}}
            for name, fault in faults.items():
                found[name] = {"logit_gap": judge(reference,
                                                  answers(fault(model)))}
        del model, reference
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out.append({"seed": seed, "requests_judged": len(pool),
                    "pairs": pool.pairs,
                    "program": {"logit_gap": program},
                    "control": {"logit_gap": control}, "faults": found,
                    "seconds": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="The control's readings of a ranking configuration's "
        "cells on the card, one JSON line a seed and cell.")
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    root = Path(__file__).resolve().parents[2]
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in manifest["configs"]}[args.config]
    config = json.loads((root / entry["file"]).read_text())
    spec = importlib.util.spec_from_file_location(
        "ranking_contract", root / "portbench" / "contracts"
        / f"{config['runner']}.py")
    contract = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(contract)
    faults = {f.__name__: f for f, holds in contract.FAULTS
              if holds(config)}
    for w in manifest["workloads"]:
        if w["config"] != args.config:
            continue
        bench = root / "portbench"
        traffic = json.loads((bench / "traffic"
                              / f"{w['traffic']}.json").read_text())
        check = json.loads((bench / "workloads"
                            / f"{w['name']}.json").read_text())["check"]
        for reading in control_readings(config, traffic, check, args.seeds,
                                        device, faults):
            line = json.dumps(dict(reading, cell=w["name"]))
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
