"""The benchmark of `recommenders_tpu_torch` on an NVIDIA H100.

`run.py` runs one cell of `BENCHMARK.json`; everything that belongs to a
configuration, a traffic mix, a cell or a per-layer metric is a file of
its own under `configs/`, `traffic/`, `workloads/` and `metrics/`,
found by the name the manifest gives.

A cell of a new runner comes in by new files and appended manifest
entries alone, and changes no file that is there:

- the runner, `runners/<runner>.py`: `run(config, traffic, check, seed,
  seconds, trace, device, t0, wrap)`, which sets up, serves the window
  and judges it against a plain reference, returning the outcome
  `run.py` prints (`end_to_end`, `attempted`, `failed`, `numbers`,
  `memory_peak_bytes`, `reading`);
- its contract, `contracts/<runner>.py`: the numbers `correct` compares,
  the end-to-end metrics a run reports, the faults the timed path can
  have and the configurations each applies to, the control's readings,
  and the listed per-layer metrics a traced run at the CPU sizes cannot
  read, with the reason (`contracts/index_serving.py` says each in
  full); only the harness's tests load it;
- the configuration, `configs/<config>.json`: its `runner`, `source`,
  `deployment` and sizes, and under `reduced` each key cut from the
  source with its published value;
- the configuration's CPU sizes, `tiny/<config>.json`: the `config`,
  `traffic` and `check` values a whole run on the CPU takes, and under
  `cuts` a line for each saying what it leaves;
- the traffic mix, `traffic/<mix>.json`, where no mix there fits;
- the cell, `workloads/<cell>.json`: `config`, `traffic`, the size of
  the check and `limits` on each of the contract's numbers;
- a reader a per-layer metric, `metrics/<name>.py`: `read(reading)`,
  None where there is nothing to read;
- entries appended to `BENCHMARK.json`'s `configs`, `workloads` and
  `per_layer`.

`tests/test_portbench_second_runner.py` holds a copy of the harness to
that with a stub runner (`tests/second_runner/`, laid out the same).
"""
