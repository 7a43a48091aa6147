"""`chip_smoke.py`'s distributed phases (33: a one-rank group, 34: four
ranks sharing one device through gloo) rehearsed on the CPU at a tiny
size: every sharded path against its unsharded counterpart, as on the
card (where the kernels run and must launch)."""

import torch

import chip_smoke


def tiny_size():
    return chip_smoke.ParallelSize(
        serving=chip_smoke.Size(users=256, items=8_192, batch=32,
                                requests=1),
        scann=chip_smoke.ScannSize(items=12_000, batch=64, requests=1,
                                   leaves=32, leaves_2000=16, users=256),
        train=chip_smoke.TrainSize(users=512, items=1024, dim=16, batch=64),
        trainer=chip_smoke.TrainerSize(users=256, items=512, dim=16,
                                       batch=64, parity_steps=2),
        exchange_rows=4096, exchange_dim=16, exchange_batch=256)


def test_distribution_phases_pass_on_cpu_at_a_tiny_size(capsys):
    chip_smoke.distribution(torch.device("cpu"), tiny_size(), 0)
    out = capsys.readouterr().out
    assert "phase 33 one-rank group: ok" in out
    assert "phase 34 four ranks on one card: ok" in out
    for rank in range(4):
        assert f"rank {rank} (4 ranks on one CPU, gloo through host)" in out
    assert "'adam': 'bit-equal'" in out
    # The one-rank group runs every collective helper, and the sharded
    # paths' own collectives, through its backend.
    assert "one-rank gloo collectives run: {'helpers': 13" in out
    assert out.count("scores exact dots") == len(chip_smoke.BUCKETED)


def test_every_distributed_path_names_rows_of_the_report():
    """The rows a path must launch are rows the report carries."""
    rows = {f"bucketed_scores[{f}]" for f in chip_smoke.BUCKETED}
    rows |= {f"probed_leaf_scores[{f}]" for f in ("int8", "int4", "bf16")}
    rows |= {f"probed_bucketed_scores[{f}]" for f in ("int8", "int4")}
    rows |= {"sorted_block_apply[adagrad bf16+SR]"}
    rows |= {f"fused_retrieval_{n}[{t} scores]" for n in ("fwd", "dq", "dc")
             for t in ("f32", "bf16")}
    for path_rows in chip_smoke.PATH_ROWS.values():
        assert set(path_rows) <= rows
