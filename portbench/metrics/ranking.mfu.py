"""The whole request's share of the f32 peak (%): the traced requests'
dense-layer operations (`ranking_work.dense_flops_per_pair` a pair) over
67 TFLOP/s (f32 outside the tensor cores: the configuration keeps TF32
off) times the traced window, which the requests fill back to back."""

from portbench import ranking_work


def read(reading):
    if reading is None or not reading.trace.busy_s:
        return None
    flops = reading.work.get("flops")
    if not flops:
        return None
    return 100.0 * flops / (ranking_work.PEAK_F32_FLOPS
                            * reading.trace.window_s)
