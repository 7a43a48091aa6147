"""The whole request's share of the bf16 dense peak (%): the traced
requests' useful products (`yardstick`'s `flops`) over 989 TFLOP/s times
the traced window, which the requests fill back to back."""

from portbench import yardstick


def read(reading):
    if reading is None or not reading.trace.busy_s:
        return None
    flops = reading.work.get("flops")
    if not flops:
        return None
    return 100.0 * flops / (yardstick.PEAK_BF16_FLOPS
                            * reading.trace.window_s)
