"""The share of the traced window in which no kernel ran on the card
(%)."""


def read(reading):
    if reading is None or not reading.trace.busy_s:
        return None
    return 100.0 * (1.0 - reading.trace.busy_s / reading.trace.window_s)
