"""The share of the ranking cell's traced window in which no kernel ran
on the card (%): what the host path leaves the device idle. Nothing to
read where the trace holds no device time."""


def read(reading):
    if reading is None or not reading.trace.busy_s:
        return None
    return 100.0 * (1.0 - reading.trace.busy_s / reading.trace.window_s)
