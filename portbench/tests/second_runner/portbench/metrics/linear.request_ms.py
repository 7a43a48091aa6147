"""A request's share of the traced window (ms): the window over the
requests traced in it."""


def read(reading):
    if reading is None or not reading.trace.requests:
        return None
    return 1e3 * reading.trace.window_s / reading.trace.requests
