"""Device time a request in operations other than K3's and K5's kernels
(ms): probe selection, the top-k merge, casts, copies and fills."""


def read(reading):
    if reading is None or not reading.trace.busy_s:
        return None
    return 1e3 * reading.trace.seconds(other=True) / reading.trace.requests
