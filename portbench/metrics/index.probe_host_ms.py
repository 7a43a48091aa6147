"""ScaNN's probe selection a request (ms): the seconds of the port's
`scann.probe` spans (the centroid product and the probe lists, the host
path ahead of K5) in the traced window over the requests there."""


def read(reading):
    if reading is None or not reading.trace.requests:
        return None
    seconds = [s for name, s in reading.trace.spans if name == "scann.probe"]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / reading.trace.requests
