"""The index's host call a request (ms): the seconds of the port's own
`scann.search` / `bucketed.search` spans in the traced window over the
requests there. Nothing to read where the program records no such span."""

SPANS = ("scann.search", "bucketed.search")


def read(reading):
    if reading is None or not reading.trace.requests:
        return None
    seconds = [s for name, s in reading.trace.spans if name in SPANS]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / reading.trace.requests
