"""The model's host call a request (ms): the seconds of the port's own
`ranking.forward` spans (`Ranking.forward` / `Ranking.logits`) in the
traced window over the requests there. Nothing to read where the program
records no such span."""


def read(reading):
    if reading is None or not reading.trace.requests:
        return None
    seconds = [s for name, s in reading.trace.spans
               if name == "ranking.forward"]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / reading.trace.requests
