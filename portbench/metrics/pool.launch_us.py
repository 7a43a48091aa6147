"""A pooled-lookup launch's host time (us): the seconds of the port's
`pool.launch` spans (the checks, the grouping and the dispatcher call)
in the traced window over their count. On the CPU the wrapper runs its
twin and records no such span."""


def read(reading):
    if reading is None:
        return None
    seconds = [s for name, s in reading.trace.spans if name == "pool.launch"]
    if not seconds:
        return None
    return 1e6 * sum(seconds) / len(seconds)
