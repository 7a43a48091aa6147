"""A K5 or K3 launch's host time (us): the seconds of the port's
`k5.launch` / `k3.launch` spans (the plan, the checks and the dispatcher
call) in the traced window over their count. On the CPU the wrappers run
their twins and record no such span."""

SPANS = ("k5.launch", "k3.launch")


def read(reading):
    if reading is None:
        return None
    seconds = [s for name, s in reading.trace.spans if name in SPANS]
    if not seconds:
        return None
    return 1e6 * sum(seconds) / len(seconds)
