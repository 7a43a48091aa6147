"""K5's share of its roofline (%): the least time of the traced requests'
K5 work (`yardstick.scann_work`, from the reference's probe lists) over
the device time of K5's kernels in the traced window."""


def read(reading):
    if reading is None:
        return None
    seconds = reading.trace.seconds("K5")
    least = reading.least_seconds("K5")
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
