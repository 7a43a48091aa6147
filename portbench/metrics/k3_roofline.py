"""K3's share of its roofline (%): the least time of the traced requests'
K3 work (`yardstick.bucketed_work`: every stored row scored by every
query) over the device time of K3's kernels in the traced window."""


def read(reading):
    if reading is None:
        return None
    seconds = reading.trace.seconds("K3")
    least = reading.least_seconds("K3")
    if not seconds or least is None:
        return None
    return 100.0 * least / seconds
