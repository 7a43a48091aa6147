"""The pooled lookup's share of its roofline (%): the least time of the
traced requests' pooling (`ranking_work.pool_bytes` at 3.35 TB/s: ids,
each distinct row, the f32 sums) over the device time of the port's
pooled-lookup kernel in the traced window."""

from portbench import ranking_work


def read(reading):
    if reading is None:
        return None
    seconds = sum(s for name, _, s, _ in reading.trace.kernels
                  if ranking_work.is_pool_kernel(name))
    least = reading.work.get("pool_least_s")
    if not seconds or not least:
        return None
    return 100.0 * least / seconds
