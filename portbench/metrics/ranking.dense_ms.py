"""Device time a request outside the pooled-lookup kernel (ms): the
bottom, cross and top layers' products and element-wise kernels, the
dense block's copy into x0, and the logits' copy to the host."""

from portbench import ranking_work


def read(reading):
    if reading is None or not reading.trace.busy_s:
        return None
    other = sum(s for name, _, s, _ in reading.trace.kernels
                if not ranking_work.is_pool_kernel(name))
    return 1e3 * other / reading.trace.requests
