"""CUDA kernels launched a request, counted in the traced window (the
pooled lookup's own launch counts over the same requests are printed
beside it)."""


def read(reading):
    if reading is None or not reading.trace.launches():
        return None
    return reading.trace.launches() / reading.trace.requests
