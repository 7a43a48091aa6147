"""One share of the cores for torch in each pytest worker.

Under `pytest -n N` every worker is a process of its own, and torch's
CPU ops each start a parallel region on as many threads as the machine
has cores. N workers then run N times that many threads, and every
region waits for its slowest thread to be scheduled: a small op that
takes microseconds alone takes a scheduler slice. `torch_threads`, a
module-scoped autouse fixture, gives torch in a worker its share of the
cores (`cores // N`, at least one) while that module's tests run, and
the same count to the processes they start (`OMP_NUM_THREADS`); it
restores both afterwards. Outside xdist it changes nothing.

A test module takes it by importing it:
`from torch_threads import torch_threads  # noqa: F401 (autouse)`.
"""

import contextlib
import os

import pytest
import torch


def share(workers: int) -> int:
    """Torch threads for one of `workers` workers: the cores this process
    may use over the number of workers, at least one."""
    return max(1, len(os.sched_getaffinity(0)) // workers)


@contextlib.contextmanager
def thread_share(workers: int):
    """Torch in this process, and the processes it starts, on `share(
    workers)` threads; both restored on exit."""
    threads, before = share(workers), torch.get_num_threads()
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("OMP_NUM_THREADS", str(threads))
        torch.set_num_threads(threads)
        try:
            yield threads
        finally:
            torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        yield None
        return
    with thread_share(int(workers)) as threads:
        yield threads
