"""The one thread rule of the test suite's workers.

pytest-xdist runs several workers side by side. torch starts each with an
intra-op pool as wide as the machine, so N workers would run N times as
many threads as there are cores. In a worker, torch gets the cores this
process may use divided among the workers (at least one), and
``OMP_NUM_THREADS`` says the same to the processes it starts, the ranks of
``med_tpu_torch.parallel.launch.spawn`` among them. Outside xdist torch
keeps its default.

``tests/conftest.py`` has started JAX's CPU backend by the time this hook
runs, so XLA's own threads are left as they were.
"""

import os


def worker_threads():
    """The rule: the cores this process may use over the xdist workers, at
    least one; None outside an xdist worker."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


def pytest_configure(config):
    threads = worker_threads()
    if threads is None:
        return
    import torch

    torch.set_num_threads(threads)
    os.environ["OMP_NUM_THREADS"] = str(threads)
