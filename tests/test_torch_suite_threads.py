"""The suite's one thread rule (the repository's root ``conftest.py``): in an
xdist worker torch runs the cores this process may use divided among the
workers, at least one thread, and the processes it starts inherit the
count as ``OMP_NUM_THREADS``; the ranks of
``med_tpu_torch.parallel.launch.spawn`` among them, which launch pins at
one thread. Outside xdist nothing is set."""

import os

import torch
from torch_rank_bodies import thread_suite

from med_tpu_torch.parallel import launch


def test_torch_threads_are_the_cores_over_the_workers_in_workers_and_their_ranks(tmp_path):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    want = None if workers is None else max(1, len(os.sched_getaffinity(0)) // int(workers))
    if want is not None:
        assert torch.get_num_threads() == want
        assert os.environ["OMP_NUM_THREADS"] == str(want)
    [(threads, omp)] = launch.spawn(thread_suite, 1, str(tmp_path / "ranks"), device="cpu")
    assert omp == os.environ.get("OMP_NUM_THREADS")
    # launch pins each rank at one thread itself: never more than the rule gives
    assert threads == 1
    assert want is None or threads <= want
