"""Torch's CPU threads under pytest-xdist.

Every xdist worker imports every test module while it collects, so this
module's import sets, in each worker, torch's intra-op threads to the
machine's cores divided by the workers (at least one). Left at its default
(all cores in every worker), torch's OpenMP pool oversubscribes the machine:
4 concurrent copies of ``test_torch_cli_train.py``'s fft_glo journey took
198 s each on 8 cores, against 14 s each at 2 threads. A run without xdist
keeps torch's default.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))


def test_torch_threads_fit_the_workers():
    cores = os.cpu_count() or 1
    if WORKERS > 1:
        assert torch.get_num_threads() == max(1, cores // WORKERS)
    assert torch.get_num_threads() >= 1
