"""The debiased chain's V1 (``fft_patch_debiased_v1``) on the port's spatial
axis, on the CPU: two gloo ranks as a (1 data x 2 spatial) mesh against one
process and against the JAX ``Trainer``'s data-mesh step, at 64², global
batch 1, with the checks and bounds of
``test_torch_parallel_spatial_debiased.py``. V1 conditions G on random
labels (a per-sample draw, the same on both spatial ranks) and reuses them
as the targets of D's fake-label cross-entropy; three aux heads, no
regional CNNs.
"""

import pytest

import torch_dist_ranks as ranks
from test_torch_parallel_spatial_debiased import check_jax, check_world_one, entry_runs

NAME = "fft_patch_debiased_v1"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.shared(tmp_path_factory, "spatial_debiased_v1",
                        lambda tmp: entry_runs(NAME, 64, tmp))


def test_debiased_v1_spatial_pair_matches_world_one(runs):
    check_world_one(runs, NAME)
    assert runs["pair"][0][NAME]["metrics"]["d_ce"] > 0


def test_debiased_v1_spatial_pair_matches_the_jax_trainer(runs):
    check_jax(runs, NAME)
