"""The saliency-mask entry (``fft_patch_mask``) on the port's spatial axis,
on the CPU: two gloo ranks as a (1 data x 2 spatial) mesh against one
process and against the JAX ``Trainer``'s data-mesh step, at 64², global
batch 1, with the checks and bounds of
``test_torch_parallel_spatial_debiased.py``. The mask is normalised by
extremes over whole images: G's 4th input channel is the mask of A
gathered once, cut to the rank's rows, and ``g_mask`` reads the masks of
the fake and real images gathered once, counted 1 / S a rank.
"""

import pytest

import torch_dist_ranks as ranks
from test_torch_parallel_spatial_debiased import check_jax, check_world_one, entry_runs

NAME = "fft_patch_mask"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.shared(tmp_path_factory, "spatial_mask", lambda tmp: entry_runs(NAME, 64, tmp))


def test_mask_spatial_pair_matches_world_one(runs):
    check_world_one(runs, NAME)
    assert runs["pair"][0][NAME]["metrics"]["g_mask"] > 0


def test_mask_spatial_pair_matches_the_jax_trainer(runs):
    check_jax(runs, NAME)
