"""The debiased chain's V4 (``fft_patch_debiased_v4``) on the port's spatial
axis, on the CPU: two gloo ranks as a (1 data x 2 spatial) mesh against one
process and against the JAX ``Trainer``'s data-mesh step, at 128², global
batch 1, with the checks and bounds of
``test_torch_parallel_spatial_debiased.py``. V4 has the aux classifier's
three heads (gender, ethnicity, age), the regional ResNet-18s' classifier
heads trained by G's Adam (their float64 gradients compared too: each rank
holds 1 / S of them, the trainer's sum the whole) and the FFT triplet, read
on the fake and real images gathered once.
"""

import pytest

import torch_dist_ranks as ranks
from test_torch_parallel_spatial_debiased import check_jax, check_world_one, entry_runs

NAME = "fft_patch_debiased_v4"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.shared(tmp_path_factory, "spatial_debiased_v4",
                        lambda tmp: entry_runs(NAME, 128, tmp))


def test_debiased_v4_spatial_pair_matches_world_one(runs):
    check_world_one(runs, NAME, regional_heads=True)
    assert runs["pair"][0][NAME]["metrics"]["g_fft"] > 0


def test_debiased_v4_spatial_pair_matches_the_jax_trainer(runs):
    check_jax(runs, NAME)
