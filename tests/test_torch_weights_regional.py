"""The debiased V4 and V7 with converted ResNet-18 weights (ROADMAP F4b): the
regional CNNs in the folded form, their backbones loaded by the port's
``init`` bit for bit as the file holds them (the heads stay drawn), and the
g_loss terms against the JAX recipe within rtol 1e-4. The files, the
settings and the comparison are test_torch_weights_msgpack.py's.
"""

import pytest

from test_torch_weights_msgpack import (  # noqa: F401 (a fixture)
    assert_recipe_loads_the_weights_and_matches_jax, weight_files)


@pytest.mark.parametrize("name", ["fft_patch_debiased_v4", "fft_patch_debiased"])
def test_regional_entries_load_the_backbone_and_match_jax(name, weight_files, monkeypatch):
    assert_recipe_loads_the_weights_and_matches_jax(name, weight_files, monkeypatch)
