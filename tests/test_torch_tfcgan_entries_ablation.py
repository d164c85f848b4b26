"""The ablation registry entries, the port against the JAX package, float32
on the CPU (see test_torch_tfcgan_entries.py for the setting and the
tolerances): original_16p without the patch triplet (``patch_grid`` 0),
without the perceptual term (no LPIPS module at all) and without the
temperature triplet.
"""

import pytest

from test_torch_tfcgan_entries import assert_entry_matches_jax

DROPPED = {"ablation_nopatch": "g_triplet", "ablation_noperc": "g_lpips",
           "ablation_notemp": "g_temp"}


@pytest.mark.parametrize("name", sorted(DROPPED))
def test_entry_loss_and_gradients_match_jax(name, monkeypatch):
    got = assert_entry_matches_jax(name, monkeypatch)
    assert DROPPED[name] not in got
    assert {"g_adv", "loss_G", "loss_D"} | {"g_triplet", "g_temp", "g_lpips"} - {
        DROPPED[name]} <= set(got)
