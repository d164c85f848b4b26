"""The triptemp registry entries, the port against the JAX package, float32
on the CPU (see test_torch_tfcgan_entries.py for the setting and the
tolerances): the favtgan lineage's weights (every G term 1.0, no FFT term)
with ``patch_grid`` 2 and 4, and the balanced dual-dataset entries.

Five of them train exactly the recipe of another entry: triptemp_ed and
triptemp_ea that of triptemp_base, and triptemp_16p, triptemp_ed_16p and
triptemp_ea_16p that of original_16p (test_torch_tfcgan_entries.py). Their
configs are equal but for the name and ``needs_extra_root``, which only asks
the CLI for a second data root. Such a case asserts that equality and leaves
the comparison to its twin's case.
"""

import dataclasses

import pytest

from test_torch_tfcgan_entries import assert_entry_matches_jax
from tfcgan_tpu.config import get_experiment

SAME_RECIPE = {"triptemp_ed": "triptemp_base", "triptemp_ea": "triptemp_base",
               "triptemp_16p": "original_16p", "triptemp_ed_16p": "original_16p",
               "triptemp_ea_16p": "original_16p"}


def _recipe_fields(cfg):
    """The config without its name and the data-side ``needs_extra_root``."""
    extra = {k: v for k, v in cfg.extra.items() if k != "needs_extra_root"}
    return dataclasses.replace(cfg, name="", extra=extra)


@pytest.mark.parametrize("name", ["triptemp_base", "triptemp_16p", "triptemp_ed", "triptemp_ea",
                                  "triptemp_ed_16p", "triptemp_ea_16p"])
def test_entry_loss_and_gradients_match_jax(name, monkeypatch):
    cfg = get_experiment(name)
    assert cfg.loss.fft_mode == "off" and cfg.loss.use_temp and cfg.loss.use_lpips
    assert cfg.loss.patch_grid == (4 if name.endswith("16p") else 2)
    if name in SAME_RECIPE:
        assert _recipe_fields(cfg) == _recipe_fields(get_experiment(SAME_RECIPE[name]))
        return
    got = assert_entry_matches_jax(name, monkeypatch)
    assert {"g_triplet", "g_temp", "g_lpips"} <= set(got) and "g_fft" not in got
