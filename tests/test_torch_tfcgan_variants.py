"""The saliency-mask, regional-FFT and favtgan temperature entries, the port
against the JAX package, float32 on the CPU at 64², batch 2, as
test_torch_debiased_entries.py sets them up (one JAX state from numpy draws
carried into the port, step 0's draws from the JAX key): every g_loss and
d_loss term within rtol 1e-4; for fft_patch_mask (G on A and its saliency
mask, the mask L1 term), favtgan_tempmap (the float32 temperature-map
product) and fft_patch_region_kl (log-softmax over the batch) also every G
and D gradient within 2e-4 x its tensor's max|g|.
"""

import pytest

from test_torch_debiased_entries import assert_entry_matches_jax
from tfcgan_tpu.config import get_experiment

TERM = {"fft_patch_mask": "g_mask", "favtgan_tempmap": "g_temp", "favtgan_l1": "g_temp",
        "fft_patch_region_kl": "g_region_fft", "fft_patch_region": "g_region_fft"}


@pytest.mark.parametrize("name,grads", [("fft_patch_mask", True), ("favtgan_tempmap", True),
                                        ("fft_patch_region_kl", True),
                                        ("fft_patch_region", False), ("favtgan_l1", False)])
def test_variant_entry_matches_jax(name, grads, monkeypatch):
    got = assert_entry_matches_jax(name, monkeypatch, grads=grads)
    assert TERM[name] in got and "g_ce" not in got
    lc = get_experiment(name).loss
    assert ("g_fft" in got) == (lc.fft_mode != "off")
