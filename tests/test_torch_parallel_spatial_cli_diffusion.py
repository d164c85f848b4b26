"""``cli train --spatial 2`` for tfc_diff on the CPU (32², no test split, so
no sampling chain), as ``test_torch_parallel_spatial_cli_stn.py`` runs it for
stn_newmodel3: two gloo ranks under ``torchrun`` against one process, the
logs' metrics within rel 1e-5 / abs 1e-6 at step 1 and the lockstep bounds
after. ``cli train`` refuses tfc_diff_label and tfc_diff_hybrid before it
trains, with or without ``--spatial``, as the JAX CLI cannot train them (its
loader reads no class labels).
"""

import pytest

from test_torch_parallel_spatial_cli_stn import train_on_a_spatial_pair
from tfcgan_tpu_torch import cli


def test_tfc_diff_train_on_a_spatial_pair_matches_one_process(tmp_path):
    train_on_a_spatial_pair(tmp_path, "tfc_diff", 32)


@pytest.mark.parametrize("experiment", ["tfc_diff_label", "tfc_diff_hybrid"])
def test_cli_train_refuses_the_labelled_diffusion_variants(tmp_path, experiment):
    with pytest.raises(SystemExit, match="class labels"):
        cli.main(["train", "--experiment", experiment, "--data-root", str(tmp_path),
                  "--image-size", "32", "--device", "cpu", "--spatial", "2",
                  "--out-dir", str(tmp_path / "out")])
