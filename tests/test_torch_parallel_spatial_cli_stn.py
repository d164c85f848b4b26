"""``cli train --spatial 2`` for the STN family on the CPU: two gloo ranks
under ``torchrun`` (one data share, each rank holding its rows of every
image) against one process, for stn_newmodel3 (64², the registry's ViT-Base
localizer; tfc_diff's case is in ``test_torch_parallel_spatial_cli_diffusion.py``),
float32, global batch 2, one epoch of 1 step after step 0 on 2 synthetic
A|B PNG pairs, the pool staging.

Both runs' JSONL logs (rank 0 writes) hold the same steps, step 1's metrics
within rel 1e-5 / abs 1e-6 of one process's (the bound of
``test_torch_parallel_spatial.py``) and the later steps' within the lockstep
bounds of ``test_torch_parallel_cli.py`` (rel 3e-3 / abs 1e-4); the summary
line names the mesh. The experiments' own draws run on both sides: the
generators are kept equal over the ranks. Each checkpoint is deleted.
"""

import json
import os
import shutil

from test_torch_cli_train import _write_pairs
from test_torch_parallel_cli import _torchrun
from tfcgan_tpu_torch import cli


def _log(out, experiment):
    with open(os.path.join(out, "logs", f"{experiment}.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_on_a_spatial_pair(tmp_path, experiment, size):
    """Both runs of the module docstring, and their logs compared."""
    data = str(tmp_path / "data")
    _write_pairs(data, "train", 2, size, seed=5)
    train = ["train", "--experiment", experiment, "--data-root", data, "--image-size",
             str(size), "--batch-size", "2", "--dtype", "float32", "--device", "cpu",
             "--n-epochs", "1", "--checkpoint-interval", "0", "--sample-interval", "100"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    cli.main([*train, "--out-dir", one])
    rows1 = _log(one, experiment)
    assert [r["step"] for r in rows1] == [1, 2]
    shutil.rmtree(os.path.join(one, "step_00000002"))
    stdout = _torchrun([*train, "--staging", "pool", "--spatial", "2", "--out-dir", two])
    rows2 = _log(two, experiment)
    shutil.rmtree(os.path.join(two, "step_00000002"))
    assert [r["step"] for r in rows2] == [1, 2]
    for i, (r2, r1) in enumerate(zip(rows2, rows1)):
        rel, abs_ = (1e-5, 1e-6) if i == 0 else (3e-3, 1e-4)
        assert sorted(r2) == sorted(r1)
        for k in r1:
            if k not in ("ts", "wall_s", "step"):
                assert abs(r2[k] - r1[k]) <= abs_ + rel * abs(r1[k]), (i, k, r2[k], r1[k])
    summary = [line for line in stdout.splitlines() if line.startswith("data-parallel run: ")]
    assert len(summary) == 1, stdout[-2000:]
    run = json.loads(summary[0].split(": ", 1)[1])
    assert run["mesh"] == {"data": 1, "spatial": 2} and run["steps"] == 2, run


def test_stn_train_on_a_spatial_pair_matches_one_process(tmp_path):
    train_on_a_spatial_pair(tmp_path, "stn_newmodel3", 64)
