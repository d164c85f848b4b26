"""``cli train --spatial 2`` for NeMAR and CycleGAN on the CPU: two gloo
ranks under ``torchrun`` (one data share, each rank holding its rows of
every image) against one process, float32, global batch 2, the registry's
networks (9 ResNet blocks; NeMAR's deformable STN), the pool staging.

- nemar at 128², one epoch of 1 step after step 0 on 2 synthetic A|B PNG
  pairs: both JSONL logs (rank 0 writes) hold steps 1 and 2, step 1's terms
  that come before D's update (``g_l1_tr``, ``g_l1_rt``, ``g_smooth``,
  ``loss_D``) within rel 1e-5 / abs 1e-6 of one process's and every logged
  number within the lockstep bounds of ``test_torch_parallel_cli.py`` (rel
  3e-3 / abs 1e-4): its G terms run through the just-updated D
  (``test_torch_parallel_spatial_nemar.py`` says why float32 holds those
  to a wider bound). The summary line names the mesh.
- cyclegan at 64², the same schedule under torchrun alone, with a
  checkpoint after the epoch (step 2, the buffers in it); then ``--resume``
  from that spatial checkpoint, under torchrun and in one process, each one
  more epoch: both log step 3 from the same state and batch, within rel
  1e-5 / abs 1e-6 (one process restores the spatial mesh's checkpoint;
  ``test_torch_parallel_spatial_cyclegan.py`` holds whole runs against one
  process).

The experiments' own draws run on both sides. Each checkpoint is deleted.
"""

import json
import os
import shutil

from test_torch_cli_train import _write_pairs
from test_torch_parallel_cli import Torchrun
from test_torch_parallel_spatial_nemar import BEFORE_D_UPDATE
from tfcgan_tpu_torch import cli

NEAR, LOCKSTEP = (1e-5, 1e-6), (3e-3, 1e-4)


def _log(out, experiment):
    with open(os.path.join(out, "logs", f"{experiment}.jsonl")) as f:
        return [json.loads(line) for line in f]


def _close(got, want, bounds, keys=None):
    rel, abs_ = bounds
    for k in keys or [k for k in want if k not in ("ts", "wall_s", "step")]:
        assert abs(got[k] - want[k]) <= abs_ + rel * abs(want[k]), (k, got[k], want[k])


def _train_args(tmp_path, experiment, size, extra=()):
    data = str(tmp_path / "data")
    _write_pairs(data, "train", 2, size, seed=5)
    return ["train", "--experiment", experiment, "--data-root", data, "--image-size",
            str(size), "--batch-size", "2", "--dtype", "float32", "--device", "cpu",
            "--n-epochs", "1", "--sample-interval", "100", *extra]


def _spatial_run(train, out, *extra, meanwhile=None):
    """``train`` on the spatial pair under torchrun, ``meanwhile()`` here while
    it runs; checks its summary line."""
    with Torchrun([*train, "--staging", "pool", "--spatial", "2", "--out-dir", out,
                   *extra]) as run:
        if meanwhile is not None:
            meanwhile()
        stdout = run.wait()
    summary = [line for line in stdout.splitlines() if line.startswith("data-parallel run: ")]
    assert len(summary) == 1, stdout[-2000:]
    run = json.loads(summary[0].split(": ", 1)[1])
    assert run["mesh"] == {"data": 1, "spatial": 2}, run


def test_nemar_train_on_a_spatial_pair_matches_one_process(tmp_path):
    train = _train_args(tmp_path, "nemar", 128, ["--checkpoint-interval", "0"])
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _spatial_run(train, two, meanwhile=lambda: cli.main([*train, "--out-dir", one]))
    w1, w2 = _log(one, "nemar"), _log(two, "nemar")
    assert [r["step"] for r in w1] == [r["step"] for r in w2] == [1, 2]
    assert sorted(w1[0]) == sorted(w2[0])
    _close(w2[0], w1[0], NEAR, BEFORE_D_UPDATE)
    for got, want in zip(w2, w1):
        _close(got, want, LOCKSTEP)
    for out in (one, two):
        shutil.rmtree(os.path.join(out, "step_00000002"))


def test_cyclegan_train_and_resume_on_a_spatial_pair(tmp_path):
    train = _train_args(tmp_path, "cyclegan", 64, ["--checkpoint-interval", "1"])
    two = str(tmp_path / "two")
    _spatial_run(train, two)
    assert [r["step"] for r in _log(two, "cyclegan")] == [1, 2]
    ckpt = os.path.join(two, "step_00000002")
    resumed = [str(tmp_path / "resumed_two"), str(tmp_path / "resumed_one")]
    _spatial_run(train, resumed[0], "--resume", ckpt,
                 meanwhile=lambda: cli.main([*train, "--out-dir", resumed[1], "--resume", ckpt]))
    got, want = (_log(r, "cyclegan") for r in resumed)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [3]
    assert sorted(got[0]) == sorted(want[0])
    _close(got[0], want[0], NEAR)
    shutil.rmtree(ckpt)
    for out in resumed:
        shutil.rmtree(os.path.join(out, "step_00000003"))
