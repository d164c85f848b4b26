"""CycleGAN on the port's spatial axis, on the CPU: two gloo ranks as a (1
data x 2 spatial) mesh, spawned by ``torch_dist_ranks.spawn``, against one
process, and checkpoints carried between the two.

cyclegan at 64², 2 ResNet blocks, global batch 2, float32, two steps from
the port's init (``torch_dist_ranks.cyclegan_spatial``) across the replay
buffers' fill: 47 of 50 slots full, so the first step fills 2 and the
second fills the last and may swap the other image in, with colliding
slots, as ``test_torch_cyclegan_train.py`` runs them. Each rank holds rows
0-31 or 32-63 of every image; G_AB, G_BA, D_A and D_B run on them; the
buffers stay whole on both ranks.

- The metrics equal on both ranks, and against world 1: step 1's within rel
  1e-5 / abs 1e-6 (the bounds of ``test_torch_parallel_spatial.py``), step
  2's within the lockstep bounds of ``test_torch_parallel_cli.py`` (rel
  3e-3 / abs 1e-4: after an Adam step, each weight whose gradient's sign
  float32 rounding decides has moved by about 2 lr one way or the other;
  measured 1e-4 here, and 1e-2 in ``g_adv`` a step later, where the same
  pair in float64 still agrees to 1e-7). A float64 step's metrics within
  rel 1e-5 / abs 1e-6, and its G and D gradients within 1e-4 of each
  tensor's max|g|, of world 1's.
- The buffers: the same on both ranks, bit for bit, after every step; the
  same counts and the same slots rewritten as world 1's; their images
  within 1e-5 of world 1's after step 1 and within the lockstep bound of
  ``test_torch_cyclegan_train.py`` (5e-2) after step 2.
- A checkpoint written on the spatial mesh after step 1, restored on the
  spatial mesh, repeats step 2 bit for bit (metrics, buffers, weights and
  Adam moments); restored on one process it holds the spatial state's
  weights, moments and buffers bit for bit, and its step 2 is within the
  lockstep bounds of the spatial one; world 1's checkpoint restored on the
  spatial mesh holds world 1's state bit for bit. Each checkpoint is
  deleted once read.
"""

import shutil

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_cyclegan import _cfg as cyclegan_cfg
from test_torch_parallel_spatial import _close_metrics
from test_torch_parallel_spatial_stn import grad_failures

LOCKSTEP = (3e-3, 1e-4)


def _runs(tmp):
    cfg = cyclegan_cfg()
    one = ranks.cyclegan_spatial(0, 1, cfg, str(tmp), resume=False)
    pair = ranks.spawn("cyclegan_spatial", 2, tmp, deadline=240.0, cfg=cfg, tmp=str(tmp),
                       spatial=2, other=str(tmp / "ckpt_1" / "step_00000001"))
    back = ranks.cyclegan_spatial(0, 1, cfg, str(tmp), only_other=True,
                                  other=str(tmp / "ckpt_2" / "step_00000001"))
    grads = {(m, w): torch.load(tmp / f"cyc_{m}_grads_{w}_f64.pt") for m in "gd" for w in (1, 2)}
    for w in (1, 2):
        shutil.rmtree(tmp / f"ckpt_{w}")
        for m in "gd":
            (tmp / f"cyc_{m}_grads_{w}_f64.pt").unlink()
    return one, pair, back, grad_failures({m: (grads[m, 2], grads[m, 1], m.upper())
                                            for m in "gd"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Computed once for the file, whichever workers its tests land on."""
    return ranks.shared(tmp_path_factory, "cyclegan_spatial", _runs)


def test_cyclegan_spatial_pair_matches_world_one(runs):
    one, pair, _, failures = runs
    for i, want in enumerate(one["steps"]):
        got = pair[0]["steps"][i]
        assert got["metrics"] == pair[1]["steps"][i]["metrics"]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        _close_metrics(got["metrics"], want["metrics"], *((1e-5, 1e-6) if i == 0 else LOCKSTEP))
    assert pair[0]["f64"]["metrics"] == pair[1]["f64"]["metrics"]
    _close_metrics(pair[0]["f64"]["metrics"], one["f64"]["metrics"], 1e-5, 1e-6)
    assert failures == {"g": "", "d": ""}, failures


def test_cyclegan_buffers_are_whole_and_equal_on_every_rank(runs):
    one, pair, _, _ = runs
    before = None
    for i, want in enumerate(one["steps"]):
        for name, (data, count) in want["buffers"].items():
            got, got_count = pair[0]["steps"][i]["buffers"][name]
            other, other_count = pair[1]["steps"][i]["buffers"][name]
            assert got.shape == data.shape == (50, 64, 64, 3)
            np.testing.assert_array_equal(got, other)
            assert got_count == other_count == count == min(47 + 2 * (i + 1), 50)
            assert got_count < 50 or i == 1
            if before is not None:
                np.testing.assert_array_equal((got != before[name][0]).any(axis=(1, 2, 3)),
                                              (data != before[name][1]).any(axis=(1, 2, 3)))
            np.testing.assert_allclose(got, data, atol=1e-5 if i == 0 else 5e-2, rtol=0)
        before = {name: (pair[0]["steps"][i]["buffers"][name][0], data)
                  for name, (data, _) in want["buffers"].items()}


def test_cyclegan_checkpoints_move_between_the_meshes(runs):
    one, pair, back, _ = runs
    for rank in pair:
        # the spatial mesh's own resume repeats step 2 bit for bit
        assert rank["resumed"]["metrics"] == rank["steps"][1]["metrics"]
        assert rank["resumed"]["sums"] == rank["steps"][1]["sums"]
        for name, (data, count) in rank["steps"][1]["buffers"].items():
            np.testing.assert_array_equal(rank["resumed"]["buffers"][name][0], data)
        # world 1's checkpoint on the spatial mesh: world 1's state at step 1
        assert rank["other_sums"] == one["steps"][0]["sums"]
    # the spatial checkpoint on one process: the spatial state at step 1
    assert back["other_sums"] == pair[0]["steps"][0]["sums"]
    _close_metrics(back["other"]["metrics"], pair[0]["steps"][1]["metrics"], *LOCKSTEP)
