"""The row-aware pieces of the NeMAR, CycleGAN and ThermalGAN paths on the
port's spatial axis, on the CPU, against the same piece on the whole map:
the ranks are spawned by ``torch_dist_ranks.spawn`` as a spatial mesh of 2
and of 3 gloo ranks (3 gives an inner shard), each holding its rows by the
balanced split.

The pieces (``torch_dist_ranks.baseline_op``): the reflection-padded 3 x 3
and 7 x 7 convs and a small ``ResNetGenerator`` (their halos and, at the
map's edges, the mirrored rows in one exchange); ``NLayerDiscriminator``,
``StridedPatchDiscriminator`` with CycleGAN's head and the three-scale
``MultiDiscriminator`` under ``multiscale_loss`` (a share of a scalar);
``avg_pool_2x`` (its count leaves the padding out at the map's edges only);
the Encoder's 3 x 3 max-pool over -inf and its 8 x 8 mean (whose windows
straddle the shards of 40 rows at 3 ranks); a ``BasicBlock`` with its
stride-2 projection; ``TrainBatchNorm`` (moments over the group);
``normalized_temps``; ``smoothness_loss`` with alpha 0 and 2 (a share: the
row differences' halo row); NeMAR's 2x bilinear ``_upsample_to`` (one row
beyond each side, clamped at the edges) and a 2h + 1 resize (on the whole
map); and K3's plain version, ``grid_sample_dense_plain(rows=)``, sampling
the gathered image at this rank's rows of the grid.

The shards' outputs, concatenated by rows (summed, for a share), equal the
whole map's exactly where no sum crosses the ranks (the pools, the
upsample, the sampler's forward); every output, input gradient and weight
gradient (summed over the ranks, the axis's gradient rule) is within 1e-5
of its tensor's max magnitude. A weight gradient that is zero in exact
arithmetic (a conv bias in front of an instance norm) comes back as
rounding: below 1e-6 of the piece's largest weight gradient, it is held to
that floor on both sides. The layers that ran on the whole map are
counted.
"""

import numpy as np
import pytest

import torch_dist_ranks as ranks

TOL = 1e-5
CASES = {"reflect3": (63, 7, 3), "reflect7": (63, 9), "resnet_gen": (20, 16),
         "nlayer": (64, 40), "strided": (64, 48), "multi": (128,), "basic": (63, 64, 7),
         "avgpool2x": (63, 64, 7, 1), "maxpool3": (63, 64, 7), "avg8": (64, 40),
         "bn": (63, 7), "temps": (63, 7, 1), "smooth0": (63, 7, 2), "smooth2": (63, 7),
         "upsample_to": (32, 7, 2, 1), "upsample_odd": (7,), "gridsample": (63, 7, 1)}
EXACT = ("avgpool2x", "maxpool3", "upsample_to", "gridsample")


def _close(got, want, tol, what):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("world", [2, 3])
def test_baseline_pieces_equal_the_whole_map(tmp_path, world):
    cases = [(name, h) for name, hs in CASES.items() for h in hs]
    got = ranks.spawn("baseline_ops", world, tmp_path, cases=cases)
    for name, h in cases:
        x, cot = ranks.baseline_op_inputs(name, h)
        y, gx, gw = ranks.baseline_op_run(name, x, cot, None)
        what = f"{name} h={h} world={world}"
        parts = [g[name, h] for g in got]
        if name in ranks.SHARE_OPS:
            y_got = sum(p["y"] for p in parts)
        else:
            y_got = np.concatenate([p["y"] for p in parts], 1)
        if name in EXACT:
            np.testing.assert_array_equal(y_got, y.numpy(), err_msg=what + " y")
        _close(y_got, y.numpy(), TOL, what + " y")
        _close(np.concatenate([p["gx"] for p in parts], 1), gx.numpy(), TOL, what + " dx")
        floor = 1e-6 * max([float(v.abs().max()) for v in gw.values()] or [0.0])
        for k, v in gw.items():
            summed = sum(p["gw"][k] for p in parts)
            if float(v.abs().max()) <= floor:
                assert float(np.abs(summed).max()) <= floor, (what, k)
                continue
            _close(summed, v.numpy(), TOL, f"{what} d{k}")
        counts = {p["replicated"] for p in parts}
        assert len(counts) == 1, (what, counts)
        if name == "upsample_odd" or (name == "upsample_to" and 2 * h < world):
            assert counts == {1}, (what, counts)
        elif world == 2 and h >= 32 and name not in ("strided", "multi"):
            assert counts == {0}, (what, counts)
