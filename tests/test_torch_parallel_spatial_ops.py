"""The spatially aware ops of the port's spatial axis
(``tfcgan_tpu_torch.parallel.spatial``) on the CPU, against the same op on
the whole map: the ranks are spawned by ``torch_dist_ranks.spawn`` as a
spatial mesh of 2 and of 3 gloo ranks (3 gives an inner shard, with a
neighbour on each side), each holding its rows of every map by the balanced
split.

Each op (the convs k4 s1 p1 and the ((2, 1), (2, 1)) head, the transposed
conv, the upsample head, the spectral conv, the blur-pool at stride 1 and 2,
instance norm in float32 and bfloat16, the 2 x 2 max-pool and the 3 x 3 conv
of LPIPS, and the gather and split transitions) runs on heights 255, 63, 7
and 1 (fewer rows than ranks: the layer runs on the whole map). The shards'
outputs and input gradients, concatenated by rows, and their weight
gradients, summed over the ranks (the axis's gradient rule), equal the
unsharded op's: float32 within 1e-5 of each tensor's max magnitude (the
order of float32 sums differs only inside the norms' statistics and the
weight gradients' partial sums); bfloat16 instance norm within two bfloat16
steps (2^-6) of it: its scale is rounded to bfloat16 after float32
statistics summed in another order, and its backward adds bfloat16 terms
(measured: 8.6e-3 of max|dx| at 255 rows on 2 ranks, 3 of 7650 elements
beyond one step). A blur-pool shard whose first row is
odd (at stride 2) occurs at every height here over 2 or 3 ranks but 1. The
number of layers that ran on the whole map is asserted.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks

HEIGHTS = (255, 63, 7, 1)
FP32_TOL = 1e-5
BF16_TOL = 2.0 ** -6


def _out_height(name, h):
    """The op's output height on an h-row map (0 where it has none)."""
    _, cot = ranks.spatial_op_inputs(name, h)
    return 0 if cot is None else cot.shape[1]


def _cases():
    return [(name, h) for name in ranks.SPATIAL_OPS for h in HEIGHTS if _out_height(name, h)]


def _close(got, want, tol, what):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("world", [2, 3])
def test_spatial_ops_equal_the_unsharded_ops(tmp_path, world):
    cases = _cases()
    got = ranks.spawn("spatial_ops", world, tmp_path, cases=cases)
    for name, h in cases:
        x, cot = ranks.spatial_op_inputs(name, h)
        y, gx, gw = ranks.spatial_op_run(name, x, cot, None)
        tol = BF16_TOL if name == "norm16" else FP32_TOL
        what = f"{name} h={h} world={world}"
        parts = [g[name, h] for g in got]
        _close(np.concatenate([p["y"] for p in parts], 1), y.float().numpy(), tol, what + " y")
        _close(np.concatenate([p["gx"] for p in parts], 1), gx.float().numpy(), tol,
               what + " dx")
        for k, v in gw.items():
            _close(sum(p["gw"][k] for p in parts), v.numpy(), tol, f"{what} d{k}")
        counts = {p["replicated"] for p in parts}
        assert len(counts) == 1, (what, counts)
        if h >= 63:  # every rank has rows, and the halos come from the neighbours
            assert counts == {0}, (what, counts)
        elif _out_height(name, h) < world and name not in ("norm32", "norm16", "gather"):
            assert counts == {1}, (what, counts)  # a rank without output rows
