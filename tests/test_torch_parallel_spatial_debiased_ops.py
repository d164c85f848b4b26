"""The row-aware pieces of the debiased chain on the port's spatial axis, on
the CPU, against the same piece on the whole map, in float64: the ranks are
spawned by ``torch_dist_ranks.spawn`` as a spatial mesh of 2 and of 3 gloo
ranks (3 gives an inner shard), each holding its rows by the balanced
split, and as a (1 data x 2 spatial x 2 tensor) mesh of 4 ranks.

The pieces (``torch_dist_ranks.debiased_op``):

- ``ConditionalGeneratorUNet``'s label plane: ``label_fc`` computes the
  whole plane on every rank and each keeps its rows, so ``label_fc``'s
  gradient on a rank comes from its rows and the group's sum is the whole;
- ``AuxClassifierDiscriminator(rows=)`` with V1-V5's three heads and with
  V6/V7's ethnicity head alone: the patch logits on rows, and every head a
  row-sharded product summed over the group, so that each rank holds the
  whole probabilities; the images' and every weight's gradients of a fixed
  cotangent, each whole output's term counted 1 / S a rank.

On 4 ranks ``label_fc`` and the discriminator are sharded over the tensor
axis by the JAX rule (``aux_ethn``'s 4 and ``aux_gender``'s 2 classes
split over 2 ranks, ``aux_age``'s 3 stay whole), so the row-sharded product
runs inside ``column_parallel``. The shards' row outputs, concatenated by
rows, and the whole outputs, on every rank, equal the whole map's; every
input gradient (concatenated by rows) and weight gradient (summed over the
spatial ranks) is within 1e-5 of its tensor's max magnitude (the bounds of
``test_torch_parallel_spatial_baseline_ops.py``).
"""

import numpy as np
import pytest

import torch_dist_ranks as ranks

TOL = 1e-5
CASES = [(name, h) for name in ("plane", "aux3", "aux1") for h in (32, 31)]


def _close(got, want, tol, what):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=what)


def _check(got, cases, spatial, tensor):
    """``got`` (the ranks' results, rank order: tensor innermost) against
    the whole map's, computed here."""
    for name, h in cases:
        with ranks._float64():
            ys, gx, gw, _ = ranks.debiased_op_run(name, h)
        what = f"{name} h={h} spatial={spatial} tensor={tensor}"
        parts = [g[name, h] for g in got[::tensor]]  # tensor rank 0 of each spatial rank
        for i, (y, kind) in enumerate(zip(ys, ranks.DEBIASED_OUTPUTS[name])):
            if kind == "rows":
                _close(np.concatenate([p["ys"][i] for p in parts], 1), y.numpy(), TOL,
                       f"{what} y{i}")
            else:
                for r, g in enumerate(got):
                    _close(g[name, h]["ys"][i], y.numpy(), TOL, f"{what} y{i} rank {r}")
        _close(np.concatenate([p["gx"] for p in parts], 1), gx.numpy(), TOL, what + " dx")
        assert sorted(parts[0]["gw"]) == sorted(gw), what
        for k, v in gw.items():
            _close(sum(p["gw"][k] for p in parts), v.numpy(), TOL, f"{what} d{k}")
        if name == "plane":  # each rank's label_fc gradient is a part of the whole
            assert all(float(np.abs(p["gw"]["weight"] - gw["weight"].numpy()).max())
                       > TOL * float(gw["weight"].abs().max()) for p in parts), what


@pytest.mark.parametrize("world", [2, 3])
def test_debiased_pieces_equal_the_whole_map(tmp_path, world):
    got = ranks.spawn("debiased_ops", world, tmp_path, cases=CASES)
    _check(got, CASES, world, 1)


def test_debiased_pieces_compose_with_the_tensor_axis(tmp_path):
    cases = [("plane", 32), ("aux3", 32)]
    got = ranks.spawn("debiased_ops", 4, tmp_path, cases=cases, tensor=2)
    _check(got, cases, 2, 2)
    feats = 32 * 32 * 6
    for g in got:
        aux = g["aux3", 32]["shapes"]
        assert (aux["aux_ethn.weight"], aux["aux_gender.weight"], aux["aux_age.weight"]) == (
            (2, feats), (1, feats), (3, feats))
        assert g["plane", 32]["shapes"]["weight"] == (32 * 32 // 2, 3)
