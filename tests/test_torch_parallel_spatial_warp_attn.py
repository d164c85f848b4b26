"""The layers of the spatial axis that read beyond a halo, on the CPU,
against the same layer on the whole map: the ranks are spawned by
``torch_dist_ranks.spawn`` as a spatial mesh of 2 and of 3 gloo ranks (3
gives an inner shard), each holding its rows by the balanced split.

- The separable affine warp (``warp_affine_separable(rows=)``: the x-pass on
  the rank's rows, the float32 intermediate gathered once, the y-pass from
  its first output row) and the direct warp (``warp_affine(rows=)``: the
  source gathered, the rank's rows of the grid), bicubic/border and
  bilinear/zeros, under a rotation and under a row flip, so that every
  output row reads other shards' rows. The forward equals the whole warp's
  rows bit for bit; the source gradients (concatenated by rows) and the theta
  gradients (summed over the ranks: the axis's gradient rule) within 1e-5 of
  max|g| (the order of float32 sums differs: the gather's backward adds the
  ranks' whole-map gradients).
- ``group_norm(rows=)`` (its two sums in one all-reduce), the diffusion
  U-Net's ``AttentionBlock`` on row shards (q from the rank's rows, k and v
  from the gathered map) and the nearest 2x upsample through ``row_op``
  (heights 17 and 5 split 3 ways part otherwise than their doubles): outputs
  within 1e-5 of max|y| and every gradient within 1e-5 of max|g| (the key
  bias's, zero in exact arithmetic, within 1e-5 of the key kernel's).
- ``flash_attention`` with local queries, in one process: each share of the
  queries by the balanced split against every key equals those queries of
  the whole sequence's attention, and the shares' dk and dv sum to the whole
  one's (float32 within 1e-5; the plain version, as on the CPU).
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from tfcgan_tpu_torch.ops.flashattn import flash_attention
from tfcgan_tpu_torch.parallel.spatial import row_bounds

HEIGHTS = (17, 8, 5)
TOL = 1e-5
BIT_EXACT = ("warp_cubic", "warp_linear_zeros", "direct", "direct_zeros", "upsample")


def _close(got, want, tol, what):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("world", [2, 3])
def test_layers_that_read_anywhere_equal_the_whole_map(tmp_path, world):
    cases = [(name, h) for name in ranks.READERS for h in HEIGHTS]
    got = ranks.spawn("spatial_readers", world, tmp_path, cases=cases)
    for name, h in cases:
        x, theta, cot = ranks.spatial_reader_inputs(name, h)
        y, gx, gt, gw = ranks.spatial_reader_run(name, x, theta, cot, None)
        what = f"{name} h={h} world={world}"
        parts = [g[name, h] for g in got]
        y_rows = np.concatenate([p["y"] for p in parts], 1)
        if name in BIT_EXACT:
            assert np.array_equal(y_rows, y.numpy()), what + ": not the whole map's bit for bit"
        _close(y_rows, y.numpy(), TOL, what + " y")
        _close(np.concatenate([p["gx"] for p in parts], 1), gx.numpy(), TOL, what + " dx")
        if name in BIT_EXACT[:4]:
            assert float(np.abs(gt.numpy()).max()) > 0, what
            _close(sum(p["gt"] for p in parts), gt.numpy(), TOL, what + " dtheta")
        for k, v in gw.items():
            summed = sum(p["gw"][k] for p in parts)
            if k == "to_k.bias":  # zero in exact arithmetic: the softmax drops a key bias
                scale = float(np.abs(gw["to_k.weight"].numpy()).max())
                assert max(np.abs(summed).max(), np.abs(v.numpy()).max()) < TOL * scale, what
                continue
            _close(summed, v.numpy(), TOL, f"{what} d{k}")


@pytest.mark.parametrize("splits", [2, 3])
def test_flash_attention_with_local_queries(splits):
    rng = np.random.RandomState(splits)
    n, heads, d, s = 2, 2, 8, 37
    q, k, v, g = (torch.from_numpy(rng.randn(n, heads, d, s).astype(np.float32))
                  for _ in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    whole = flash_attention(q, k, v, 0.4)
    dq, dk, dv = torch.autograd.grad(whole, (q, k, v), g)
    outs, dqs, dks, dvs = [], [], [], []
    for r in range(splits):
        lo, hi = row_bounds(s, r, splits)
        qr = q.detach()[..., lo:hi].clone().requires_grad_(True)
        kr, vr = k.detach().clone().requires_grad_(True), v.detach().clone().requires_grad_(True)
        out = flash_attention(qr, kr, vr, 0.4)
        assert out.shape == (n, heads, d, hi - lo)
        grads = torch.autograd.grad(out, (qr, kr, vr), g[..., lo:hi])
        outs.append(out.detach())
        dqs.append(grads[0])
        dks.append(grads[1])
        dvs.append(grads[2])
    _close(torch.cat(outs, -1).numpy(), whole.detach().numpy(), TOL, "o")
    _close(torch.cat(dqs, -1).numpy(), dq.numpy(), TOL, "dq")
    _close(sum(dks).numpy(), dk.numpy(), TOL, "dk")
    _close(sum(dvs).numpy(), dv.numpy(), TOL, "dv")
