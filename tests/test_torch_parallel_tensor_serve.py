"""Serve under a mesh (CPU, two gloo ranks): thermalgan_bn's ``Inferencer``
on an odd batch of 3 at 256², against the JAX ``Inferencer`` on a 2-device
mesh of the same shape, within 2e-4 of max|fake_B| (the bound of
``test_torch_thermalgan_recipe.py``'s serve test):

- two data ranks against ``make_mesh(2)``: the batch is padded to 4 with a
  copy of sample 0, and ``TrainBatchNorm`` (batch moments, always) reads the
  padded batch's moments, pad copy included;
- (1 data x 2 tensor), the generators sharded as a training state's and
  gathered by the Inferencer, against ``make_mesh(2, tensor=2)``: one data
  share, no pad, the moments of the 3 samples.

The quirk is the reference's (``tfcgan_tpu/infer.py:109-120``), mirrored: a
ragged batch's images depend on the data axis's size, here by more than 1e-3
of max|fake_B| between the two meshes. Only rank 0 writes.
"""

import numpy as np
import torch

import torch_dist_ranks as ranks
from test_torch_thermalgan import SIZE, _close, _images
from test_torch_thermalgan_recipe import _cfg, _jax_state
from tfcgan_tpu.infer import Inferencer as JaxInferencer
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu_torch import bridge
from tfcgan_tpu_torch.data.synth import synthetic_batch


def test_thermalgan_bn_ragged_serve_on_data_and_tensor_meshes(tmp_path):
    cfg = _cfg("thermalgan_bn")
    recipe, state = _jax_state(cfg)
    weights = tmp_path / "g.pt"
    torch.save(bridge.thermalgan_generators_from_flax(state.g_params), weights)
    batch = {**synthetic_batch(3, SIZE, seed=40), "A": _images(3, SIZE, 41),
             "B": _images(3, SIZE, 42)}
    kw = dict(cfg=cfg, weights=str(weights), batch=batch)
    data = ranks.spawn("thermalgan_serve", 2, tmp_path, **kw)
    (tmp_path / "tensor").mkdir()  # a store of its own
    tensor = ranks.spawn("thermalgan_serve", 2, tmp_path / "tensor", tensor=2, **kw)
    weights.unlink()
    for out in (data, tensor):
        assert [o["writes"] for o in out] == [True, False]
        np.testing.assert_array_equal(out[0]["fake_B"], out[1]["fake_B"])

    want_data = np.asarray(JaxInferencer(cfg, recipe, state.g_params, mesh=jax_make_mesh(2))(batch))
    want_tensor = np.asarray(JaxInferencer(cfg, recipe, state.g_params,
                                           mesh=jax_make_mesh(2, tensor=2))(batch))
    _close(data[0]["fake_B"], want_data, 2e-4, "fake_B, 2 data ranks")
    _close(tensor[0]["fake_B"], want_tensor, 2e-4, "fake_B, 1 data x 2 tensor")
    # the reference's quirk: the pad copy moves the moments of a ragged batch
    gap = np.abs(want_data - want_tensor).max() / np.abs(want_tensor).max()
    assert gap > 1e-3, gap
