"""stn_newmodel3 on the port's spatial axis against the JAX ``Trainer``, on
the CPU: the port's step on four gloo ranks as a (2 data x 2 spatial) mesh
(the run of ``test_torch_parallel_spatial_stn.py``: global batch 8 at 64²,
float32, deterministic G, the small ViT, the bridged JAX state) against the
JAX ``Trainer``'s step on its data mesh ``make_mesh(4)`` from the same state
and batch.

The JAX step on ``make_mesh(8, spatial=2)`` is not the oracle here: on the
CPU its morph term is NaN (GSPMD cuts the partitioned ``reduce_window`` of
the morphology at the shard edge; ROADMAP.md, Queue 3, "On the reference's
side"), every other term equal to the ``make_mesh(4)`` step's within float32
order, and its compile alone took about two minutes. The data-mesh step
computes the same function unpartitioned. Bounds as for fft_glo
(``test_torch_parallel_spatial.py``): ``loss_G``, ``loss_D`` and ``g_morph``
within rtol 2e-4, every metric within rel 2e-3 / abs 1e-5.
"""

import jax

import torch_dist_ranks as ranks
from test_torch_parallel_spatial import _close_metrics
from test_torch_parallel_spatial_stn import stn_modules
from test_torch_stn_train import _cfg as stn_cfg
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import place_state as jax_place_state
from tfcgan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.data.synth import synthetic_batch


def test_stn_spatial_mesh_matches_the_jax_trainer(tmp_path):
    cfg = stn_cfg("stn_newmodel3", 64, 8)
    modules = tmp_path / "modules.pt"
    recipe, state = stn_modules(cfg, modules)
    w4 = ranks.spawn("family_spatial_steps", 4, tmp_path, spatial=2, cfg=cfg,
                     modules=str(modules))
    modules.unlink()
    c = cfg.replace(mesh=cfg.mesh.__class__(num_devices=4))
    mesh = jax_make_mesh(4)
    trainer = JaxTrainer(c, recipe, mesh=mesh)
    jstate = jax_place_state(state, mesh)
    _, m = trainer.compiled_step()(jstate, jax_shard_batch(synthetic_batch(8, 64, seed=0), mesh))
    want = {k: float(v) for k, v in jax.device_get(m).items()}
    got = w4[0]["metrics"]
    assert sorted(got) == sorted(want)
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "loss_D", "g_morph"))
    _close_metrics(got, want, 2e-3, 1e-5)
