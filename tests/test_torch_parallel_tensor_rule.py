"""The tensor axis's placement rule and the mesh it runs on (CPU).

- For one entry of every family, small, every parameter of the port's G, D,
  LPIPS, regional CNNs and frozen modules, as ``bridge.py`` fills it from a
  JAX state, gets the JAX ``param_sharding(make_mesh(8, tensor=2), leaf)``
  decision of its flax leaf, and is sharded on the torch dim that is that
  leaf's last. The JAX leaves are filled with markers (leaf index x 8192 +
  the position along the leaf's last dim), so that the bridged tensor names
  its leaf and shows which of its dims was the flax last one.
- F7, ``cfg.mesh``: a ``tensor=2`` or a ``spatial=2`` config in a world of
  one fails on the divisibility of the world (the JAX ``make_mesh`` asserts
  it); two gloo ranks given only
  ``cfg.mesh.tensor=2`` build the (data 1 x tensor 2) mesh in ``Trainer``.
- The batch-coupled ops (``TrainBatchNorm``, the saliency mask's min and
  max, ``all_gather_batch``, ``all_reduce_sum``) on a (2 data x 2 tensor)
  mesh read the global batch over the data group, each sample once:
  ``test_torch_parallel_dp.py``'s checks at world 2, on four ranks.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_parallel_dp import check_batch_coupled_ops
from tfcgan_tpu.config import get_experiment
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import param_sharding
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.config import get_experiment as port_experiment
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.models.layers import without_draws
from tfcgan_tpu_torch.parallel import make_mesh, param_sharding_dim
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train.trainer import Trainer

BASE = 8192  # larger than every leaf's last dim here
VIT = dict(vit_depth=2, vit_dim=96, vit_heads=4, vit_mlp=192)
ENTRIES = {
    "fft_glo": (64, {}),
    "fft_patch_debiased_v4": (64, {}),  # the regional heads train with G
    "fft_patch_debiased": (64, {}),     # V7: both regional CNNs frozen
    "stn_newmodel3": (64, VIT),
    "nemar": (128, {"resnet_blocks": 6}),
    "tfc_diff": (32, {}),
    "tfc_diff_label": (32, {}),         # the class embedding
    "thermalgan_bn": (256, {}),
    "cyclegan": (64, {"resnet_blocks": 2}),
}


def _cfg(get, name):
    size, extra = ENTRIES[name]
    cfg = get(name)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2, image_size=size),
                       train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                       extra={**cfg.extra, **extra})


@pytest.mark.parametrize("name", list(ENTRIES))
def test_port_rule_equals_the_jax_param_sharding(name):
    cfg = _cfg(get_experiment, name)
    recipe = jax_build_recipe(cfg)
    batch = synthetic_batch(2, cfg.data.image_size, with_labels=True)
    shapes = jax.eval_shape(recipe.init, jax.random.PRNGKey(0), batch)
    mesh = jax_make_mesh(8, tensor=2)
    sharded, lasts = [], []

    def mark(s):
        i = len(sharded)
        sharded.append("tensor" in param_sharding(mesh, s).spec)
        lasts.append(s.shape[-1] if s.shape else 1)
        last = np.arange(s.shape[-1], dtype=np.float32) if s.shape else np.float32(0)
        return np.broadcast_to(i * BASE + last, s.shape).astype(np.float32)

    trees = {k: jax.tree.map(mark, shapes[k]) for k in ("g_params", "d_params", "frozen")}
    assert max(lasts) < BASE
    spectral = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes["spectral"])
    empty = (types.SimpleNamespace(count=0),)
    state = types.SimpleNamespace(step=0, spectral=spectral, extra=None, g_opt_state=empty,
                                  d_opt_state=empty, **trees)
    with without_draws():
        port = build_recipe(_cfg(port_experiment, name), "cpu")
    with torch.no_grad():
        for p in (q for m in (port.G, port.D, port.lpips, getattr(port, "cnns", None),
                              getattr(port, "frozen", None)) if m is not None
                  for q in m.parameters()):
            p.fill_(float("nan"))
    pstate = train_state_from_flax(state, port, torch.Generator())

    reached, n_sharded = set(), 0
    for root in (pstate.G, pstate.D, pstate.lpips, pstate.cnns, pstate.frozen):
        for path, module in ([] if root is None else root.named_modules()):
            for pname, p in module.named_parameters(recurse=False):
                key = f"{path}.{pname}"
                t = p.detach()
                assert torch.isfinite(t).all(), f"{name}: {key} not filled by the bridge"
                leaf = int(t.reshape(-1)[0]) // BASE
                reached.add(leaf)
                varying = [d for d in range(t.dim()) if (t != t.narrow(d, 0, 1)).any()]
                dim = param_sharding_dim(module, pname, p, 2)
                if sharded[leaf]:
                    n_sharded += 1
                    assert varying == [dim], (name, key, dim, varying)
                else:
                    assert dim is None, (name, key, dim, tuple(t.shape), lasts[leaf])
    assert reached == set(range(len(sharded))), f"{name}: flax leaves the bridge never reads"
    assert n_sharded > 0


def test_f7_mesh_refusals_in_a_world_of_one():
    cfg = port_experiment("fft_glo")
    stub = types.SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by the 'tensor' axis"):
        Trainer(cfg.replace(mesh=dataclasses.replace(cfg.mesh, tensor=2)), stub)
    with pytest.raises(ValueError, match="not divisible by the 'spatial' axis"):
        Trainer(cfg.replace(mesh=dataclasses.replace(cfg.mesh, spatial=2)), stub)
    with pytest.raises(ValueError, match="not divisible by the 'spatial' axis"):
        make_mesh(spatial=2)
    assert Trainer(cfg, stub).mesh is None  # the plain one-process run


def test_f7_two_ranks_build_the_tensor_mesh_from_the_config(tmp_path):
    out = ranks.spawn("mesh_from_config", 2, tmp_path, tensor=2)
    for rank, o in enumerate(out):
        assert o == {"axis_names": ("data", "tensor"), "shape": {"data": 1, "tensor": 2},
                     "data": (0, 1), "tensor": (rank, 2), "world": (rank, 2)}


def test_batch_coupled_ops_read_each_sample_once_on_a_two_by_two_mesh(tmp_path):
    # over the world, a (2 data x 2 tensor) mesh would count every sample twice
    check_batch_coupled_ops(tmp_path, world=4, tensor=2)
