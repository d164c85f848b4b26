"""NeMAR on the port's spatial axis, on the CPU: two gloo ranks as a (1 data
x 2 spatial) mesh, spawned by ``torch_dist_ranks.spawn``, against one
process and against the JAX ``Trainer``.

nemar at 128², global batch 1, float32, 2 ResNet blocks, ``lambda_smooth``
0.5 (the default 0 would hide the smoothness term), both ``stn_type``s (the
conv-affine one with ``multi_resolution`` 2: a second D on 64² inputs), one
D-first step from the JAX state of ``test_torch_nemar._jax_state`` (the
deformable STN's offset head drawn, so that the field and its smoothness
are not zero) carried over by the bridge. Each rank holds rows 0-63 or
64-127: T, R and D run on them; R's targets are gathered once and sampled at
the rank's rows of the grid (K3's plain version here).

- Against the port's world 1, the metrics equal on both ranks: in a pair
  of runs in float64 (modules and activations; the sampler and the loss
  terms stay float32) every metric within rel 1e-5 / abs 1e-6 (the bounds
  of ``test_torch_parallel_spatial.py``), and every G (T and R) and D
  gradient within 1e-4 of its tensor's max|g|, as
  ``test_torch_parallel_spatial_stn.py`` does; and for the deformable STN
  in float32 too, the terms that the step computes before D's update
  (``g_l1_tr``, ``g_l1_rt``, ``g_smooth``, ``loss_D``) within rel 1e-5 /
  abs 1e-6 and every metric within rel 2e-3 / abs 1e-5 (the conv-affine
  STN runs in float64 only, to keep the file near a minute on one CPU
  thread). The GAN terms of G run through the D that the step has just
  updated (``d_first``), and Adam's first update moves each weight by
  about lr times the sign of its gradient: the weights whose gradient sign
  float32 rounding decides move D's outputs by about 2e-4 of the terms.
  One process in float32 against itself in float64 shows the same gap
  (g_gan_tr 1.925590 and 1.925247; 1.925187 with 8 torch threads instead
  of 1), so float32 holds those terms to the JAX bound.
- Against the JAX ``Trainer``'s step on its data mesh (the deformable
  STN): the bounds of ``test_torch_parallel_spatial_stn_jax.py``,
  ``loss_G`` and ``loss_D`` within rtol 2e-4, every metric within rel 2e-3 /
  abs 1e-5. The JAX step on ``make_mesh(8, spatial=2)`` equals its data-mesh
  step on the CPU (ROADMAP.md, Queue 3), so the cheaper one is the oracle.
- At 128² the deformable STN's bottleneck is one row: its max-pool to it,
  its two 1 x 1 convs and its three residual blocks' six convs run on the
  whole map on both ranks (9 layers a step); T, D and the conv-affine STN
  run none.
"""

import jax
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_nemar import _cfg as nemar_cfg
from test_torch_nemar import _jax_state
from test_torch_parallel_spatial import _close_metrics
from test_torch_parallel_spatial_stn import grad_failures
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import place_state as jax_place_state
from tfcgan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.recipes import build_recipe

STN_TYPES = ("deformable", "affine")
BEFORE_D_UPDATE = ("g_l1_tr", "g_l1_rt", "g_smooth", "loss_D")
REPLICATED = {"deformable": 9, "affine": 0}


def port_modules(cfg, path, jax_state):
    """The JAX test state, bridged, saved as the port recipe's modules."""
    recipe, state = jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port, torch.Generator())
    saved = {"G": port.G.state_dict(), "D": port.D.state_dict()}
    if getattr(port, "frozen", None) is not None:
        saved["frozen"] = port.frozen.state_dict()
    torch.save(saved, path)
    return recipe, state


def _jax_metrics(cfg, recipe, state):
    mesh = jax_make_mesh(1)
    trainer = JaxTrainer(cfg, recipe, mesh=mesh)
    batch = synthetic_batch(cfg.data.batch_size, cfg.data.image_size, seed=0, with_labels=True)
    batch = {k: v for k, v in batch.items() if k in ("A", "B", "T_B")}
    _, m = trainer.compiled_step()(jax_place_state(state, mesh), jax_shard_batch(batch, mesh))
    return {k: float(v) for k, v in jax.device_get(m).items()}


def pair_and_one(tmp, jobs, spatial=2, float32=None, meanwhile=None):
    """``jobs`` (name -> config) on the spatial pair and on world 1 in
    float64, and those named in ``float32`` (default: all) in float32 too:
    the metrics of each run (float64 runs under name + "_64"), and the
    float64 gradients (each file deleted once read). World 1 and
    ``meanwhile()`` run here while the pair runs."""
    float32 = jobs if float32 is None else float32
    specs = [dict(name=f"{n}{'_64' if f64 else ''}", cfg=c, modules=str(tmp / f"{n}.pt"),
                  float64=f64) for n, c in jobs.items() for f64 in (False, True)
             if f64 or n in float32]
    with ranks.start("spatial_jobs", spatial, tmp, deadline=240.0, jobs=specs,
                     spatial=spatial, tmp=str(tmp)) as run:
        one = ranks.spatial_jobs(0, 1, specs, tmp=str(tmp))
        if meanwhile is not None:
            meanwhile()
        pair = run.join()
    grads = {}
    for name in jobs:
        for m in "gd":
            for w in (spatial, 1):
                path = tmp / f"{name}_64_{m}_grads_{w}_f64.pt"
                grads[name, m, w] = torch.load(path)
                path.unlink()
    return pair, one, grads


def pair_failures(grads, name) -> dict:
    """``grad_failures`` of run ``name``'s float64 G and D gradients of
    ``pair_and_one``, the pair's against one process's, keyed (name, part)."""
    return grad_failures({(name, m): (grads[name, m, 2], grads[name, m, 1],
                                      f"{name} {m.upper()}") for m in "gd"})


def _runs(tmp):
    jobs, states, want = {}, {}, {}
    for stn_type in STN_TYPES:
        # the conv-affine run also takes a second discriminator on 64² inputs,
        # downscaled from the images gathered once
        extra = {"multi_resolution": 2} if stn_type == "affine" else {}
        cfg = nemar_cfg(128, 1, lambda_smooth=0.5, stn_type=stn_type, **extra)
        jobs[stn_type] = cfg
        states[stn_type] = port_modules(cfg, tmp / f"{stn_type}.pt", _jax_state)
    pair, one, grads = pair_and_one(
        tmp, jobs, float32=("deformable",),
        meanwhile=lambda: want.update(_jax_metrics(jobs["deformable"], *states["deformable"])))
    for stn_type in STN_TYPES:
        (tmp / f"{stn_type}.pt").unlink()
    return want, pair, one, {k: v for t in STN_TYPES for k, v in pair_failures(grads, t).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Computed once for the file (the JAX step while the pair runs),
    whichever workers its tests land on."""
    return ranks.shared(tmp_path_factory, "nemar_spatial", _runs)


@pytest.mark.parametrize("stn_type", STN_TYPES)
def test_nemar_spatial_pair_matches_world_one(runs, stn_type):
    _, pair, one, failures = runs
    if stn_type in pair[0]:
        got = [p[stn_type] for p in pair]
        assert got[0]["metrics"] == got[1]["metrics"]
        assert sorted(got[0]["metrics"]) == sorted(one[stn_type]["metrics"])
        _close_metrics(got[0]["metrics"], one[stn_type]["metrics"], 1e-5, 1e-6,
                       keys=BEFORE_D_UPDATE)
        _close_metrics(got[0]["metrics"], one[stn_type]["metrics"], 2e-3, 1e-5)
    got = [p[stn_type + "_64"] for p in pair]
    assert got[0]["metrics"] == got[1]["metrics"]
    assert sorted(got[0]["metrics"]) == sorted(one[stn_type + "_64"]["metrics"])
    _close_metrics(got[0]["metrics"], one[stn_type + "_64"]["metrics"], 1e-5, 1e-6)
    assert got[0]["metrics"]["g_smooth"] > 0
    assert [g["replicated"] for g in got] == [REPLICATED[stn_type]] * 2
    assert one[stn_type + "_64"]["replicated"] == 0
    for m in "gd":
        assert failures[stn_type, m] == "", failures[stn_type, m]


def test_nemar_spatial_pair_matches_the_jax_trainer(runs):
    want, pair, _, _ = runs
    got = pair[0]["deformable"]["metrics"]
    assert sorted(got) == sorted(want)
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "loss_D"))
    _close_metrics(got, want, 2e-3, 1e-5)
