"""The debiased chain's V7 (``fft_patch_debiased``) on the port's spatial
axis, on the CPU: two gloo ranks as a (1 data x 2 spatial) mesh, spawned by
``torch_dist_ranks.spawn``, against one process and against the JAX
``Trainer``; and the helpers of the other entries' files
(``_debiased_v4``, ``_debiased_v1``, ``_mask``).

V7 at 128², global batch 1, ``deterministic_g``: the frozen regional
ResNet-18s and the aux classifier's single (ethnicity) head. One step from
the JAX state of ``test_torch_debiased_entries.jax_state`` carried over by
the bridge, with the JAX step's draws (``jax_step_draws``). Each rank holds
rows 0-63 or 64-127 of the images: the conditional U-Net (its label plane
computed whole, then cut), the PatchGAN and LPIPS run on them; the aux
heads are row-sharded products summed over the pair; the regional CNNs, the
FFT and patch terms read the fake gathered once.

- Against the port's world 1: every metric within rel 1e-5 / abs 1e-6 (the
  bounds of ``test_torch_parallel_spatial.py``) and equal on both ranks, in
  float32 and in float64; in float64 (modules and activations) every G, D
  and regional-head gradient within 1e-4 of its tensor's max|g|
  (``test_torch_parallel_spatial_stn.close_grads``).
- Against the JAX ``Trainer``'s step on its data mesh ``make_mesh(1)``
  from the same state and batch: ``loss_G`` and ``loss_D`` within rtol
  2e-4, every metric within rel 2e-3 / abs 1e-5 (the bounds of
  ``test_torch_parallel_spatial_nemar.py``). The JAX step on ``make_mesh(8,
  spatial=2)`` equals its data-mesh step on the CPU for these entries, so
  the cheaper one is the oracle.
- No layer runs on the whole map at 128². At 64² the U-Net's down6 maps
  have 1 row: its conv and blur-pool run on the whole map on both ranks (2
  layers a step), as in ``test_torch_parallel_spatial_stn.py``.

The ranks run once for the whole test run (``torch_dist_ranks.shared``:
under pytest-xdist the tests of a file that went to other workers read the
first one's result).
"""

import jax
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_debiased_entries import entry_batch, entry_cfg, jax_state, jax_step_draws
from test_torch_parallel_spatial import _close_metrics
from test_torch_parallel_spatial_stn import close_grads
from tfcgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfcgan_tpu.parallel.mesh import place_state as jax_place_state
from tfcgan_tpu.parallel.mesh import shard_batch as jax_shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.recipes import build_recipe


def _numpy_draws(draws) -> dict:
    return {"neg": draws.patch_neg.numpy(), "factors": draws.jitter_factors.numpy(),
            "order": list(draws.jitter_order),
            **{k: getattr(draws, k).numpy() for k in ("g_labels", "d_fake_labels", "fft_neg")
               if getattr(draws, k) is not None}}


def _jax_metrics(cfg, recipe, state) -> dict:
    mesh = jax_make_mesh(1)
    trainer = JaxTrainer(cfg, recipe, mesh=mesh)
    batch = jax_shard_batch(entry_batch(cfg), mesh)
    _, m = trainer.compiled_step()(jax_place_state(state, mesh), batch)
    return {k: float(v) for k, v in jax.device_get(m).items()}


def entry_runs(name: str, size: int, tmp) -> dict:
    """The entry at ``size``², global batch 1: one step on the spatial pair
    and in one process, each in float32 and float64, from the JAX test
    state and the JAX step's draws; the float64 runs' G, D and regional-head
    gradients (files deleted once read); and the JAX data-mesh step's
    metrics."""
    cfg = entry_cfg(name, size, batch=1)
    recipe, state = jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port, torch.Generator())
    modules = tmp / "modules.pt"
    torch.save({k: getattr(port, k).state_dict() for k in ("G", "D", "lpips", "cnns")
                if getattr(port, k) is not None}, modules)
    draws = _numpy_draws(jax_step_draws(state.rng, 0, cfg))
    specs = [dict(name=f"{name}{'_64' if f64 else ''}", cfg=cfg, modules=str(modules),
                  draws=draws, float64=f64) for f64 in (False, True)]
    pair = ranks.spawn("spatial_jobs", 2, tmp, deadline=240.0, jobs=specs, spatial=2,
                       tmp=str(tmp))
    one = ranks.spatial_jobs(0, 1, specs, tmp=str(tmp))
    modules.unlink()
    grads = {}  # each part's comparison: the failures, if any (the gradients are large)
    for part in "gdc":
        paths = [tmp / f"{name}_64_{part}_grads_{world}_f64.pt" for world in (2, 1)]
        if paths[0].exists():
            try:
                close_grads(*(torch.load(path) for path in paths), f"{name} {part}")
                grads[part] = ""
            except AssertionError as e:
                grads[part] = str(e)
        for path in paths:
            path.unlink(missing_ok=True)
    return {"size": size, "pair": pair, "one": one, "grads": grads,
            "jax": _jax_metrics(cfg, recipe, state)}


def check_world_one(runs, name: str, regional_heads: bool = False) -> None:
    """The pair against one process: metrics in float32 and float64, the
    float64 gradients, no layer on the whole map."""
    pair, one, grads = runs["pair"], runs["one"], runs["grads"]
    for key in (name, name + "_64"):
        got = [p[key] for p in pair]
        assert got[0]["metrics"] == got[1]["metrics"], key
        assert sorted(got[0]["metrics"]) == sorted(one[key]["metrics"]), key
        _close_metrics(got[0]["metrics"], one[key]["metrics"], 1e-5, 1e-6)
        whole_map = 0 if runs["size"] >= 128 else 2  # 64²: down6's conv and blur-pool
        assert [g["replicated"] for g in got] == [whole_map] * 2, key
        assert one[key]["replicated"] == 0
    assert grads == {p: "" for p in ("gdc" if regional_heads else "gd")}, grads


def check_jax(runs, name: str) -> None:
    got, want = runs["pair"][0][name]["metrics"], runs["jax"]
    assert sorted(got) == sorted(want)
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "loss_D"))
    _close_metrics(got, want, 2e-3, 1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.shared(tmp_path_factory, "spatial_debiased_v7",
                        lambda tmp: entry_runs("fft_patch_debiased", 128, tmp))


def test_debiased_v7_spatial_pair_matches_world_one(runs):
    check_world_one(runs, "fft_patch_debiased")
    assert runs["pair"][0]["fft_patch_debiased"]["metrics"]["g_ce"] > 0


def test_debiased_v7_spatial_pair_matches_the_jax_trainer(runs):
    check_jax(runs, "fft_patch_debiased")
