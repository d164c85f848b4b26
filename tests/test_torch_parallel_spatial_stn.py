"""The STN family on the port's spatial axis, on the CPU: stn_newmodel3 on
four gloo ranks as a (2 data x 2 spatial) mesh, spawned by
``torch_dist_ranks.spawn``, against one process.

stn_newmodel3, global batch 8 at 64², float32, deterministic G, the small ViT
of ``test_torch_stn_train._cfg``, one step from the JAX state of
``test_torch_stn_train._jax_state`` carried over by the bridge. Each rank
holds 4 samples' rows 0-31 or 32-63. G1, G2, D1 and D2 run on the rows; the
localizer runs on the gathered (A, fake_A1) pair on both spatial ranks; the
separable warp gathers its x-pass's intermediate and computes the rank's
rows; the morph triplet and the msrecon pyramid read the gathered images.

- Against the port's world 1: every metric rel 1e-5 / abs 1e-6 (the bounds
  of ``test_torch_parallel_spatial.py``), equal on the four ranks.
- The gradients against world 1's, every G (G1, G2, the STN) and D
  gradient within 1e-4 of its tensor's max|g|, from a second pair of runs
  in float64 (modules and activations; the warp and the loss terms stay
  float32), as ``test_torch_parallel_spatial.py`` does and for its reason:
  float32 convs of the shards round otherwise than the whole map's, and
  leaky ReLU inputs near 0 flip their slope.
- At 64² the U-Nets' down6 maps have 1 row: their conv and blur-pool run on
  the whole map on both spatial ranks, 2 layers a U-Net pass and 3 passes (6
  layers a step); D and the warp run none.
- The morph term on the spatial mesh is finite and equals world 1's (within
  the metric bound above). The JAX package's step on ``make_mesh(8,
  spatial=2)`` gives NaN for it on the CPU (ROADMAP.md, Queue 3, "On the
  reference's side"); the port computes the morphology on the gathered
  images and does not mirror that. The JAX spatial step is not run here:
  its compile alone took about two minutes on the CPU. The JAX oracle is its
  step on the data mesh ``make_mesh(4)`` from the same state, in
  ``test_torch_parallel_spatial_stn_jax.py``.
"""

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from test_torch_parallel_spatial import _close_metrics
from test_torch_stn_train import _cfg as stn_cfg
from test_torch_stn_train import _jax_state
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.recipes import build_recipe

GRAD_TOL = 1e-4


def stn_modules(cfg, path):
    """The JAX test state, bridged, saved as the port recipe's modules."""
    recipe, state = _jax_state(cfg)
    port = build_recipe(cfg, "cpu")
    train_state_from_flax(state, port, torch.Generator())
    torch.save({"G": port.G.state_dict(), "D": port.D.state_dict()}, path)
    return recipe, state


def close_grads(got, want, what):
    """Each gradient within 1e-4 of its max|g|. A gradient that is zero in
    exact arithmetic comes back as rounding: an attention key bias's (the
    softmax drops a constant of the scores) is held within 1e-4 of its key
    kernel's max|g|, and any other below 1e-8 of the set's largest gradient
    (the diffusion U-Net's biases in front of a GroupNorm of one channel a
    group, and its time projections there) to that floor on both sides."""
    assert sorted(got) == sorted(want), what
    floor = 1e-8 * max(float(g.abs().max()) for g in want.values())
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float64, (what, k)
        scale = float(want[k].abs().max())
        if k.endswith(("key.bias", "to_k.bias")):
            kernel = float(want[k[:-len("bias")] + "weight"].abs().max())
            assert max(scale, float(got[k].abs().max())) < GRAD_TOL * kernel, (what, k)
            continue
        if scale <= floor:
            assert float(got[k].abs().max()) <= floor, (what, k)
            continue
        np.testing.assert_allclose(got[k].numpy() / scale, want[k].numpy() / scale,
                                   atol=GRAD_TOL, err_msg=f"{what} {k}")


def _runs(tmp):
    cfg = stn_cfg("stn_newmodel3", 64, 8)
    modules = tmp / "modules.pt"
    stn_modules(cfg, modules)
    kw = dict(cfg=cfg, modules=str(modules))
    kw64 = dict(kw, tmp=str(tmp), float64=True)
    # the ranks' float32 and float64 steps in one spawn, world 1's here meanwhile
    with ranks.start("calls", 4, tmp, deadline=300.0,
                     jobs=[("family_spatial_steps", dict(kw, spatial=2)),
                           ("family_spatial_steps", dict(kw64, spatial=2))]) as job:
        w1 = ranks.family_spatial_steps(0, 1, **kw)
        ranks.family_spatial_steps(0, 1, **kw64)
        w4 = [r[0] for r in job.join()]
    grads = {f"{m}{w}": torch.load(tmp / f"{m}_grads_{w}_f64.pt") for m in "gd" for w in "41"}
    for name in ("modules.pt", *(f"{m}_grads_{w}_f64.pt" for m in "gd" for w in "41")):
        (tmp / name).unlink()
    return w4, w1, grad_failures({m: (grads[m + "4"], grads[m + "1"], m.upper()) for m in "gd"})


def grad_failures(cases: dict) -> dict:
    """``close_grads(got, want, what)`` of each case (key -> the three): ""
    where it holds, else its failure; a result shared between workers
    carries these and not the gradients, which are large."""
    out = {}
    for key, (got, want, what) in cases.items():
        try:
            close_grads(got, want, what)
            out[key] = ""
        except AssertionError as e:
            out[key] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Computed once for the file, whichever workers its tests land on."""
    return ranks.shared(tmp_path_factory, "stn_spatial", _runs)


def test_stn_spatial_mesh_matches_world_one(runs):
    w4, w1, failures = runs
    assert all(w["metrics"] == w4[0]["metrics"] for w in w4)
    assert sorted(w4[0]["metrics"]) == sorted(w1["metrics"])
    _close_metrics(w4[0]["metrics"], w1["metrics"], 1e-5, 1e-6)
    assert all(w["replicated"] == 6 for w in w4), [w["replicated"] for w in w4]
    assert w1["replicated"] == 0
    assert failures == {"g": "", "d": ""}, failures


def test_stn_morph_term_is_finite_on_the_spatial_mesh(runs):
    w4, w1, _ = runs
    got, want = w4[0]["metrics"]["g_morph"], w1["metrics"]["g_morph"]
    assert np.isfinite(got) and np.isfinite(w4[0]["metrics"]["loss_G"])
    assert got == pytest.approx(want, rel=1e-5, abs=1e-6) and want > 0
