"""``tools/family_journey_torch.py`` on the CPU.

- The helpers (``_psnr``, ``_ncc``, ``_gt_warped_a``, ``_scene_pairs``) equal
  the JAX tool's (``tools/family_journey.py``, imported by path: only its
  ``main`` imports JAX) on the same arrays, bit for bit.
- The three-part test: the same G weights through ``bridge.py`` and the same
  held-out batch, float32; the port's nemar and cyclegan task metrics against
  the JAX recipe's ``T`` / ``R`` and ``G_AB`` / ``G_BA`` applied as the JAX
  tool applies them (``tools/family_journey.py:130-176``). Metrics within
  ``TASK_RTOL``: the two packages' float32 convolutions round otherwise
  (measured on the CPU: 0 to 1.3e-7 apart, relative).
- A 2-step run of each family at a small size with an evaluation at each
  step writes a JSON whose history rows have the TPU artifact's keys, and a
  PNG: cyclegan and tfc_diff at 64², B=2 (tfc_diff's chain cut to 4
  timesteps); nemar at 128², B=2 (the deformable STN's 7 halvings need 128);
  thermalgan at 256², B=1 (G2's 8 halvings need 256).
- Without CUDA and without ``--device cpu`` the tool exits and says why.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from tfcgan_tpu.config import get_experiment as jax_get_experiment
from tfcgan_tpu.recipes import build_recipe as jax_build_recipe
from tfcgan_tpu_torch import bridge
from tfcgan_tpu_torch.config import get_experiment
from tfcgan_tpu_torch.data.prefetch import stage_batch
from tfcgan_tpu_torch.recipes import build_recipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK_RTOL = 1e-6


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fj = _load("family_journey_torch")
jax_fj = _load("family_journey")


# ----------------------------------------------------------- the helpers
def test_metric_helpers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    y = (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)
    assert fj._psnr(x, y) == jax_fj._psnr(x, y)
    assert fj._ncc(x, y) == jax_fj._ncc(x, y)
    assert fj._psnr(x, x) == jax_fj._psnr(x, x) == pytest.approx(10 * np.log10(4e12))


@pytest.mark.parametrize("misalign", [True, False], ids=["misaligned", "aligned"])
def test_scene_pairs_and_true_warp_match_jax(misalign):
    batch, truth = fj._scene_pairs(3, 32, seed=99, misalign=misalign)
    want_batch, want_truth = jax_fj._scene_pairs(3, 32, seed=99, misalign=misalign)
    for got, want in ((batch, want_batch), (truth, want_truth)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    got = fj._gt_warped_a(batch["A"], truth["theta"])
    assert np.array_equal(got, jax_fj._gt_warped_a(want_batch["A"], want_truth["theta"]))


# ------------------------------------------------------- the three-part test
def _params_like(shapes, seed: int, size: int):
    """Numpy draws of a JAX parameter tree: kernels N(0, 0.02) (Dense 0.05),
    biases N(0, 0.1); the deformable STN's offset bias a few tenths of a
    pixel, so that R's warp is not the identity."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "offset" in name and "bias" in name:
            return np.asarray([0.3, -0.2], np.float32) * (2.0 / size)
        if "bias" in name:
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        std = 0.05 if len(s.shape) == 2 else 0.02
        return (std * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bridged(name: str, size: int, batch: int, to_state):
    """(JAX recipe, its g_params, port recipe with the same G weights), float32."""
    extra = {"resnet_blocks": 2}
    jcfg = jax_get_experiment(name)
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, batch_size=batch, image_size=size),
                        train=dataclasses.replace(jcfg.train, compute_dtype="float32"),
                        extra={**jcfg.extra, **extra})
    cfg = get_experiment(name)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, image_size=size),
                      train=dataclasses.replace(cfg.train, compute_dtype="float32"),
                      extra={**cfg.extra, **extra})
    jrecipe = jax_build_recipe(jcfg)
    probe = fj._scene_pairs(batch, size, seed=1)[0]
    shapes = jax.eval_shape(jrecipe.init, jax.random.PRNGKey(0), probe)["g_params"]
    g_params = _params_like(shapes, 3, size)
    port = build_recipe(cfg, "cpu")
    port.G.load_state_dict(to_state(g_params))
    return jrecipe, g_params, port


def _close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TASK_RTOL), k


def test_nemar_task_matches_jax():
    size, n = 128, 2
    jrecipe, gp, port = _bridged("nemar", size, n, bridge.nemar_generators_from_flax)
    held, truth = fj._scene_pairs(n, size, seed=fj.HELD_SEED, misalign=True)
    a_gt = fj._gt_warped_a(held["A"], truth["theta"])
    got, _ = fj.nemar_task(port.G, held, stage_batch(held, "cpu"), a_gt)

    def t(x):
        return jrecipe.T.apply({"params": gp["T"]}, x)

    fb = t(held["A"])
    warped, _ = jrecipe.R.apply({"params": gp["R"]}, held["A"], held["B"],
                                apply_on=[held["A"], fb])
    reg_a = np.asarray(warped[0])
    want = {"reg_ncc_gt": jax_fj._ncc(reg_a, a_gt),
            "reg_ncc_init": jax_fj._ncc(held["A"], a_gt),
            "fakeTRB_psnr": jax_fj._psnr(np.asarray(t(warped[0])), held["B"])}
    _close(got, want)
    assert got["reg_ncc_gt"] != got["reg_ncc_init"]  # R moved A


def test_cyclegan_task_matches_jax():
    size, n = 64, 2
    jrecipe, gp, port = _bridged("cyclegan", size, n, bridge.cyclegan_generators_from_flax)
    held, _ = fj._scene_pairs(n, size, seed=fj.HELD_SEED)
    got, _ = fj.cyclegan_task(port.G, held, stage_batch(held, "cpu"))

    def g(name, x):
        return getattr(jrecipe, name).apply({"params": gp[name]}, x)

    fb, fa = g("G_AB", held["A"]), g("G_BA", held["B"])
    want = {"cycle_psnr": 0.5 * (jax_fj._psnr(np.asarray(g("G_BA", fb)), held["A"])
                                 + jax_fj._psnr(np.asarray(g("G_AB", fa)), held["B"])),
            "fakeB_psnr": jax_fj._psnr(np.asarray(fb), held["B"])}
    _close(got, want)


# ------------------------------------------------------ a short run a family
SMOKE = {"cyclegan": dict(size=64, batch=2), "tfc_diff": dict(size=64, batch=2,
                                                              extra={"timesteps": 4}),
         "nemar": dict(size=128, batch=2), "thermalgan": dict(size=256, batch=1)}


@pytest.mark.parametrize("family", sorted(SMOKE))
def test_two_steps_write_the_artifact_keys(tmp_path, family):
    rec = fj.run_journey(family, "cpu", steps=2, interval=1, out_dir=str(tmp_path),
                         log=lambda msg: None, **SMOKE[family])
    with open(tmp_path / f"{family}_journey.json") as f:
        written = json.load(f)
    with open(os.path.join(REPO, "tools", "artifacts", f"{family}_journey.json")) as f:
        tpu = json.load(f)
    assert written == json.loads(json.dumps(rec))
    assert set(tpu) <= set(written)
    assert [row["step"] for row in written["history"]] == [1, 2]
    for row in written["history"]:
        assert list(row) == list(tpu["history"][0])
        assert all(np.isfinite(v) for v in row.values())
    assert written["platform"] == "cpu" and written["config"]["steps"] == 2
    if family == "tfc_diff":
        assert np.isfinite(written["sample_psnr_vs_B"])
    png = tmp_path / f"{family}_journey_sample.png"
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_no_cpu_fallback(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        fj.main(["--family", "nemar"])
    assert exc.value.code not in (0, None)
    assert "--device cpu" in str(exc.value.code)
