"""ThermalGAN's batch-norm variant on the port's spatial axis, on the CPU:
two gloo ranks as a (1 data x 2 spatial) mesh, spawned by
``torch_dist_ranks.spawn``, against one process and the JAX ``Trainer``.

thermalgan_bn at 256² (G2 downsamples 8 times), global batch 1, float32,
``deterministic_g``, ``d_vae_mode`` ``single_mse``, one step from the JAX
state of ``test_torch_thermalgan_recipe._jax_state`` carried over by the
bridge. Each rank holds rows 0-127 or 128-255 of A, B and T_B: G1 (its
batch norms' moments summed over the spatial group, over the batch's every
row), the Encoder (its last 2 x 2 map gathered once for ``fc_mu`` and
``fc_logvar``), G2, D_pix and the stage-1 D run on them. One sample keeps
the file near a minute on one CPU thread (a float64 step of the family at
B=2 takes 24 s there); the sum of the moments over the data group is
``test_torch_parallel_dp.py``'s.

- Against the port's world 1: every metric within rel 1e-5 / abs 1e-6 (the
  bounds of ``test_torch_parallel_spatial.py``; the step is G-first, so
  every metric comes before an update), equal on both ranks; in a second
  pair of runs in float64 (modules and activations) every G and D gradient
  within 1e-4 of its tensor's max|g| (``test_torch_parallel_spatial_stn``'s
  ``close_grads``).
- G2's innermost map (1 x 1 at 256²) has fewer rows than ranks: its conv
  runs on the whole map on both ranks (one layer a step).
- Against the JAX ``Trainer``'s step on its data mesh, from the same state
  and batch: ``loss_G`` and ``loss_D`` within rtol 2e-4, every metric
  within rel 2e-3 / abs 1e-5 (the bounds of
  ``test_torch_parallel_spatial_stn_jax.py``). The JAX step on
  ``make_mesh(8, spatial=2)`` equals its data-mesh step on the CPU
  (``g_kl`` 13.025351 against 13.025363 at B=4; ROADMAP.md, Queue 3), so
  the cheaper one is the oracle.
"""

import dataclasses

import pytest

import torch_dist_ranks as ranks

from test_torch_parallel_spatial import _close_metrics
from test_torch_parallel_spatial_nemar import (_jax_metrics, pair_and_one, pair_failures,
                                               port_modules)
from test_torch_thermalgan_recipe import _cfg, _jax_state


def thermal_cfg(name, batch=1, **extra):
    cfg = _cfg(name, **extra)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch))


def check_pair(pair, one, failures, name, replicated=1):
    """The runs of ``name`` (float32 where it ran, and float64) against
    world 1's, and its float64 gradients' comparison (``pair_failures``)."""
    for run in (name, name + "_64"):
        if run not in pair[0]:
            continue
        got = [p[run] for p in pair]
        assert got[0]["metrics"] == got[1]["metrics"]
        assert sorted(got[0]["metrics"]) == sorted(one[run]["metrics"])
        _close_metrics(got[0]["metrics"], one[run]["metrics"], 1e-5, 1e-6)
        assert [g["replicated"] for g in got] == [replicated] * 2 and one[run]["replicated"] == 0
    for m in "gd":
        assert failures[name, m] == "", failures[name, m]


def _runs(tmp):
    cfg = thermal_cfg("thermalgan_bn")
    state = port_modules(cfg, tmp / "bn.pt", _jax_state)
    want = {}
    pair, one, grads = pair_and_one(tmp, {"bn": cfg},
                                    meanwhile=lambda: want.update(_jax_metrics(cfg, *state)))
    (tmp / "bn.pt").unlink()
    return want, pair, one, pair_failures(grads, "bn")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Computed once for the file (the JAX step while the pair runs),
    whichever workers its tests land on."""
    return ranks.shared(tmp_path_factory, "thermalgan_spatial", _runs)


def test_thermalgan_bn_spatial_pair_matches_world_one(runs):
    _, pair, one, failures = runs
    check_pair(pair, one, failures, "bn")


def test_thermalgan_bn_spatial_pair_matches_the_jax_trainer(runs):
    want, pair, _, _ = runs
    got = pair[0]["bn"]["metrics"]
    assert sorted(got) == sorted(want)
    _close_metrics(got, want, 2e-4, 0.0, keys=("loss_G", "loss_D"))
    _close_metrics(got, want, 2e-3, 1e-5)
