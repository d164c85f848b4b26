"""The port's fft_glo Trainer against the JAX ``Trainer`` over many steps,
float32 on the CPU: ``tests/test_parity_trajectory.py::TestTrajectoryDrift``
with the port in the torch replica's place.

Both run ``run_lockstep``'s configuration (no patch triplet, temperature or
LPIPS; the global FFT of the smooth luma; deterministic G) from one state of
numpy draws, the weights carried into the port by ``bridge.py``, on
``synthetic_batch`` seeds 0..n-1 (``torch_jax_lockstep``). Pointwise losses
part chaotically after a few steps, so past the early window the checks hold
the slow observables that a systematic drift (the spectral u/v cadence, Adam's
eps placement, the update order) would push one way at every step: G's and D's
global parameter norms, each D block's spectral sigma and the last 30 steps'
mean losses, at TestTrajectoryDrift's bounds.

- ``test_100_step_drift_envelope`` (slow): 128², B=4 and 100 steps, as the
  JAX test. Measured with ``tools/measure_drift_torch.py --floor``
  (2026-10-19, the CPU): G norm rel diff 5.0e-5, D 7.2e-4; sigma 4.2e-2,
  3.0e-2, 2.0e-2 and 1.35e-1 for blocks 0-3; the last 30 steps' mean
  loss_G 3.1e-2, loss_D 5.4e-2; loss_G per step 1.4e-4 at step 3, 5.4e-2
  at step 99. JAX against itself with A moved one float32 step up parts by
  more on all of these but block 1's sigma: G 1.3e-4, D 3.5e-3, sigma
  7.6e-2, 1.2e-2, 6.6e-2 and 3.0e-1, loss_G 5.7e-2, loss_D 6.5e-1. So the
  port sits at what rounding alone does; block 3's sigma bound (0.15) holds
  with little room, and rounding alone can exceed it.
- ``test_short_drift_window`` (tier 1): 64², B=2, 10 steps. At this shape
  float32 rounding alone parts the runs faster: JAX against itself with A
  moved one float32 step up differs in loss_G by 5.9e-4 at step 2 and 4.1e-3
  at step 3 (``measure_drift_torch.py --steps 10 --size 64 --batch 2
  --floor``), above the window's rtol 3e-3; the port against JAX 4.9e-4
  and 3.1e-3, and its norms and sigmas after 10 steps inside the floor's
  (sigma 1.4e-3 to 1.3e-2 against 5.4e-3 to 1.9e-2). No other shape of
  about 30 s holds step 3 either (the same tool, 6 steps, 2026-10-19): at
  64² with B=3, 4, 8 and 128² with B=1, 2 the port's step-3 loss parts by
  2.2e-3 to 5.8e-3, and at 128², B=2 it reads 2.2e-3 with 8 threads and
  5.6e-3 under OMP_NUM_THREADS=3, the summation order alone deciding. So this
  case holds steps 0-2 to the window (the 128² case holds all four), the
  rest to the same regime (rtol 0.8, atol 0.1, as TestTrajectoryParity), and
  the norms and sigmas to the 100-step bounds.
"""

import numpy as np
import pytest

from torch_jax_lockstep import (DRIFT_TERMS, _lockstep, drift_cfg, drift_observables,
                                jax_summary, port_summary)

WINDOW = dict(rtol=3e-3, atol=1e-4)


def _run(size, batch, steps):
    jax_state, port_state, jax_hist, port_hist = _lockstep(drift_cfg(size, batch), steps,
                                                           DRIFT_TERMS)
    assert np.all(np.isfinite(jax_hist)) and np.all(np.isfinite(port_hist))
    return jax_hist, port_hist, drift_observables(jax_summary(jax_state),
                                                  port_summary(port_state), jax_hist, port_hist)


def _slow_observables(out):
    assert out["g_norm"][2] < 1e-2, out["g_norm"]
    assert out["d_norm"][2] < 1e-2, out["d_norm"]
    for i, sigma in enumerate(out["sigma"]):
        assert sigma[2] < 0.15, (i, sigma)


@pytest.mark.slow
def test_100_step_drift_envelope():
    jax_hist, port_hist, out = _run(128, 4, 100)
    np.testing.assert_allclose(jax_hist[:4], port_hist[:4], **WINDOW)
    _slow_observables(out)
    np.testing.assert_allclose(out["tail_loss_G"][0], out["tail_loss_G"][1], rtol=0.25,
                               atol=0.02)
    np.testing.assert_allclose(out["tail_loss_D"][0], out["tail_loss_D"][1], rtol=0.25,
                               atol=0.02)


def test_short_drift_window():
    jax_hist, port_hist, out = _run(64, 2, 10)
    np.testing.assert_allclose(jax_hist[:3], port_hist[:3], **WINDOW)
    np.testing.assert_allclose(jax_hist[3:], port_hist[3:], rtol=0.8, atol=0.1)
    assert abs(jax_hist[0, 0] - jax_hist[-1, 0]) > 1e-3  # training moves
    _slow_observables(out)
