"""Measure the long-horizon lockstep drift of the port's fft_glo Trainer
against the JAX ``Trainer``, the port's counterpart of
``tools/measure_drift.py``: the numbers that
``tests/test_torch_trajectory_drift.py`` cites.

Both trainers run ``tests/test_parity_trajectory.py::run_lockstep``'s
configuration (float32; no patch triplet, temperature or LPIPS; the global
FFT of the smooth luma; deterministic G) from one state of numpy draws, the
weights carried into the port by ``bridge.py``, on ``synthetic_batch`` seeds
0..n-1. It prints the relative differences of G's and D's global parameter
norms, of each D block's spectral sigma and of the last 30 steps' mean
losses, and the per-step loss differences at a few steps. With ``--floor``
it runs the JAX trainer once more with every batch's A moved one float32
step up and prints the same observables for JAX against that run: what
float32 rounding alone makes of the trajectory.

It runs on the host's CPU only: the JAX package is the reference, and the
tests' lockstep module (``tests/torch_jax_lockstep.py``) drives it there.

    python tools/measure_drift_torch.py [--steps 100] [--size 128] [--batch 4] [--floor]
"""

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"

STEPS_SHOWN = (0, 1, 2, 3, 4, 5, 10, 20, 40, 70, 99)


def report(what: str, out: dict) -> None:
    print(f"{what}:")
    for k in ("g_norm", "d_norm"):
        a, b, rel = out[k]
        print(f"  {k[0].upper()} norm {a:.6f} against {b:.6f}: rel diff {rel:.2e}")
    for i, (a, b, rel) in enumerate(out["sigma"]):
        print(f"  block{i} sigma {a:.6f} against {b:.6f}: rel diff {rel:.2e}")
    for k in ("tail_loss_G", "tail_loss_D"):
        a, b, rel = out[k]
        print(f"  last-{out['tail']} mean {k[5:]} {a:.4f} against {b:.4f}: rel diff {rel:.2e}")
    for k in ("step_rel_G", "step_rel_D"):
        rel = out[k]
        print(f"  loss_{k[-1]} rel diff by step: " + ", ".join(
            f"{s} {rel[s]:.2e}" for s in STEPS_SHOWN if s < len(rel)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--floor", action="store_true",
                    help="also run the JAX trainer with A one float32 step up")
    args = ap.parse_args(argv)

    from torch_jax_lockstep import (DRIFT_TERMS, _lockstep, drift_cfg, drift_observables,
                                    jax_run, jax_summary, port_summary)

    cfg = drift_cfg(args.size, args.batch)
    t0 = time.perf_counter()
    jax_state, port_state, jax_hist, port_hist = _lockstep(cfg, args.steps, DRIFT_TERMS)
    jax_sum = jax_summary(jax_state)
    out = {"port": drift_observables(jax_sum, port_summary(port_state), jax_hist, port_hist)}
    print(f"{args.steps} steps at {args.size}², B={args.batch}, float32 on the CPU, both "
          f"trainers: {time.perf_counter() - t0:.1f} s")
    report("JAX against the port", out["port"])
    if args.floor:
        nudged_state, nudged_hist = jax_run(cfg, args.steps, DRIFT_TERMS, nudge=True)
        out["floor"] = drift_observables(jax_sum, jax_summary(nudged_state), jax_hist,
                                         nudged_hist)
        report("JAX against JAX with A one float32 step up (the floor)", out["floor"])
    return out


if __name__ == "__main__":
    main()
