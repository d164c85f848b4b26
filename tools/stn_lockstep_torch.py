"""The STN recipe's float32 lockstep against the JAX ``Trainer`` on the STN
CLI journey's kind of data, on the CPU.

``stn_newmodel3`` with ``tests/test_torch_stn_train.py``'s small ViT (depth
2, dim 96) at 64², batch 2, deterministic G, from one state of numpy draws
carried into the port by ``bridge.py``, on face pairs whose B is misaligned
by PIL on 8-bit values (``tools/make_e2e_dataset_torch.py --scene face
--warp-b --size 64``: 16 train pairs) in ``batch_iterator``'s order (seed
1). Beside the two it runs the JAX trainer once more with every batch's A
moved one float32 step up: what rounding alone makes of the run. It prints
theta_t (the mean |translation| of theta), g_morph and loss_G every few
steps and their means over the second half.

It runs on the host's CPU only: the JAX package is the reference, and the
tests' STN module drives it there.

    python tools/stn_lockstep_torch.py [--steps 60] [--data DIR]
"""

import argparse
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests"), os.path.join(_ROOT, "tools")]
os.environ["JAX_PLATFORMS"] = "cpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--data", default=os.path.join(tempfile.gettempdir(), "stn_lockstep_pairs"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import make_e2e_dataset_torch
    import test_torch_stn_train as stn
    from torch_jax_lockstep import jax_history
    from tfcgan_tpu_torch.bridge import train_state_from_flax
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset, batch_iterator
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    if not os.path.isdir(os.path.join(args.data, "train")):
        make_e2e_dataset_torch.main(["--root", args.data, "--scene", "face", "--warp-b",
                                     "--n", "16", "--test", "2", "--size", "64"])
    cfg = stn._cfg()
    it = batch_iterator(PairedImageDataset(args.data, "train", 64, "AtoB"), 2, seed=1)
    batches = [{k: v for k, v in next(it).items() if k in ("A", "B", "T_B")}
               for _ in range(args.steps)]
    terms = stn.TERMS[cfg.name]

    def jax_run(nudge: bool) -> np.ndarray:
        recipe, state = stn._jax_state(cfg)
        return jax_history(cfg, recipe, state, batches, terms, nudge)[1]

    _, state = stn._jax_state(cfg)
    recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, recipe, torch.Generator())
    trainer = Trainer(cfg, recipe, draw_fn=stn._no_draws)
    port = []
    for b in batches:
        m = trainer.step(port_state, b)
        port.append([float(m[k]) for k in terms])
    runs = {"jax": jax_run(False), "port": np.asarray(port), "nudged": jax_run(True)}
    cols = {k: terms.index(k) for k in ("theta_t", "g_morph", "loss_G")}
    for s in sorted({*range(0, args.steps, 5), args.steps - 1}):
        print(f"step {s}: " + " | ".join(
            f"{k} " + " ".join(f"{name} {h[s, i]:.5f}" for name, h in runs.items())
            for k, i in cols.items()))
    half = args.steps // 2
    means = {k: {name: float(h[half:, i].mean()) for name, h in runs.items()}
             for k, i in cols.items()}
    for k, m in means.items():
        print(f"mean {k} over steps {half}-{args.steps - 1}: "
              + ", ".join(f"{name} {v:.5f}" for name, v in m.items()))
    return means


if __name__ == "__main__":
    main()
