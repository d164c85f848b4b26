"""The STN CLI journey's training through the library on the card, to tell
the CLI's data path from the training itself.

Trains ``stn_newmodel3`` as ``cli train`` does in
``tools/run_e2e_stn_journey_torch.sh`` (256², batch 32, the registry's
config: perceptual "auto", the msrecon anchor without LPIPS weights; lr
1e-4; ``Trainer.init_state(SEED)``; step 0 on the first batch, then 100
epochs of 16 steps through ``Trainer.fit``, each drawing one batch past its
last step as the CLI's does: 1601 steps) on one of two sources:

- ``cli``: the journey's own batches, the train pairs of the e2e face set
  (``tools/make_e2e_dataset_torch.py --scene face --warp-b``, B misaligned
  by PIL on 8-bit values) through ``PairedImageDataset`` and ``DevicePool``
  in ``cli train``'s order (``index_batches(32, seed=SEED)``);
- ``synthetic``: the STN anchor's batches (``tools/train_stn_anchor_torch.py``:
  ``synthetic_registration_batch`` seeds 1-60, B warped in float32), in turn.

``--dtype float32`` runs the same steps without bfloat16. At step 1 and
after every ``--eval-every`` epochs it serves the set's test pairs
(``Inferencer``) and records the ground-truth registration as ``cli
eval-reg`` computes it on the journey's crops: test_aligned_B against B
(before) and against warped_B (after), each through its 8-bit PNG values;
beside them the step's g_morph and g_recon. The record goes to ``--out``
(JSON) with the card's ``nvidia-smi`` name and power limit.

    python tools/stn_journey_diag_torch.py --data ROOT --source cli|synthetic
        [--seed 42] [--dtype bfloat16|float32] [--epochs 100] [--eval-every 25]
        --out RECORD.json
"""

import argparse
import dataclasses
import json
import os
import sys
import time

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_TOOLS), _TOOLS]

import numpy as np
import torch

from family_journey_torch import card_line

SIZE, BATCH, POOL = 256, 32, 60


def _u8_values(x: np.ndarray) -> np.ndarray:
    """[-1, 1] -> the [-1, 1] values an 8-bit PNG of it reads back as."""
    from tfcgan_tpu_torch.evaluation.suite import to_uint8

    return to_uint8(x).astype(np.float32) / 127.5 - 1.0


def test_set(root: str, direction: str) -> dict[str, np.ndarray]:
    """The e2e set's test pairs (A, B) and test_aligned_B, [-1, 1]."""
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset
    from tfcgan_tpu_torch.evaluation.suite import _load_dir

    ds = PairedImageDataset(root, "test", SIZE, direction)
    pairs = [ds[i] for i in range(len(ds))]
    _, aligned = _load_dir(os.path.join(root, "test_aligned_B"))
    return {"A": np.stack([p["A"] for p in pairs]), "B": np.stack([p["B"] for p in pairs]),
            "aligned": aligned / 127.5 - 1.0}


def registration(cfg, nets, test: dict, device) -> dict[str, float]:
    """Ground-truth SSIM, NCC and MI before and after, as ``cli eval-reg``."""
    from tfcgan_tpu_torch.evaluation.suite import registration_metrics
    from tfcgan_tpu_torch.infer import Inferencer

    modes = [(m, m.training) for m in nets.modules()]  # Inferencer leaves them in eval
    out = Inferencer(cfg, nets)({"A": test["A"], "B": test["B"]})
    for m, mode in modes:
        m.training = mode
    warped = _u8_values(out["warped_B"].float().cpu().numpy())
    b = _u8_values(test["B"])
    got = registration_metrics(*(torch.from_numpy(np.asarray(x, np.float32)).to(device)
                                 for x in (test["aligned"], b, warped)))
    return {k: float(v.mean()) for k, v in got.items()}


def run(root: str, source: str, seed: int, dtype: str, epochs: int, eval_every: int,
        device="cuda", log=print) -> dict:
    from tfcgan_tpu_torch.config import get_experiment
    from tfcgan_tpu_torch.data.pairs import PairedImageDataset
    from tfcgan_tpu_torch.data.pool import DevicePool
    from tfcgan_tpu_torch.data.prefetch import stage_batch
    from tfcgan_tpu_torch.data.synth import synthetic_registration_batch
    from tfcgan_tpu_torch.recipes import build_recipe
    from tfcgan_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("stn_journey_diag_torch: no CUDA card")
    cfg = get_experiment("stn_newmodel3")
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, root=root, batch_size=BATCH,
                                               image_size=SIZE),
                      train=dataclasses.replace(cfg.train, seed=seed, compute_dtype=dtype,
                                                n_epochs=epochs))
    recipe = build_recipe(cfg, device)
    trainer = Trainer(cfg, recipe)
    test = test_set(root, cfg.data.direction)
    pool = None
    if source == "cli":
        ds = PairedImageDataset(root, "train", SIZE, cfg.data.direction)
        pool = DevicePool(ds, device)
        it = pool.index_batches(BATCH, seed=seed)
        steps_per_epoch = len(ds) // BATCH
    else:
        staged = [stage_batch(synthetic_registration_batch(BATCH, SIZE, seed=i + 1)[0], device)
                  for i in range(POOL)]
        it = (staged[i % POOL] for i in range(10**9))
        steps_per_epoch = 16
    first = next(it)
    state = trainer.init_state(seed)
    history = [{"step": 0, **registration(cfg, recipe.G, test, device)}]
    t0 = time.perf_counter()

    def record():
        m = trainer.last_metrics
        row = {"step": state.step, **{k: float(m[k]) for k in ("loss_G", "g_morph", "g_recon")},
               **registration(cfg, recipe.G, test, device)}
        history.append(row)
        log(json.dumps(row))

    state = trainer.fit(state, [first], pool=pool)  # step 0
    record()
    for epoch in range(epochs):
        state = trainer.fit(state, it, num_steps=steps_per_epoch, pool=pool)
        if (epoch + 1) % eval_every == 0:
            record()
    return {"what": "stn_newmodel3 through the library on the STN CLI journey's settings "
                    "(tools/stn_journey_diag_torch.py)",
            "source": source, "seed": seed, "dtype": dtype, "steps": state.step,
            "card": card_line() if device.type == "cuda" else "",
            "seconds": time.perf_counter() - t0, "history": history}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--source", required=True, choices=("cli", "synthetic"))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--eval-every", type=int, default=25, help="epochs between evaluations")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    rec = run(args.data, args.source, args.seed, args.dtype, args.epochs, args.eval_every,
              args.device)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
