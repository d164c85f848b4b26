"""The debiased family end to end in the port, on the CPU: the journey
``cli train --annots`` (``fft_patch_debiased``, 64², batch 2, float32: step
0 on the first batch, then 2 epochs of 2 steps) with its labels CSV, no
sample grids, ``--resume``, and the refusals (no ``--annots``; ``test`` on a
conditional experiment); and the library resume of V4, whose regional heads
G's Adam trains: 3 steps straight against 1 step, ``save_checkpoint``,
``restore_checkpoint`` into a recipe drawn from another seed and 2 steps,
metrics and every tensor of the state (the regional CNNs and the heads'
Adam moments included) bit for bit. And a 2-step lockstep of V4
(``fft_patch_debiased_v4``, 128²) against the JAX ``Trainer``'s compiled
step, with the JAX draws, as test_torch_train.py runs fft_glo's. Step 1 (the
step-0 weights): every term within rtol 1e-4, and the regional heads, which
G's Adam steps on both sides, moved as the JAX state's (bridged) moved to
1e-3 of their move, their Adam moments to 1e-3, in L2 norm. Step 2: every
term within rtol 2e-2 (``LOCKSTEP_RTOL``) and the heads within 1e-1: kinks
at 128² make step 1's G update noisy.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_cli_train import _write_pairs
from test_torch_debiased_entries import TERMS, entry_batch, entry_cfg, jax_state, jax_step_draws
from tfcgan_tpu.parallel.mesh import make_mesh, place_state, shard_batch
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import train_state_from_flax
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train.checkpoint import (latest_checkpoint, restore_checkpoint,
                                               save_checkpoint)
from tfcgan_tpu_torch.train.state import TrainState
from tfcgan_tpu_torch.train.trainer import Trainer

# the lockstep's step-2 terms: Adam's first update moves every weight by
# about lr whatever its gradient's size, so the G weights whose gradient
# float32 rounding moves across 0 at 128² (ReLU kinks, see
# test_torch_debiased_entries.KINKED_TOL) step either way. On this CPU,
# scaling A by 1 + 1e-7 in step 1 moves the port's own step-2 terms by up to
# 3.8e-3; the JAX ones sit 1.2e-2 away.
LOCKSTEP_RTOL = 2e-2


def _write_annots(path, files):
    """The labels CSV: a header, then file, gender, ethnicity, age."""
    rows = ["file,gender,ethnicity,age"] + [f"{f},{i % 2},{i % 4},{i % 3}"
                                            for i, f in enumerate(files)]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def test_conditional_train_resume_journey(tmp_path, capsys):
    data, runs, resumed = (str(tmp_path / d) for d in ("data", "runs", "resumed"))
    _write_pairs(data, "train", 5, 64, seed=7)
    _write_pairs(data, "test", 2, 64, seed=8)
    annots = str(tmp_path / "annots.csv")
    _write_annots(annots, [os.path.join("train", f) for f in sorted(os.listdir(
        os.path.join(data, "train")))])
    common = ["--experiment", "fft_patch_debiased", "--data-root", data, "--image-size", "64",
              "--batch-size", "2", "--dtype", "float32", "--device", "cpu"]
    with pytest.raises(SystemExit, match="--annots"):
        cli.main(["train", *common, "--out-dir", runs])
    cli.main(["train", *common, "--annots", annots, "--n-epochs", "2",
              "--checkpoint-interval", "1", "--sample-interval", "2", "--out-dir", runs])
    assert "sample grids off" in capsys.readouterr().out
    assert sorted(d for d in os.listdir(runs) if d.startswith("step_")) == [
        "step_00000003", "step_00000005"]
    with open(os.path.join(runs, "logs", "fft_patch_debiased.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2, 4]
    assert all(np.isfinite(r[k]) for r in rows for k in ("loss_G", "loss_D", "g_ce", "d_ce"))
    assert not os.path.exists(os.path.join(runs, "samples"))
    # the checkpoint carries the frozen regional CNNs
    assert torch.load(os.path.join(runs, "step_00000005", "state.pt"),
                      weights_only=True)["cnns"] is not None

    cli.main(["train", *common, "--annots", annots, "--n-epochs", "1",
              "--checkpoint-interval", "1", "--out-dir", resumed,
              "--resume", os.path.join(runs, "step_00000003")])
    assert latest_checkpoint(resumed) == os.path.join(resumed, "step_00000005")
    with pytest.raises(SystemExit, match="conditional"):
        cli.main(["test", *common, "--checkpoint", latest_checkpoint(runs), "--out-dir",
                  str(tmp_path / "served")])


def _everything(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor a resume must restore, by name."""
    out = {f"{m}.{k}": v for m, module in (("G", state.G), ("D", state.D), ("cnns", state.cnns))
           for k, v in module.state_dict().items()}
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state[p].items():
                out[f"{name}.{i}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


def test_v4_resume_is_bit_exact(tmp_path):
    cfg = entry_cfg("fft_patch_debiased_v4", size=64)
    cfg = cfg.replace(extra={})  # dropout on: G's keep-masks come from the generator
    batches = [entry_batch(cfg, seed=s) for s in range(3)]
    trainer = Trainer(cfg, build_recipe(cfg, "cpu"))
    straight = trainer.init_state(seed=3)
    want = [trainer.step(straight, b) for b in batches]
    want_state = _everything(straight)

    trainer = Trainer(cfg, build_recipe(cfg, "cpu"))
    state = trainer.init_state(seed=3)
    got = [trainer.step(state, batches[0])]
    path = save_checkpoint(str(tmp_path), state)
    trainer = Trainer(cfg, build_recipe(cfg, "cpu"))
    state = restore_checkpoint(path, trainer.init_state(seed=11))
    got += [trainer.step(state, b) for b in batches[1:]]
    assert state.step == straight.step == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and all(torch.equal(g[k], w[k]) for k in w)
    got_state = _everything(state)
    assert got_state.keys() == want_state.keys()
    heads = {f"cnns.{n}" for n, p in state.cnns.named_parameters() if p.requires_grad}
    assert heads == {f"cnns.cnn_{r}.fc.{leaf}" for r in ("hair", "eyes")
                     for leaf in ("weight", "bias")}
    # G's Adam holds the heads: G's parameters, then the four head tensors
    n_g = len(list(state.G.parameters()))
    assert len(state.opt_g.param_groups[0]["params"]) == n_g + 4
    assert f"opt_g.{n_g + 3}.exp_avg_sq" in got_state
    unequal = [k for k in want_state if not torch.equal(got_state[k], want_state[k])]
    assert not unequal, unequal


def _assert_heads_like_jax(jax_state_now, port_state, cfg, w0: dict, step: int, tol: float):
    """The regional heads after ``step`` steps, the port's against the JAX
    state's (bridged): both stepped by G's Adam ``step`` times, the weights'
    moves from ``w0`` and the Adam moments within ``tol`` in L2 norm."""
    bridged = train_state_from_flax(jax_state_now, build_recipe(cfg, "cpu"), torch.Generator())
    ref = dict(bridged.cnns.named_parameters())
    heads = {n: p for n, p in port_state.cnns.named_parameters() if p.requires_grad}
    assert sorted(heads) == sorted(f"{c}.fc.{leaf}" for c in ("cnn_hair", "cnn_eyes")
                                   for leaf in ("weight", "bias"))
    for n, p in heads.items():
        a, b = bridged.opt_g.state[ref[n]], port_state.opt_g.state[p]
        assert float(a["step"]) == float(b["step"]) == step
        want, got = ref[n].detach() - w0[n], p.detach() - w0[n]
        assert float((got - want).norm()) <= tol * float(want.norm()), (n, step)
        for k in ("exp_avg", "exp_avg_sq"):
            assert float((a[k] - b[k]).norm()) <= tol * float(b[k].norm()), (n, k, step)


def test_v4_two_step_lockstep_with_the_jax_trainer(monkeypatch):
    monkeypatch.delenv("TFCGAN_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("TFCGAN_RESNET_WEIGHTS", raising=False)
    cfg = entry_cfg("fft_patch_debiased_v4")
    recipe, state = jax_state(cfg)
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    port = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port, torch.Generator())
    w0 = {n: p.detach().clone() for n, p in port.cnns.named_parameters()}
    jax_rng = np.asarray(state.rng)  # a host copy: the compiled step donates the state
    trainer = Trainer(cfg, port, draw_fn=lambda s, b: jax_step_draws(jax_rng, s.step, cfg))
    state = place_state(state, jax_trainer.mesh)
    step_fn = jax_trainer.compiled_step()
    for step, rtol, heads_tol in ((1, 1e-4, 1e-3), (2, LOCKSTEP_RTOL, 1e-1)):
        batch = entry_batch(cfg, seed=step - 1)
        state, m = step_fn(state, shard_batch(batch, jax_trainer.mesh))
        mp = trainer.step(port_state, batch)
        np.testing.assert_allclose([float(mp[k]) for k in TERMS], [float(m[k]) for k in TERMS],
                                   rtol=rtol, atol=1e-4, err_msg=f"step {step}")
        _assert_heads_like_jax(state, port_state, cfg, w0, step, heads_tol)
    assert port_state.step == int(state.step) == 2
