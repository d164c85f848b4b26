"""Weight and gradient histograms of the port against the JAX package's, on
the CPU.

``tree_histograms`` of G's and D's weights bridged from a JAX state (fft_glo,
64²): each port tensor is a reordering of a JAX leaf (HWIO vs OIHW), so its
counts, min and max equal the JAX leaf's exactly and mean, std and l2 are
float32 sums in another order (rtol 1e-6, atol 1e-9 for a mean of cancelling
terms); the port's JSONL record has the JAX logger's schema, and
``write_histogram_html`` of one JSONL gives the JAX renderer's bytes.
``Trainer.fit(hist_every=2)`` in lockstep with the JAX ``Trainer.fit`` (3
steps, B=2, 64², as the JAX U-Net refuses 32², the JAX step's draws): records
at steps 1 and 3, as ``tests/test_histograms.py`` has them; the weights
after each update and the step's gradients within ``LOCKSTEP_BOUNDS`` (step
1's gradients within the fixed-weight bound of ``test_torch_train.py``;
after two Adam steps the packages' weights and gradients have drifted apart
as in its locksteps, so some values change bins: the counts are compared by
their earth mover's distance). ``cli train --hist-every`` writes the records of
the JAX rule (each epoch's loop counts from 0; step 0 is not logged) and the
page. About 40 s on one worker.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_cli_train import _write_pairs
from test_torch_train import _cfg, _jax_state, jax_step_draws
from tfcgan_tpu.parallel.mesh import make_mesh, place_state
from tfcgan_tpu.train.histograms import HistogramLogger as JaxHistogramLogger
from tfcgan_tpu.train.histograms import tree_histograms as jax_tree_histograms
from tfcgan_tpu.train.histograms import write_histogram_html as jax_write_histogram_html
from tfcgan_tpu.train.trainer import Trainer as JaxTrainer
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.bridge import (tfcgan_discriminator_from_flax, tfcgan_generator_from_flax,
                                     train_state_from_flax)
from tfcgan_tpu_torch.data.synth import synthetic_batch
from tfcgan_tpu_torch.recipes import build_recipe
from tfcgan_tpu_torch.train.histograms import (HistogramLogger, tree_histograms,
                                               write_histogram_html)
from tfcgan_tpu_torch.train.trainer import Trainer

STATS = ("lo", "hi", "mean", "std", "l2")
# The lockstep's records, port against JAX: the distance between the two
# histograms as the earth mover's distance of their counts, in units of the
# tensor's range per element (a histogram moved by one bin everywhere is
# 1/64 = 1.6e-2), and the stats' differences x max(|lo|, |hi|) (l2:
# relative). Measured on the CPU, largest over the tensors, with torch on 1
# and on 8 threads: weights after step 1 1.5e-7 / 6.5e-6 / 6.5e-6 and after
# step 3 4.9e-4 (a 64-element bias that starts at 0 and spans 2 lr: its
# bins are narrower than the packages' drift) / 8.1e-5 / 9.2e-5; gradients
# of step 1 (the fixed-weight setting of test_torch_train.py, bound 2e-4 x
# max|g| there) 2.3e-6 / 7.4e-6 / 4.3e-6 and of step 3, after two Adam steps
# whose updates differ where a gradient sits at float32 noise, 2.6e-3 /
# 6.4e-3 / 1.5e-3. Bounds about four times those.
LOCKSTEP_BOUNDS = {("weights", 1): (1e-6, 5e-4, 5e-4), ("weights", 3): (2e-3, 5e-4, 5e-4),
                   ("grads", 1): (1e-5, 2e-4, 2e-4), ("grads", 3): (1e-2, 2e-2, 5e-3)}


def _name_map(state) -> dict:
    """{port record name: JAX record name}: each JAX leaf filled with its
    index and carried through the bridge."""
    tree = {"G": state.g_params, "D": state.d_params}
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    names = ["/".join(str(p.key) for p in path) for path, _ in leaves]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [np.full(np.shape(v), i, np.float32) for i, (_, v) in enumerate(leaves)])
    port = {f"G/{k}": v for k, v in tfcgan_generator_from_flax(marked["G"]["G"]).items()}
    port.update({f"D/{k}": v for k, v in tfcgan_discriminator_from_flax(marked["D"]["D"]).items()})
    return {k: names[int(v.reshape(-1)[0])] for k, v in port.items()}


def _assert_stats(got: dict, want: dict, counts_exact: bool = True, what: str = ""):
    if counts_exact:
        assert got["counts"] == want["counts"], what
    assert got["lo"] == want["lo"] and got["hi"] == want["hi"], what
    for s in ("mean", "std", "l2"):
        np.testing.assert_allclose(got[s], want[s], rtol=1e-6, atol=1e-9, err_msg=f"{what} {s}")


@pytest.fixture(scope="module")
def bridged():
    cfg = _cfg(64, 2)
    recipe, state = _jax_state(cfg)
    port_state = train_state_from_flax(state, build_recipe(cfg, "cpu"), torch.Generator())
    return cfg, recipe, state, port_state


def _weights(port_state):
    return {"G": dict(port_state.G.named_parameters()),
            "D": dict(port_state.D.named_parameters())}


def _record(logger_cls, path, tree_fn, tree, step=1, kind="weights"):
    logger = logger_cls(str(path))
    logger.write(step, kind, tree_fn(tree))
    logger.close()
    with open(path) as f:
        return json.loads(f.readline())


def test_tree_histograms_of_bridged_weights(bridged, tmp_path):
    _, _, state, port_state = bridged
    weights = _weights(port_state)
    got = _record(HistogramLogger, tmp_path / "port.jsonl", tree_histograms, weights)
    want = _record(JaxHistogramLogger, tmp_path / "jax.jsonl", jax_tree_histograms,
                   {"G": state.g_params, "D": state.d_params})
    assert list(got) == list(want) == ["step", "kind", "leaves"]
    assert got["step"] == want["step"] == 1 and got["kind"] == want["kind"] == "weights"
    pairs = _name_map(state)
    assert sorted(got["leaves"]) == sorted(pairs) and sorted(pairs.values()) == sorted(want["leaves"])
    sizes = {f"{m}/{k}": p.numel() for m, d in weights.items() for k, p in d.items()}
    for name, jname in pairs.items():
        assert list(got["leaves"][name]) == ["counts", *STATS]
        assert sum(got["leaves"][name]["counts"]) == sizes[name]
        _assert_stats(got["leaves"][name], want["leaves"][jname], what=name)


def test_constant_and_exact_counts():
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    h = tree_histograms({"x": torch.from_numpy(x), "c": {"w": torch.ones(4, 5)}}, bins=32)
    lo, hi = x.min(), x.max()
    idx = np.clip(((x - lo) / max(hi - lo, 1e-12) * 32).astype(np.int32), 0, 31)
    assert h["x"]["counts"].tolist() == np.bincount(idx, minlength=32).tolist()
    c = h["c"]["w"]
    assert c["counts"][0] == 20 and int(c["counts"][1:].sum()) == 0
    assert np.isfinite(float(c["std"])) and float(c["std"]) == 0.0


def test_html_is_the_jax_renderers(bridged, tmp_path):
    _, _, state, port_state = bridged
    path = tmp_path / "hists.jsonl"
    logger = HistogramLogger(str(path))
    for step, kind in ((1, "weights"), (1, "grads"), (3, "weights")):
        logger.write(step, kind, tree_histograms(_weights(port_state), bins=16))
    logger.close()
    got = write_histogram_html(str(path), str(tmp_path / "port.html"))
    want = jax_write_histogram_html(str(path), str(tmp_path / "jax.html"), title="hists.jsonl")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert write_histogram_html(str(path)) == str(tmp_path / "hists.html")


def test_fit_hist_every_in_lockstep_with_the_jax_trainer(bridged, tmp_path):
    cfg, recipe, state, _ = bridged
    state = jax.tree.map(np.array, state)  # a host copy: the JAX step donates what it is given
    pairs = _name_map(state)
    port_recipe = build_recipe(cfg, "cpu")
    port_state = train_state_from_flax(state, port_recipe, torch.Generator())
    jax_rng = np.asarray(state.rng)
    trainer = Trainer(cfg, port_recipe,
                      draw_fn=lambda s, b: jax_step_draws(jax_rng, s.step, cfg.loss.patch_grid))
    jax_trainer = JaxTrainer(cfg, recipe, mesh=make_mesh(1))
    batches = [synthetic_batch(2, 64, seed=s) for s in range(3)]
    ours = HistogramLogger(str(tmp_path / "port.jsonl"))
    theirs = JaxHistogramLogger(str(tmp_path / "jax.jsonl"))
    port_state = trainer.fit(port_state, batches, hist_logger=ours, hist_every=2)
    jax_state = jax_trainer.fit(place_state(state, jax_trainer.mesh), batches,
                                hist_logger=theirs, hist_every=2)
    ours.close()
    theirs.close()
    assert port_state.step == int(jax_state.step) == 3
    got = [json.loads(line) for line in open(tmp_path / "port.jsonl")]
    want = [json.loads(line) for line in open(tmp_path / "jax.jsonl")]
    assert [(r["step"], r["kind"]) for r in got] == [(r["step"], r["kind"]) for r in want] == [
        (1, "weights"), (1, "grads"), (3, "weights"), (3, "grads")]
    sizes = {f"{m}/{k}": p.numel() for m, d in _weights(port_state).items() for k, p in d.items()}
    for g, w in zip(got, want):
        assert sorted(g["leaves"]) == sorted(pairs) and len(w["leaves"]) == len(pairs)
        # (counts' distance; stats x max(|lo|, |hi|); l2 relative)
        bound = LOCKSTEP_BOUNDS[g["kind"], g["step"]]
        for name, jname in pairs.items():
            a, b = g["leaves"][name], w["leaves"][jname]
            what = f"{g['step']} {g['kind']} {name}"
            assert sum(a["counts"]) == sum(b["counts"]) == sizes[name], what
            cdf_a, cdf_b = np.cumsum(a["counts"]), np.cumsum(b["counts"])
            emd = np.abs(cdf_a - cdf_b).sum() / (len(cdf_a) * sizes[name])
            assert emd <= bound[0], (what, emd)
            scale = max(abs(b["lo"]), abs(b["hi"]))
            for s in ("lo", "hi", "mean", "std"):
                assert abs(a[s] - b[s]) <= bound[1] * scale, (what, s, a[s], b[s])
            np.testing.assert_allclose(a["l2"], b["l2"], rtol=bound[2], err_msg=what)
    assert any(r["leaves"][n]["l2"] > 0 for r in got if r["kind"] == "grads" for n in pairs)


def test_cli_train_hist_every(tmp_path):
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    _write_pairs(data, "train", 4, 64, seed=9)
    # 4 pairs at batch 2: step 0, then 2 epochs of 2 steps; --hist-every 2
    # logs each epoch's first step (steps 2 and 4), as the JAX CLI does
    cli.main(["train", "--experiment", "fft_glo", "--data-root", data, "--image-size", "64",
              "--batch-size", "2", "--dtype", "float32", "--n-epochs", "2", "--hist-every", "2",
              "--device", "cpu", "--out-dir", out])
    recs = [json.loads(line) for line in open(os.path.join(out, "hists.jsonl"))]
    assert [(r["step"], r["kind"]) for r in recs] == [(2, "weights"), (2, "grads"),
                                                      (4, "weights"), (4, "grads")]
    n_params = {m: sum(sum(s["counts"]) for k, s in recs[0]["leaves"].items()
                       if k.startswith(m + "/")) for m in ("G", "D")}
    assert all(v > 0 for v in n_params.values())
    assert all(np.isfinite(s[k]) for r in recs for s in r["leaves"].values() for k in STATS)
    assert "<svg" in open(os.path.join(out, "hists.html")).read()
