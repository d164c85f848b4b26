"""The NeMAR and CycleGAN CLI journeys (``tools/run_e2e_nemar_journey_torch.sh``,
``run_e2e_cyclegan_journey_torch.sh``) on the CPU.

- Every ``python -m tfcgan_tpu_torch.cli`` command of both scripts parses with
  the port's own argparse (the subcommands' functions replaced by a
  recorder), so that a flag that drifts fails here and not on the card.
- The NeMAR chain through ``cli.main`` at 128² (NeMAR's STN needs it), batch
  1, float32: face pairs with a misaligned B from
  ``tools/make_e2e_dataset_torch.py``, ``train`` on one pair for one epoch
  (two steps: step 0 on the first batch, then the epoch's) -> ``test`` (the
  6-image stacks) -> the 6-role ``prep-crop`` -> ``eval-reg`` over (real_B,
  real_A, reg_A) -> ``eval --iqa niqe`` of fake_TR_B against real_B. The
  port's ``eval-reg`` and ``eval`` means equal the JAX CLI's (``--cpu``) on
  the same cropped PNGs at rel 1e-6. About 25 s on one worker.
"""

import contextlib
import csv
import importlib.util
import io
import os
import re
import shlex

import numpy as np
import pytest

from tfcgan_tpu import cli as jax_cli
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.train.checkpoint import latest_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("run_e2e_nemar_journey_torch.sh", "run_e2e_cyclegan_journey_torch.sh")
ROLES = "real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B"


def _cli_commands(script: str) -> list[list[str]]:
    """The argument lists of the script's ``python -m tfcgan_tpu_torch.cli``
    commands (comments skipped), shell variables and substitutions replaced
    by a word."""
    with open(os.path.join(ROOT, "tools", script)) as f:
        text = f.read().replace("\\\n", " ")
    text = text.replace("$PLOTS", "--plots-dir DIR")
    text = re.sub(r"\$\([^)]*\)|\$\{[^}]*\}|\$\w+", "X", text)
    found = []
    for line in text.splitlines():
        if line.lstrip().startswith("#"):
            continue
        for part in line.split("python -m tfcgan_tpu_torch.cli")[1:]:
            found.append(shlex.split(re.split(r"\|\||\||>", part)[0]))
    return found


@pytest.mark.parametrize("script", SCRIPTS)
def test_the_scripts_commands_parse(script, monkeypatch):
    seen = []
    for name in [n for n in dir(cli) if n.startswith("cmd_")]:
        monkeypatch.setattr(cli, name, lambda args, name=name: seen.append(name))
    commands = _cli_commands(script)
    want = {"run_e2e_nemar_journey_torch.sh": ["cmd_train", "cmd_test", "cmd_prep_crop",
                                               "cmd_eval_reg", "cmd_eval"],
            "run_e2e_cyclegan_journey_torch.sh": ["cmd_train", "cmd_test", "cmd_prep_crop",
                                                  "cmd_eval", "cmd_eval"]}[script]
    for argv in commands:
        cli.main(argv)  # an unknown flag or a bad value exits here
    assert seen == want


def _means(path: str) -> dict[str, float]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: float(np.mean([float(r[k]) for r in rows])) for k in rows[0] if k != "file"}


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        main(argv)


def test_nemar_chain_through_the_cli(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "make_e2e_dataset_torch", os.path.join(ROOT, "tools", "make_e2e_dataset_torch.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    data, runs, out = (str(tmp_path / d) for d in ("data", "runs", "eval"))
    _quiet(maker.main, ["--root", data, "--scene", "face", "--warp-b", "--n", "1",
                        "--test", "2", "--size", "128"])
    common = ["--experiment", "nemar", "--data-root", data, "--image-size", "128",
              "--batch-size", "1", "--dtype", "float32", "--device", "cpu"]
    _quiet(cli.main, ["train", *common, "--n-epochs", "1", "--out-dir", runs])
    ckpt = latest_checkpoint(runs)
    assert os.path.basename(ckpt) == "step_00000002"
    _quiet(cli.main, ["test", *common, "--checkpoint", ckpt, "--out-dir", f"{out}/stacks"])
    _quiet(cli.main, ["prep-crop", "--device", "cpu", "--stack-dir", f"{out}/stacks",
                      "--out-root", out, "--roles", ROLES])
    assert all(len(os.listdir(os.path.join(out, r))) == 2 for r in ROLES.split(","))
    reg = ["--real-a-dir", f"{out}/real_B", "--real-b-dir", f"{out}/real_A",
           "--reg-b-dir", f"{out}/reg_A"]
    pair = ["--fake-dir", f"{out}/fake_TR_B", "--real-dir", f"{out}/real_B", "--iqa", "niqe"]
    for tag, main, where in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, ["--cpu"])):
        _quiet(main, ["eval-reg", *where, *reg, "--out-csv", f"{out}/reg_{tag}.csv"])
        _quiet(main, ["eval", *where, *pair, "--out-csv", f"{out}/pair_{tag}.csv"])
    for name, cols in (("reg", {"ssim_before", "ssim_after", "ncc_before", "ncc_after",
                                "mi_before", "mi_after"}),
                       ("pair", {"psnr", "ssim", "ssim_gray", "bhatt", "fft_mag_mse",
                                 "fft_mag_mae", "niqe_fake", "niqe_real"})):
        got, want = _means(f"{out}/{name}_port.csv"), _means(f"{out}/{name}_jax.csv")
        assert set(got) == set(want) == cols, (name, sorted(got))
        assert all(np.isfinite(v) for v in got.values()), got
        for k in cols:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=f"{name} {k}")
