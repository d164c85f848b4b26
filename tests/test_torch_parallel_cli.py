"""``cli train`` and ``cli test`` of the port under ``torchrun`` on the CPU:
two gloo ranks (``python -m torch.distributed.run --standalone
--nproc_per_node 2``, a free rendezvous port of its own) against one
process.

fft_glo at 64², float32, global batch 2 (one image a rank), 2 epochs of 2
steps on 5 synthetic A|B PNG pairs (pool staging): the two ranks' JSONL log
(written by rank 0) holds the same steps as one process's, its metrics
within the lockstep bounds of test_torch_train.py (rel 3e-3 / abs 1e-4: the
same global batch and draws, float32 summation order compounded by the Adam
steps); rank 0 writes the same checkpoints, and its summary line counts 2
gradient all-reduces a step. ``cli test --checkpoint`` over 3 test pairs at
batch 2 under two ranks (each batch padded to a multiple of 2, served a
sample a rank, gathered and trimmed) writes, on rank 0 only, the stacks one
process writes from the same checkpoint, to one 8-bit level. Each
checkpoint (423 MiB) is deleted once it has been read.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np

from test_torch_cli_train import _write_pairs
from tfcgan_tpu_torch import cli
from tfcgan_tpu_torch.evaluation.suite import _read_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Torchrun:
    """``cli`` under torchrun, 2 ranks, started at once: the caller computes
    while it runs, and ``wait()`` returns its standard output. Killed with its
    ranks on overrun, or when the caller's block raises."""

    def __init__(self, args, timeout=240):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "tfcgan_tpu_torch.cli", *args]
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
        self.timeout = timeout
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, cwd=REPO, env=env, start_new_session=True)

    def wait(self) -> str:
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        assert self.proc.returncode == 0, f"{out[-3000:]}\n{err[-6000:]}"
        return out

    def kill(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)  # torchrun and its ranks
            self.proc.communicate()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is not None:
            self.kill()


def _torchrun(args, timeout=240):
    """``cli`` under torchrun, 2 ranks; killed with its ranks on overrun."""
    return Torchrun(args, timeout).wait()


def _log(out):
    with open(os.path.join(out, "logs", "fft_glo.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_and_test_under_torchrun_match_one_process(tmp_path):
    data = str(tmp_path / "data")
    _write_pairs(data, "train", 5, 64, seed=3)
    _write_pairs(data, "test", 3, 64, seed=4)
    common = ["--experiment", "fft_glo", "--data-root", data, "--image-size", "64",
              "--batch-size", "2", "--dtype", "float32", "--device", "cpu"]
    train = ["train", *common, "--n-epochs", "2", "--checkpoint-interval", "1",
             "--sample-interval", "100"]
    two, one = str(tmp_path / "two"), str(tmp_path / "one")

    def checkpoints(out, keep=None):
        """The run's checkpoint names; each (423 MiB of fft_glo) deleted but ``keep``."""
        names = sorted(d for d in os.listdir(out) if d.startswith("step_"))
        for name in names:
            if name != keep:
                shutil.rmtree(os.path.join(out, name))
        return names

    cli.main([*train, "--out-dir", one])
    ckpts1 = checkpoints(one)
    stdout = _torchrun([*train, "--out-dir", two])
    ckpts2 = checkpoints(two, keep="step_00000005")

    # rank 0 alone logs and checkpoints; the same steps as one process
    rows2, rows1 = _log(two), _log(one)
    assert [r["step"] for r in rows2] == [r["step"] for r in rows1] == [1, 2, 4]
    for r2, r1 in zip(rows2, rows1):
        for k in r1:
            if k not in ("ts", "wall_s", "step"):
                assert abs(r2[k] - r1[k]) <= 1e-4 + 3e-3 * abs(r1[k]), (k, r2[k], r1[k])
    assert ckpts2 == ckpts1 == ["step_00000003", "step_00000005"]
    assert not [d for d in os.listdir(two) if d.startswith(".step_")]  # no temporary left
    summary = [line for line in stdout.splitlines() if line.startswith("data-parallel run: ")]
    assert len(summary) == 1, stdout[-2000:]  # printed by rank 0 only
    run = json.loads(summary[0].split(": ", 1)[1])
    assert run["world"] == 2 and run["steps"] == 5 and run["grad_allreduces"] == 10
    assert stdout.count("G params:") == 1

    # serve the two-rank checkpoint: two ranks and one process write the same stacks
    ckpt = os.path.join(two, "step_00000005")
    served2, served1 = str(tmp_path / "served2"), str(tmp_path / "served1")
    out = _torchrun(["test", *common, "--checkpoint", ckpt, "--out-dir", served2])
    assert out.count("wrote 3 stacks") == 1
    cli.main(["test", *common, "--checkpoint", ckpt, "--out-dir", served1])
    checkpoints(two)
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(served1, "*.png")))
    assert names == ["00000.png", "00001.png", "00002.png"]
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(served2, "*.png"))) == names
    for name in names:
        a = _read_rgb(os.path.join(served2, name)).astype(int)
        b = _read_rgb(os.path.join(served1, name)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
