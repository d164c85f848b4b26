"""``cli train`` and ``cli test`` of the port on a spatial mesh, on the CPU:
two gloo ranks under ``torchrun`` with ``--spatial 2`` (one data share, each
rank holding rows 0-31 or 32-63 of every image) against one process.

fft_glo at 64², float32, global batch 2, one epoch of 2 steps after step 0
on 5 synthetic A|B PNG pairs, once with the pool staging (the uint8 set on
the device, each batch cut to the rank's rows there) and once streamed
(``PrefetchLoader`` decoding the rank's rows, ``device_prefetch``): both
runs' JSONL logs (rank 0 writes) hold the steps of one process's, step 1's
metrics within rel 1e-5 / abs 1e-6 of its (the bound of
``test_torch_parallel_spatial.py``), the later steps' within the lockstep
bounds of ``test_torch_parallel_cli.py`` (rel 3e-3 / abs 1e-4: Adam turns
the float32 order of the gradients' sums into steps of the learning rate);
the summary line names the mesh. Each checkpoint (423 MiB) is deleted.
``cli test`` on a spatial pair is in ``test_torch_parallel_spatial_serve.py``.
"""

import json
import os
import shutil

from test_torch_cli_train import _write_pairs
from test_torch_parallel_cli import _log, _torchrun
from tfcgan_tpu_torch import cli


def test_train_on_a_spatial_pair_matches_one_process(tmp_path):
    data = str(tmp_path / "data")
    _write_pairs(data, "train", 5, 64, seed=5)
    common = ["--experiment", "fft_glo", "--data-root", data, "--image-size", "64",
              "--batch-size", "2", "--dtype", "float32", "--device", "cpu"]
    train = ["train", *common, "--n-epochs", "1", "--checkpoint-interval", "0",
             "--sample-interval", "100"]
    one = str(tmp_path / "one")
    cli.main([*train, "--out-dir", one])
    rows1 = _log(one)
    assert [r["step"] for r in rows1] == [1, 2]
    shutil.rmtree(os.path.join(one, "step_00000003"))
    for staging in ("pool", "stream"):
        out = str(tmp_path / staging)
        stdout = _torchrun([*train, "--staging", staging, "--num-workers", "1", "--spatial", "2",
                            "--out-dir", out])
        rows2 = _log(out)
        assert [r["step"] for r in rows2] == [1, 2], staging
        for i, (r2, r1) in enumerate(zip(rows2, rows1)):
            rel, abs_ = (1e-5, 1e-6) if i == 0 else (3e-3, 1e-4)
            for k in r1:
                if k not in ("ts", "wall_s", "step"):
                    assert abs(r2[k] - r1[k]) <= abs_ + rel * abs(r1[k]), (staging, k, r2[k], r1[k])
        summary = [line for line in stdout.splitlines() if line.startswith("data-parallel run: ")]
        assert len(summary) == 1, stdout[-2000:]
        run = json.loads(summary[0].split(": ", 1)[1])
        assert run["mesh"] == {"data": 1, "spatial": 2} and run["steps"] == 3, run
        assert "spatial 2" in stdout
        shutil.rmtree(os.path.join(out, "step_00000003"))
