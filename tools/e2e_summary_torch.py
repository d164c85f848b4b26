"""Summary of an end-to-end CLI journey run by ``tools/run_e2e_*_torch.sh``.

Reads the run's training log (``RUN/logs/<experiment>.jsonl``) and the metric
CSVs the script copied into the artifact directory, and writes
``ART/summary.json``: the card's ``nvidia-smi`` name and power limit, loss_G
at the first and last logged steps, the wall ms a step between the second
and the last record (the sample hook and the checkpoint writes included),
and each CSV's column means.

    python tools/e2e_summary_torch.py --run RUN --art ART --experiment fft_glo
"""

import argparse
import csv
import glob
import json
import os
import sys

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_TOOLS), _TOOLS]

from family_journey_torch import card_line


def csv_means(path: str) -> dict[str, float]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: sum(float(r[k]) for r in rows) / len(rows) for k in rows[0] if k != "file"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--art", required=True)
    ap.add_argument("--experiment", required=True)
    ap.add_argument("--what", default="")
    args = ap.parse_args(argv)
    with open(os.path.join(args.run, "logs", f"{args.experiment}.jsonl")) as f:
        log = [json.loads(line) for line in f if line.strip()]
    summary = {"what": args.what, "experiment": args.experiment, "card": card_line(),
               "last_logged_step": log[-1]["step"], "loss_G_first": log[0]["loss_G"],
               "loss_G_last": log[-1]["loss_G"], "first_logged_step": log[0]["step"],
               "wall_ms_per_step": (1e3 * (log[-1]["ts"] - log[1]["ts"])
                                    / (log[-1]["step"] - log[1]["step"])
                                    if len(log) > 2 else None),
               "means": {os.path.basename(p): csv_means(p)
                         for p in sorted(glob.glob(os.path.join(args.art, "*.csv")))}}
    with open(os.path.join(args.art, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
