#!/bin/bash
# The NeMAR end-to-end CLI journey on the card, port of
# tools/run_e2e_nemar_journey.sh: train nemar on 256 face pairs whose B is
# misaligned (rotation +-4 degrees, translation +-6 px) -> `cli test`'s
# 6-image stacks (A | B | registered_A | fake_B | fake_TR_B | fake_RT_B) ->
# crop -> eval-reg over (real_B, real_A, reg_A): netR warps A onto B, so the
# moving image is A and "before" is the raw misalignment -> eval --iqa niqe of
# fake_TR_B against real_B. K3 (the dense sampler, forward and backward) runs
# in both of NeMAR's STN warps in every train step and in every served batch.
# The difference plot needs matplotlib, which the card's machine lacks: there
# the first test image's three crops are kept instead, and
#   python -m tfcgan_tpu_torch.cli eval-reg --device cpu \
#     --real-a-dir ART/first_crops/real_B --real-b-dir ART/first_crops/real_A \
#     --reg-b-dir ART/first_crops/reg_A --out-csv /tmp/x.csv --plots-dir ART
# draws it on a host that has matplotlib.
#
#   bash tools/run_e2e_nemar_journey_torch.sh > e2e_nemar.log 2>&1
#
# The run writes under $TMPDIR; the metric CSVs, their means, one stack, the
# train log, the card's nvidia-smi line and summary.json go to
# tools/artifacts/torch/nemar_e2e/.
set -x
cd "$(dirname "$0")/.." || exit 1
ROOT=${TMPDIR:-/tmp}/e2e_nemar_pairs_torch
RUN=${TMPDIR:-/tmp}/e2e_nemar_run_torch
ART=tools/artifacts/torch/nemar_e2e

python tools/make_e2e_dataset_torch.py --root $ROOT --scene face --warp-b \
  --n 256 --test 16 --size 128 || exit 1

# 50 epochs x 16 steps an epoch = 800 steps at batch 16, 128²
timeout 3600 python -m tfcgan_tpu_torch.cli train --experiment nemar \
  --data-root $ROOT --batch-size 16 --image-size 128 --n-epochs 50 \
  --checkpoint-interval 49 --sample-interval 400 --out-dir $RUN || exit 1

CKPT=$(ls -d $RUN/step_* | sort | tail -1)
OUT=$RUN/eval_$(basename $CKPT)
timeout 1800 python -m tfcgan_tpu_torch.cli test --experiment nemar \
  --data-root $ROOT --image-size 128 --checkpoint $CKPT \
  --out-dir $OUT/stacks || exit 1
python -m tfcgan_tpu_torch.cli prep-crop --device cpu --stack-dir $OUT/stacks \
  --out-root $OUT --roles real_A,real_B,reg_A,fake_B,fake_TR_B,fake_RT_B || exit 1
PLOTS=""
python -c "import matplotlib" 2>/dev/null && PLOTS="--plots-dir $OUT/diff_plots"
timeout 1200 python -m tfcgan_tpu_torch.cli eval-reg --device cpu --real-a-dir $OUT/real_B \
  --real-b-dir $OUT/real_A --reg-b-dir $OUT/reg_A \
  --out-csv $OUT/reg_metrics.csv $PLOTS > $OUT/reg_metrics_mean.txt 2>&1 || exit 1
cat $OUT/reg_metrics_mean.txt
# translation quality of the serve output against the real thermal side
timeout 1200 python -m tfcgan_tpu_torch.cli eval --device cpu --fake-dir $OUT/fake_TR_B \
  --real-dir $OUT/real_B --out-csv $OUT/pair_metrics.csv --iqa niqe \
  > $OUT/pair_metrics_mean.txt 2>&1 || exit 1
cat $OUT/pair_metrics_mean.txt

rm -rf $ART && mkdir -p $ART
cp $OUT/reg_metrics.csv $OUT/reg_metrics_mean.txt $OUT/pair_metrics.csv \
  $OUT/pair_metrics_mean.txt $ART/
FIRST=$(ls $OUT/stacks/*.png | sort | head -1)
cp $FIRST $ART/stack_00000.png
if [ -n "$PLOTS" ]; then
  cp $(ls $OUT/diff_plots/*.png | sort | head -1) $ART/diff_plot_00000.png
else
  NAME=$(ls $OUT/real_A | sort | head -1)
  for ROLE in real_A real_B reg_A; do
    mkdir -p $ART/first_crops/$ROLE && cp $OUT/$ROLE/$NAME $ART/first_crops/$ROLE/
  done
fi
cp $RUN/logs/nemar.jsonl $ART/train_log.jsonl
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $ART/card.txt 2>/dev/null
python tools/e2e_summary_torch.py --run $RUN --art $ART --experiment nemar \
  --what "nemar e2e CLI journey (tools/run_e2e_nemar_journey_torch.sh)" || exit 1
echo "E2E_NEMAR_JOURNEY_DONE"
