#!/bin/bash
# The CycleGAN end-to-end CLI journey on the card, port of
# tools/run_e2e_cyclegan_journey.sh: train cyclegan on 256 face pairs ->
# `cli test`'s both-leg grids (real_A | fake_B | real_B | fake_A) -> crop ->
# eval of each direction (fake_B against real_B, fake_A against real_A). No
# hand-written kernel lies on this path.
#
#   bash tools/run_e2e_cyclegan_journey_torch.sh > e2e_cyclegan.log 2>&1
#
# The run writes under $TMPDIR; the metric CSVs, their means, one stack, the
# train log, the card's nvidia-smi line and summary.json go to
# tools/artifacts/torch/cyclegan_e2e/.
set -x
cd "$(dirname "$0")/.." || exit 1
ROOT=${TMPDIR:-/tmp}/e2e_cyclegan_pairs_torch
RUN=${TMPDIR:-/tmp}/e2e_cyclegan_run_torch
ART=tools/artifacts/torch/cyclegan_e2e

python tools/make_e2e_dataset_torch.py --root $ROOT --scene face --n 256 --test 16 \
  --size 128 || exit 1

# 40 epochs x 16 steps an epoch = 640 steps at batch 16, 128²
timeout 3600 python -m tfcgan_tpu_torch.cli train --experiment cyclegan \
  --data-root $ROOT --batch-size 16 --image-size 128 --n-epochs 40 \
  --checkpoint-interval 39 --sample-interval 300 --out-dir $RUN || exit 1

CKPT=$(ls -d $RUN/step_* | sort | tail -1)
OUT=$RUN/eval_$(basename $CKPT)
timeout 1800 python -m tfcgan_tpu_torch.cli test --experiment cyclegan \
  --data-root $ROOT --image-size 128 --checkpoint $CKPT \
  --out-dir $OUT/stacks || exit 1
python -m tfcgan_tpu_torch.cli prep-crop --device cpu --stack-dir $OUT/stacks \
  --out-root $OUT --roles real_A,fake_B,real_B,fake_A || exit 1
timeout 1200 python -m tfcgan_tpu_torch.cli eval --device cpu --fake-dir $OUT/fake_B \
  --real-dir $OUT/real_B --out-csv $OUT/ab_metrics.csv \
  > $OUT/ab_metrics_mean.txt 2>&1 || exit 1
timeout 1200 python -m tfcgan_tpu_torch.cli eval --device cpu --fake-dir $OUT/fake_A \
  --real-dir $OUT/real_A --out-csv $OUT/ba_metrics.csv \
  > $OUT/ba_metrics_mean.txt 2>&1 || exit 1
cat $OUT/ab_metrics_mean.txt $OUT/ba_metrics_mean.txt

rm -rf $ART && mkdir -p $ART
cp $OUT/ab_metrics.csv $OUT/ab_metrics_mean.txt $OUT/ba_metrics.csv \
  $OUT/ba_metrics_mean.txt $ART/
cp $(ls $OUT/stacks/*.png | sort | head -1) $ART/stack_00000.png
cp $RUN/logs/cyclegan.jsonl $ART/train_log.jsonl
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $ART/card.txt 2>/dev/null
python tools/e2e_summary_torch.py --run $RUN --art $ART --experiment cyclegan \
  --what "cyclegan e2e CLI journey (tools/run_e2e_cyclegan_journey_torch.sh)" || exit 1
echo "E2E_CYCLEGAN_JOURNEY_DONE"
