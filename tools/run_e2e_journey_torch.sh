#!/bin/bash
# The fft_glo end-to-end CLI journey on the card, port of
# tools/run_e2e_journey.sh: train from a 512-pair on-disk A|B set (the device
# pool), a checkpoint every 25 epochs, then at each checkpoint test stacks ->
# crop -> metric CSVs, and the gallery of the training samples. The scene is
# tools/make_e2e_dataset_torch.py's learnable blocks mapping.
#
#   bash tools/run_e2e_journey_torch.sh > e2e_journey.log 2>&1
#
# The run writes under $TMPDIR (checkpoints are 423 MiB each); the metric
# CSVs, their means, one stack, the train log, the card's nvidia-smi line and
# summary.json go to tools/artifacts/torch/fft_glo_e2e/.
set -x
cd "$(dirname "$0")/.." || exit 1
ROOT=${TMPDIR:-/tmp}/e2e_pairs_torch
RUN=${TMPDIR:-/tmp}/e2e_run_torch
ART=tools/artifacts/torch/fft_glo_e2e

python tools/make_e2e_dataset_torch.py --root $ROOT --n 512 --test 32 || exit 1

# 125 epochs x 16 steps an epoch = 2000 steps, checkpoints every 25 epochs
timeout 5400 python -m tfcgan_tpu_torch.cli train --experiment fft_glo \
  --data-root $ROOT --batch-size 32 --n-epochs 125 \
  --checkpoint-interval 25 --sample-interval 400 --out-dir $RUN || exit 1

rm -rf $ART && mkdir -p $ART
for CKPT in $(ls -d $RUN/step_* | sort); do
  STEP=$(basename $CKPT)
  OUT=$RUN/eval_$STEP
  timeout 1500 python -m tfcgan_tpu_torch.cli test --experiment fft_glo \
    --data-root $ROOT --checkpoint $CKPT --out-dir $OUT/stacks || exit 1
  python -m tfcgan_tpu_torch.cli prep-crop --device cpu --stack-dir $OUT/stacks \
    --out-root $OUT --roles real_A,fake_B,real_B || exit 1
  timeout 1200 python -m tfcgan_tpu_torch.cli eval --device cpu --fake-dir $OUT/fake_B \
    --real-dir $OUT/real_B --out-csv $OUT/metrics.csv | tee $OUT/metrics_mean.txt || exit 1
  cp $OUT/metrics.csv $ART/metrics_$STEP.csv
  cp $OUT/metrics_mean.txt $ART/metrics_mean_$STEP.txt
done
python -m tfcgan_tpu_torch.cli gallery --device cpu --dir $RUN/samples --title "fft_glo e2e"
cp $(ls $OUT/stacks/*.png | sort | head -1) $ART/stack_00000.png
cp $RUN/logs/fft_glo.jsonl $ART/train_log.jsonl
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $ART/card.txt 2>/dev/null
python tools/e2e_summary_torch.py --run $RUN --art $ART --experiment fft_glo \
  --what "fft_glo e2e CLI journey (tools/run_e2e_journey_torch.sh)" || exit 1
echo "E2E_JOURNEY_DONE"
