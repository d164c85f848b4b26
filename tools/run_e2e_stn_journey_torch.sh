#!/bin/bash
# The STN registration end-to-end CLI journey on the card, port of
# tools/run_e2e_stn_journey.sh: train stn_newmodel3 on 512 face pairs whose B
# is misaligned (rotation +-4 degrees, translation +-6 px) -> 6-image test
# stacks -> crop (real_A, real_B, reg_B and the fakes) -> eval-reg twice:
#  1. the reference protocol, cross-modality: real_A against real_B / reg_B
#     (with the inverted thermal mapping a perfect registration drives NCC
#     more negative: read the direction, not the magnitude);
#  2. the synthetic ground truth, one modality: test_aligned_B (B before the
#     warp) against real_B / reg_B.
# The difference plots and their gallery need matplotlib and are skipped
# without it.
#
#   bash tools/run_e2e_stn_journey_torch.sh > e2e_stn.log 2>&1
#
# The run writes under $TMPDIR; the metric CSVs, their means, one stack, the
# train log, the card's nvidia-smi line and summary.json go to
# tools/artifacts/torch/stn_journey/.
set -x
cd "$(dirname "$0")/.." || exit 1
ROOT=${TMPDIR:-/tmp}/e2e_stn_pairs_face_torch
RUN=${TMPDIR:-/tmp}/e2e_stn_run_face_torch
ART=tools/artifacts/torch/stn_journey

python tools/make_e2e_dataset_torch.py --root $ROOT --n 512 --test 32 --warp-b \
  --scene face || exit 1

# 100 epochs x 16 steps an epoch = 1600 steps
timeout 5400 python -m tfcgan_tpu_torch.cli train --experiment stn_newmodel3 \
  --data-root $ROOT --batch-size 32 --n-epochs 100 \
  --checkpoint-interval 99 --sample-interval 400 --out-dir $RUN || exit 1

CKPT=$(ls -d $RUN/step_* | sort | tail -1)
OUT=$RUN/eval_$(basename $CKPT)
timeout 1800 python -m tfcgan_tpu_torch.cli test --experiment stn_newmodel3 \
  --data-root $ROOT --checkpoint $CKPT --out-dir $OUT/stacks || exit 1
python -m tfcgan_tpu_torch.cli prep-crop --device cpu --stack-dir $OUT/stacks --out-root $OUT \
  --roles real_A,real_B,reg_B,fake_A1,fake_A2,fake_B || exit 1
PLOTS=""
python -c "import matplotlib" 2>/dev/null && PLOTS="--plots-dir $OUT/diff_plots"
# pass 1: the reference protocol (cross-modality)
timeout 1200 python -m tfcgan_tpu_torch.cli eval-reg --device cpu --real-a-dir $OUT/real_A \
  --real-b-dir $OUT/real_B --reg-b-dir $OUT/reg_B --out-csv $OUT/reg_metrics.csv $PLOTS \
  > $OUT/reg_metrics_mean.txt 2>&1 || exit 1
cat $OUT/reg_metrics_mean.txt
# pass 2: the synthetic ground truth (one modality, as the anchor run)
timeout 1200 python -m tfcgan_tpu_torch.cli eval-reg --device cpu \
  --real-a-dir $ROOT/test_aligned_B --real-b-dir $OUT/real_B --reg-b-dir $OUT/reg_B \
  --out-csv $OUT/reg_metrics_gt.csv > $OUT/reg_metrics_gt_mean.txt 2>&1 || exit 1
cat $OUT/reg_metrics_gt_mean.txt
if [ -n "$PLOTS" ]; then
  python -m tfcgan_tpu_torch.cli gallery --device cpu --dir $OUT/diff_plots \
    --title "stn e2e diff plots"
fi

rm -rf $ART && mkdir -p $ART
cp $OUT/reg_metrics.csv $OUT/reg_metrics_mean.txt $OUT/reg_metrics_gt.csv \
  $OUT/reg_metrics_gt_mean.txt $ART/
cp $(ls $OUT/stacks/*.png | sort | head -1) $ART/stack_00000.png
cp $RUN/logs/stn_newmodel3.jsonl $ART/train_log.jsonl
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $ART/card.txt 2>/dev/null
python tools/e2e_summary_torch.py --run $RUN --art $ART --experiment stn_newmodel3 \
  --what "stn_newmodel3 e2e CLI journey (tools/run_e2e_stn_journey_torch.sh)" || exit 1
echo "E2E_STN_JOURNEY_DONE"
