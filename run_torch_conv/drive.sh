#!/bin/bash
# The port's convergence run on one card: run_r4/drive.sh's flags with the
# PyTorch trainer (--synthetic_online, 64 held-out clouds of seed 1234,
# schedule_scale 0.25, a checkpoint and an eval every 5 000 steps), cut at
# 10 000 steps; then the eval curve of its checkpoints, curve_report over its
# logs, and the converged JAX weights on the same 64 held-out clouds.
#
#     bash run_torch_conv/drive.sh [OUT]     # from the repository's root
#
# Writes OUT (default runs/conv): train.log, logs/metrics.jsonl,
# eval_curve.{txt,json}, curves.json, converged.{txt,json}, the card's name,
# power limit and samples of its clock and power draw. The checkpoints
# (46 MB each) are deleted at the end unless the run was cut, which keeps
# the newest for a resume: the trainer restores it when the same command
# runs again with OUT in place.
#
# This directory holds one such run's files (NVIDIA H100 80GB HBM3, 700 W),
# with OUT's logs/metrics.jsonl and bestrecord/best.json as metrics.jsonl
# and best.json.
set -u
O=${1:-runs/conv}
W=$O/modelvv_recon
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/smi.txt"
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a "$O/smi.txt"
(while sleep 120; do nvidia-smi --query-gpu=clocks.sm,power.draw,temperature.gpu --format=csv,noheader; done) > "$O/smi_samples.txt" 2>&1 &
SMI=$!
T0=$(date +%s)
timeout 2700 python3 -m rfnet_tpu_torch.train --synthetic_online --synthetic_val_size 64 \
  --schedule_scale 0.25 --steps 10000 --ckpt_every 5000 --workdir "$W" >> "$O/train.log" 2>&1
RC=$?
echo "train rc=$RC wall_s=$(($(date +%s) - T0))" | tee "$O/status.txt"
grep -E "eval @|trained" "$O/train.log"
python3 tools/eval_curve_torch.py "$W" 64 --json "$O/eval_curve.json" > "$O/eval_curve.txt"
echo "eval_curve rc=$?" | tee -a "$O/status.txt"
cat "$O/eval_curve.txt"
python3 tools/curve_report.py "$O/logs/metrics.jsonl" "$O/train.log" --json "$O/curves.json" \
  > "$O/curve_report.txt"
echo "curve_report rc=$?" | tee -a "$O/status.txt"
python3 tools/eval_curve_torch.py weights/rfnet_r4_105000.npz 64 --json "$O/converged.json" \
  > "$O/converged.txt"
echo "converged rc=$?" | tee -a "$O/status.txt"
cat "$O/converged.txt"
kill $SMI
if [ "$RC" -eq 0 ]; then rm -f "$W"/*.pt; else ls "$W"/*.pt | head -n -1 | xargs -r rm -f; fi
rm -f "$O/bestrecord/model.pt"
