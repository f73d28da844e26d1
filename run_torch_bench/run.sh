# The port's measurement entry points on one CUDA card, their outputs into
# one directory (default chiprun_out/bench): bench_torch.py's JSON line
# (bench_h100.json, its progress in bench.err), the validation sweep
# (verify.txt and ONCHIP_VALIDATION_H100.json), and both profilers on the
# random init and on the converged weights (fwd*.txt, step*.txt), with the
# card's name, power limit and clocks (smi.txt).
#   bash run_torch_bench/run.sh [OUT_DIR]
set -u
O=${1:-chiprun_out/bench}
mkdir -p $O
nvidia-smi --query-gpu=name,power.limit,clocks.sm,clocks.max.sm --format=csv,noheader | tee $O/smi.txt
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python3 bench_torch.py > $O/bench_h100.json 2> $O/bench.err; echo "bench rc=$? $(( $(date +%s) - t0 )) s"
t0=$(date +%s)
python3 tools/verify_onchip_torch.py --out $O/ONCHIP_VALIDATION_H100.json > $O/verify.txt 2>&1; echo "verify rc=$? $(( $(date +%s) - t0 )) s"
for a in "" "--trained"; do
  t0=$(date +%s)
  python3 tools/profile_forward_torch.py $a > $O/fwd$a.txt 2>&1; echo "fwd$a rc=$? $(( $(date +%s) - t0 )) s"
  t0=$(date +%s)
  python3 tools/profile_trainstep_torch.py $a > $O/step$a.txt 2>&1; echo "step$a rc=$? $(( $(date +%s) - t0 )) s"
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm,power.draw --format=csv,noheader
tail -n 30 $O/bench.err $O/verify.txt $O/fwd*.txt $O/step*.txt
