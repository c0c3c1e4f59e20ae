#!/bin/bash
# The artifact-evaluation run of the port on the card (the counterpart of the
# repository's 0_run_ae.sh for the JAX package).  Each stage runs in its own
# directory under OUT_DIR (default results_h100), with its log beside its CSVs:
#   card.txt                         nvidia-smi name and power limit
#   gcn_gather/  gcn_sparse/         sweep --model gcn, one incumbent each:
#                                    1_bench_gcn.csv, Fig_6a_torch_gcn.csv
#   agnn_gather/                     sweep --model agnn (4 layers, hidden 32)
#   single_kernel/                   sweep --single_kernel: 2_tcgnn_single_kernel.csv
#   ledger/                          epoch_ledger (DD, amazon0601): epoch_ledger.csv
#   tc_blocks/                       tc_block_count: 3_cnt_TC_blk_*.csv
#   roofline/                        roofline_bound over the sweep's CSVs: roofline.csv
# GRAPH arguments restrict the sweeps, the tile counts and the floor to those
# graphs (default: all 14 of AE_TABLE).  Every stage runs even if an earlier
# one failed; the exit status is nonzero if any stage failed.
#
# Run from anywhere:  tcgnn_tpu_torch/bench/run_ae.sh [OUT_DIR [GRAPH ...]]
set -u
repo="$(cd "$(dirname "$0")/../.." && pwd)"
out="$(realpath -m "${1:-results_h100}")"
shift || true
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"
ds=()
if [ $# -gt 0 ]; then ds=(--datasets "$@"); fi
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
rc=0

run() {
    local dir=$1 start=$SECONDS
    shift
    mkdir -p "$out/$dir"
    (cd "$out/$dir" && python -m "$@" > run.log 2>&1) || { rc=1; echo "FAILED: $dir"; }
    echo "$dir: $((SECONDS - start)) s"
    tail -n 20 "$out/$dir/run.log"
}

run gcn_gather tcgnn_tpu_torch.bench.sweep --model gcn --baseline_impl gather "${ds[@]}"
run gcn_sparse tcgnn_tpu_torch.bench.sweep --model gcn --baseline_impl sparse "${ds[@]}"
run agnn_gather tcgnn_tpu_torch.bench.sweep --model agnn --baseline_impl gather "${ds[@]}"
run single_kernel tcgnn_tpu_torch.bench.sweep --single_kernel "${ds[@]}"
run ledger tcgnn_tpu_torch.bench.epoch_ledger
run tc_blocks tcgnn_tpu_torch.bench.tc_block_count --out_prefix 3_cnt_TC_blk "${ds[@]}"
run roofline tcgnn_tpu_torch.bench.roofline_bound \
    --single_kernel_csv "$out/single_kernel/2_tcgnn_single_kernel.csv" \
    --gcn_csv "$out/gcn_gather/1_bench_gcn.csv" --out "$out/roofline/roofline.csv" "${ds[@]}"
exit $rc
