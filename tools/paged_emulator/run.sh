#!/bin/sh
# Emulate the paged attention kernels (K1, K1q, K2, K2q) on the CPU: no card
# and no nvcc needed, only g++ (C++20) and threads.
#
#     tools/paged_emulator/run.sh            # copies land at their wait
#     tools/paged_emulator/run.sh --eager    # copies land when issued
#
# Compiles ops/csrc/paged_attention.cu (launch syntax stripped) against the
# stand-in headers in mock/ into build/paged_emulator/ and runs harness.cpp,
# which prints one line per launch plan and exits non-zero if K2's rows
# differ from K1 at lengths + j or from the float64 reference.  A check of
# logic and rounding order, not of the card's compiler: expf is the host's.
set -e
here=$(cd "$(dirname "$0")" && pwd)
root=$(cd "$here/../.." && pwd)
out="$root/build/paged_emulator"
mkdir -p "$out"
flags=""
[ "$1" = "--eager" ] && flags="-DEAGER"
sed -E 's/<<<[^>]*>>>//' "$root/kubegpu_tpu_torch/ops/csrc/paged_attention.cu" \
    > "$out/paged_attention.cpp"
g++ -std=c++20 -O1 -ffp-contract=off -pthread -Wno-unknown-pragmas $flags \
    -I"$here/mock" -I"$out" "$here/harness.cpp" -o "$out/emulate"
"$out/emulate"
