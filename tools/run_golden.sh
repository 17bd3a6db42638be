#!/usr/bin/env bash
# Golden end-to-end harness mirroring the reference's run_tests.sh contract
# (reference serial/run_tests.sh): run the CLI on each vector, compare
# particle-0 coordinates at ±0.001 and the collision count exactly.
#
# Usage: tools/run_golden.sh [fast|slow|all|mesh-sweep|slow-mesh] \
#            [--engine parity|fast] [--mesh N]
#
# slow-mesh runs two HEAVY vectors end-to-end through sharded meshes in
# f64 parity mode (--mesh 2 and the 2x2 rectangle) — the analog of the
# reference MPI harness running its full vector table under mpirun
# (reference mpi/run_tests.sh:41-53,76). Budget hours on a 1-core host.
#
# mesh-sweep mirrors the reference MPI harness's configurable process
# counts (reference mpi/run_tests.sh:8-16 wraps every vector in
# mpirun -np N): every fast vector runs at --mesh 2 and --mesh ncside
# (the row decomposition admits any n_shards <= ncside). The parity CLI
# self-provisions its virtual CPU device mesh, so this works on any
# machine — the analog of "mpirun on localhost".
set -u
cd "$(dirname "$0")/.."

SUBSET="${1:-fast}"; shift || true
EXTRA_ARGS=("$@")

FAST_VECTORS=(
  "1 2 3 10 1:1.570 0.056:0"
  "1 1 5 100 1:0.786 0.027:0"
  "-10 3 3 100 10:1.733 1.643:2"
  "5893 0.05 3 10 10:0.002 0.035:2"
  "8555 0.05 3 10 10:0.016 0.049:1"
)
SLOW_VECTORS=(
  "-50 10000 200 500000 10:5025.384 5303.928:4"
  "1 5000 100 1000000 4:3936.506 131.472:4"
  "1 5000 100 1000000 100:3899.787 156.291:163"
  "1 5000 20 1000000 10:3918.912 143.364:19"
  "1 1000 3 10000 10000:287.788 261.446:31"
  "3 5000 50 1000000 300:3819.032 25.659:469"
  "3 5000 50 1000000 500:3738.436 58.743:804"
  "-1 1000 30 100000 1000:575.878 370.663:1203"
  "12 100 5 10000 10000:76.732 61.943:2209"
  "-11 3500 20 500000 10:1984.878 1625.992:35"
)

# Heavy vectors for the slow-mesh tier: enough steps
# that mesh-decomposition errors would compound past the 0.001 gate.
SLOW_MESH_VECTORS=(
  "-1 1000 30 100000 1000:575.878 370.663:1203"
  "12 100 5 10000 10000:76.732 61.943:2209"
)

MESH_SWEEP=0
case "$SUBSET" in
  fast) VECTORS=("${FAST_VECTORS[@]}");;
  slow) VECTORS=("${SLOW_VECTORS[@]}");;
  all)  VECTORS=("${FAST_VECTORS[@]}" "${SLOW_VECTORS[@]}");;
  mesh-sweep) VECTORS=("${FAST_VECTORS[@]}"); MESH_SWEEP=1;;
  slow-mesh) VECTORS=("${SLOW_MESH_VECTORS[@]}"); MESH_SWEEP=2;;
  *) echo "unknown subset: $SUBSET" >&2; exit 2;;
esac

RUNS=()
if [ "$MESH_SWEEP" = "2" ]; then
  for vec in "${VECTORS[@]}"; do
    RUNS+=("$vec:--mesh 2")
    RUNS+=("$vec:--mesh 2x2")
  done
elif [ "$MESH_SWEEP" = "1" ]; then
  for vec in "${VECTORS[@]}"; do
    IFS=':' read -r args _ _ <<<"$vec"
    read -r _ _ nc _ _ <<<"$args"
    for mesh in 2 "$nc"; do
      [ "$mesh" -le "$nc" ] && RUNS+=("$vec:--mesh $mesh")
    done
    # 2D rectangular decomposition (parallel/sharded2d.py): both axes
    # split, the analog of running the reference harness with a 2D
    # process grid (which its 1D-only MPI code cannot do).
    [ "$nc" -ge 2 ] && RUNS+=("$vec:--mesh 2x2")
  done
else
  for vec in "${VECTORS[@]}"; do RUNS+=("$vec:"); done
fi

pass=0; fail=0
for run in "${RUNS[@]}"; do
  IFS=':' read -r args exp_xy exp_cols mesh_args <<<"$run"
  start=$(date +%s)
  out=$(python -m particlesimulation_tpu $args $mesh_args \
        "${EXTRA_ARGS[@]+"${EXTRA_ARGS[@]}"}" 2>/dev/null)
  rc=$?
  took=$(( $(date +%s) - start ))
  got_xy=$(echo "$out" | sed -n 1p)
  got_cols=$(echo "$out" | sed -n 2p)
  read -r ex ey <<<"$exp_xy"
  read -r gx gy <<<"$got_xy"
  ok=1
  [ $rc -ne 0 ] && ok=0
  if [ $ok -eq 1 ]; then
    dx=$(python -c "print(1 if abs($gx-($ex))<=0.001 else 0)")
    dy=$(python -c "print(1 if abs($gy-($ey))<=0.001 else 0)")
    [ "$dx" = "1" ] && [ "$dy" = "1" ] && [ "$got_cols" = "$exp_cols" ] || ok=0
  fi
  if [ $ok -eq 1 ]; then
    pass=$((pass+1)); echo "PASS  [$args $mesh_args] -> $got_xy / $got_cols (${took}s)"
  else
    fail=$((fail+1)); echo "FAIL  [$args $mesh_args] got '$got_xy / $got_cols' want '$exp_xy / $exp_cols' (${took}s)"
  fi
done
echo "----"
echo "$pass passed, $fail failed"
[ $fail -eq 0 ]
