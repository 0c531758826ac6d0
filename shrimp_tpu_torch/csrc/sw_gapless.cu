// Gapless pass 1: the ungapped max-subarray score along one diagonal (K6).
//
// Replaces shrimp_tpu/ops/sw_gapless.py::_gapless_core (via
// gapless_score_batch), the -U / -M mirna pass-1 engine, which replicates
// common/sw-gapless.c:sw_gapless.  Per hit n: column t scores match or
// mismatch where diag[n, t] != GENOME_PAD and reads[n, t] != READ_PAD, else
// 0; column 0 takes s0[n] instead (the colour-space forced first colour),
// or is scored like the others when s0 is null.  The result is the best
// sum of a run of consecutive columns, floored at 0:
//     max(0, max_i (prefix_i - min(0, min_{j<i} prefix_j)))
// which is the integer result of Kadane's running scan.
//
// What bounds it on an H100: nothing much.  A hit reads 2R bytes and does
// a few integer operations per column; the diagonals themselves are
// gathered on the host, as in the JAX package.
//
// Design: one warp per hit.  Lane l owns column 32*s + l of each 32-column
// segment, so loads are coalesced.  The prefix sum and the exclusive
// running minimum of the prefix are 5-step warp shuffle scans per segment,
// with the running sum and minimum carried between segments in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GENOME_PAD = -1;
constexpr int READ_PAD = -2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;

__global__ void sw_gapless_kernel(const int8_t* __restrict__ diag,
                                  const int8_t* __restrict__ reads,
                                  const int* __restrict__ s0, int N, int R,
                                  int match, int mismatch,
                                  int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const int8_t* g = diag + (long long)n * R;
  const int8_t* r = reads + (long long)n * R;

  int carry_sum = 0;  // prefix over columns < t0
  int carry_min = 0;  // min(0, min of prefix over columns < t0)
  int best = 0;
  for (int t0 = 0; t0 < R; t0 += 32) {
    const int t = t0 + lane;
    int s = 0;
    if (t < R) {
      const int gc = g[t], rc = r[t];
      if (gc != GENOME_PAD && rc != READ_PAD) s = gc == rc ? match : mismatch;
      if (t == 0 && s0) s = s0[n];
    }
    int pre = s;  // inclusive prefix sum over the segment
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, pre, off);
      if (lane >= off) pre += v;
    }
    pre += carry_sum;
    // exclusive running minimum: prefix over columns < t, and 0
    int mn = pre;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, mn, off);
      if (lane >= off) mn = min(mn, v);
    }
    int excl = __shfl_up_sync(FULL, mn, 1);
    excl = lane == 0 ? carry_min : min(excl, carry_min);
    if (t < R) best = max(best, pre - excl);
    carry_sum = __shfl_sync(FULL, pre, 31);
    carry_min = min(carry_min, __shfl_sync(FULL, mn, 31));
  }
  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[n] = best;
}

}  // namespace

// One launch over N hits: diag and reads int8 [N, R], s0 null or int32
// [N], out int32 [N].  Runs on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int sw_gapless_launch(const void* diag, const void* reads,
                                 const void* s0, int N, int R, int match,
                                 int mismatch, void* out, void* stream) {
  if (N <= 0) return 0;
  const int grid = (N + WARPS - 1) / WARPS;
  sw_gapless_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)diag, (const int8_t*)reads, (const int*)s0, N, R, match,
      mismatch, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
