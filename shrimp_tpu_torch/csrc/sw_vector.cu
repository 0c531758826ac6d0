// Pass-1 vector Smith-Waterman fused with its window gather (K1 + K2).
//
// Replaces shrimp_tpu/ops/sw_vector_pallas.py::sw_score_batch_pallas (the
// Pallas kernel body _make_kernel) together with the on-device window
// gathers of shrimp_tpu/pipeline/mapper.py::_p1_gather_score_ls and, in
// its colour-space form, ::_p1_gather_score_cs.
//
// Per (window, read) pair b it returns the local affine-gap SW best score
// as int32: H is floored at 0; the A-gap (consumes genome) and the B-gap
// (consumes read) have their own open/extend costs; codes match iff they
// are equal, so N matches N; pads never match (GENOME_PAD = -1,
// READ_PAD = -2); a READ_PAD row leaves H and B unchanged.  An optional
// row-0 plane row0[b, :] replaces the window for read row 0 (the
// colour-space contract of the Pallas kernel); null when absent.
// The colour-space gather (K2-CS) builds that row-0 plane itself: with a
// letter plane ls_plane and per-pair primer letters initbp, the warp also
// gathers the letter window at the same start and maps each letter l to
// (0 <= l <= 3) ? l ^ initbp[b] : (l == GENOME_PAD ? GENOME_PAD : BASE_N),
// so no [B, G] row-0 plane crosses to the device.
//
// What bounds it on an H100: integer ALU work and the latency of the
// row-to-row dependency chain, not HBM.  A pair reads about G bytes of
// genome and R bytes of read for G*R cells (one byte per R cells), and
// each cell costs some 25 integer and shuffle instructions.
//
// Design: one warp per pair, scanning read rows (R sequential steps).
// The warp first gathers its window straight from the genome plane that
// stays resident in device memory (int64 start lo[b]; columns >= wlen[b]
// masked to GENOME_PAD) into shared memory, so windows never make a round
// trip through HBM.  The H and B rows (2*G int32) live in shared memory.
// A row is processed in 32-column segments, lane l owning column
// 32*s + l, so a lane only ever touches its own shared-memory words:
// H[j-1] of the previous row comes from the neighbouring lane through
// __shfl_up_sync, with the segment boundary carried in a register.  The
// within-row A-gap
//     A[j] = max_{k<j}(H0[k] + ae*k) - aoe - ae*(j-1)
// is a tilted prefix max, computed as a 5-step warp shuffle scan per
// segment with a carried maximum; it takes the place of the Pallas
// kernel's pltpu.roll Hillis-Steele scan over the 128-lane axis.  Several
// warps per block and many blocks per SM keep enough independent pairs
// in flight to hide the shuffle latency.  The DPX max-of-three
// (__vimax3_s32) folds the H0 floor.  All values are int32 with
// NEG_INF = -(1 << 28): nothing overflows at these scores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr int GENOME_PAD = -1;
constexpr int READ_PAD = -2;
constexpr int BASE_N = 15;
constexpr unsigned FULL = 0xffffffffu;
// shared memory one block may use without opting in
constexpr size_t SMEM_BUDGET = 40 * 1024;

struct Params {
  int match, mismatch, aoe, ae, boe, be;
};

__global__ void sw_vector_kernel(
    const int8_t* __restrict__ plane, long long plane_len,
    const long long* __restrict__ lo, const int* __restrict__ wlen,
    const int* __restrict__ rid, const int* __restrict__ st,
    const int8_t* __restrict__ reads, int n_strands, int R,
    const int8_t* __restrict__ row0, const int8_t* __restrict__ ls_plane,
    const int8_t* __restrict__ initbp, int B, int G, int Gs, Params p,
    int* __restrict__ out) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + w;
  if (b >= B) return;  // the whole warp leaves together

  int* H = smem + (size_t)w * 2 * Gs;
  int* Bg = H + Gs;
  const int nwin = ls_plane ? 2 : 1;
  int8_t* win = reinterpret_cast<int8_t*>(smem + (size_t)warps * 2 * Gs) +
                (size_t)w * nwin * Gs;
  int8_t* win0 = win + Gs;  // the gathered row-0 plane (colour space)

  // gather the window: the same lane later reads column j, so no barrier
  // is needed between lanes, only the warp-wide one below
  const long long l0 = lo[b];
  const int wl = wlen[b];
  const int ib = ls_plane ? initbp[b] : 0;
  for (int j = lane; j < G; j += 32) {
    const long long g = l0 + j;
    const bool in = j < wl && g >= 0 && g < plane_len;
    win[j] = in ? plane[g] : (int8_t)GENOME_PAD;
    if (ls_plane) {
      const int l = in ? ls_plane[g] : GENOME_PAD;
      win0[j] = (int8_t)((l >= 0 && l <= 3) ? (l ^ ib)
                         : (l == GENOME_PAD ? GENOME_PAD : BASE_N));
    }
    H[j] = 0;
    Bg[j] = NEG_INF;
  }
  const int8_t* rrow = reads + ((long long)rid[b] * n_strands + st[b]) * R;
  const int8_t* g0 = ls_plane ? win0
                     : row0   ? row0 + (long long)b * G
                              : nullptr;
  __syncwarp();

  int best = 0;
  for (int i = 0; i < R; ++i) {
    const int rc = rrow[i];
    if (rc == READ_PAD) continue;  // a pad row changes neither H nor B
    const int8_t* gp = (i == 0 && g0) ? g0 : win;
    int carry_h = 0;          // previous-row H at column s0 - 1
    int carry_run = NEG_INF;  // max of H0[k] + ae*k over columns k < s0
    for (int s0 = 0; s0 < G; s0 += 32) {
      const int j = s0 + lane;
      const bool live = j < G;
      const int hp = live ? H[j] : 0;
      const int bp = live ? Bg[j] : NEG_INF;
      const int gc = live ? (int)gp[j] : GENOME_PAD;
      int hleft = __shfl_up_sync(FULL, hp, 1);
      if (lane == 0) hleft = carry_h;
      const int hdiag = hleft + (gc == rc ? p.match : p.mismatch);
      const int bn = max(hp - p.boe, bp - p.be);
      const int h0 = __vimax3_s32(hdiag, 0, bn);
      // tilted inclusive prefix max over the segment
      int incl = live ? h0 + p.ae * j : NEG_INF;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      excl = lane == 0 ? carry_run : max(excl, carry_run);
      const int a = excl - p.aoe - p.ae * (j - 1);
      const int hn = max(h0, a);
      if (live) {
        H[j] = hn;
        Bg[j] = bn;
        best = max(best, hn);
      }
      carry_h = __shfl_sync(FULL, hp, 31);
      carry_run = max(carry_run, __shfl_sync(FULL, incl, 31));
    }
  }
  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[b] = best;
}

}  // namespace

// One launch over B pairs.  Window b is plane[lo[b] : lo[b] + G] with
// columns >= wlen[b] (or outside the plane) read as GENOME_PAD; its read
// row is reads[rid[b], st[b], :] of a [*, n_strands, R] int8 array.
// row0 is null or an int8 [B, G] row-0 plane.  ls_plane is null or the
// letter plane (plane_len bytes) whose window, with the int8 [B] initbp,
// makes the colour-space row-0 plane; row0 is then ignored.  Scoring
// parameters are the reference's signed scores (gap costs negative).  Runs
// on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sw_vector_launch(
    const void* plane, long long plane_len, const void* lo, const void* wlen,
    const void* rid, const void* st, const void* reads, int n_strands, int R,
    const void* row0, const void* ls_plane, const void* initbp, int B, int G,
    int match, int mismatch, int a_gap_open, int a_gap_extend,
    int b_gap_open, int b_gap_extend, void* out, void* stream) {
  if (B <= 0) return 0;
  const int Gs = (G + 31) & ~31;
  const size_t per_warp =
      (size_t)Gs * (2 * sizeof(int) + (ls_plane ? 2 : 1));
  int warps = per_warp ? (int)(SMEM_BUDGET / per_warp) : 8;
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_vector_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p;
  p.match = match;
  p.mismatch = mismatch;
  p.aoe = -(a_gap_open + a_gap_extend);
  p.ae = -a_gap_extend;
  p.boe = -(b_gap_open + b_gap_extend);
  p.be = -b_gap_extend;
  const int grid = (B + warps - 1) / warps;
  sw_vector_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)plane, plane_len, (const long long*)lo,
      (const int*)wlen, (const int*)rid, (const int*)st,
      (const int8_t*)reads, n_strands, R, (const int8_t*)row0,
      (const int8_t*)ls_plane, (const int8_t*)initbp, B, G, Gs, p, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
