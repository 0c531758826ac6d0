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
// What bounds it on an H100: integer ALU work per DP cell, not HBM.  A
// pair reads about G bytes of genome and R bytes of read for G*R cells.
//
// Design: one thread per pair (inter-task parallelism), so the cell loop
// has no shuffles and no scan.  A warp first gathers its 32 windows from
// the genome plane that stays resident in device memory (int64 start
// lo[b]; columns >= wlen[b] masked to GENOME_PAD) into shared memory, the
// lanes on neighbouring bytes, and its 32 reads the same way, each read
// compacted to its non-pad rows: a READ_PAD row leaves the state as it
// was, so dropping it is exact (row 0 keeps the row-0 plane only when the
// read's row 0 is not a pad).  Each thread then sweeps its pair in strips
// of T = 16 columns held in registers (the window codes, H and B of the
// previous row), the read rows in the inner loop:
//     H0 = max(H[i-1][j-1] + s, 0, B),  B = max(H[i-1][j] - boe, B - be)
//     H  = max(H0, A),                  A' = max(H0 - aoe, A - ae)
// The A-gap (consumes genome) runs along the strip in a register, carried
// from H0 as the port's recurrence has it (exact for any parameters); the
// B-gap (consumes read) stays per column.  Between strips each row keeps
// its last H and its A-gap in a boundary slot: shared memory, or for
// reads too long for it a global scratch.  The max forms are Hopper's DPX
// instructions (__vimax3_s32, __viaddmax_s32).  Columns past the window
// (wlen, or the plane's end) are pads that can only lower a score when
// mismatches and gaps cost (mismatch <= 0, every gap cost >= 0) and no
// read code equals GENOME_PAD: then the sweep stops at the window's
// length, otherwise it runs the full G, the last strip masked.  All
// values are int32 with NEG_INF = -(1 << 28).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr int GENOME_PAD = -1;
constexpr int READ_PAD = -2;
constexpr int BASE_N = 15;
constexpr unsigned FULL = 0xffffffffu;
constexpr int T = 16;  // columns per strip
// shared memory of one warp above which the row boundaries go to global
// scratch; and the blocks of the global tier (a grid-stride loop)
constexpr size_t SMEM_WARP_MAX = 64 * 1024;
constexpr int GLOBAL_WARPS = 1024;

struct Params {
  int match, mismatch, aoe, ae, boe, be;
};

// Per-warp layout sizes, shared by the launch and the kernel.
struct Layout {
  int Gs;           // window stride in bytes (16-byte aligned, odd 16s)
  int nwin;         // 1, or 2 with a row-0 plane
  bool bound_smem;  // row boundaries in shared memory
  size_t per_warp;  // shared bytes of one warp
};

__host__ __device__ inline Layout make_layout(int G, int R, bool row0) {
  Layout L;
  int g16 = (G + 15) & ~15;
  if (((g16 >> 4) & 1) == 0) g16 += 16;  // conflict-free 16-byte loads
  L.Gs = g16;
  L.nwin = row0 ? 2 : 1;
  const size_t base = (size_t)32 * g16 * L.nwin + (size_t)32 * ((R + 3) & ~3);
  const size_t bound = (size_t)R * 32 * sizeof(int2);
  L.bound_smem = base + bound <= SMEM_WARP_MAX;
  L.per_warp = base + (L.bound_smem ? bound : 0);
  return L;
}

__device__ __forceinline__ void load_codes(const int8_t* p, int (&g)[T]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      g[4 * q + k] = (int)(int8_t)((unsigned)w[q] >> (8 * k));
}

// One read row over one strip of up to W columns (W <= T).  diag is
// H[i-1][j0-1], e the A-gap into column j0; H/Bv hold row i-1 and come
// back holding row i.  With MASK, columns j0 + t >= n_live do not count
// towards the best score.
template <int W, bool MASK>
__device__ __forceinline__ void strip_row(const int (&g)[T], int rc, int diag,
                                          int& e, int (&H)[T], int (&Bv)[T],
                                          int& best, const Params& p,
                                          int n_live) {
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const int hd = diag + (g[t] == rc ? p.match : p.mismatch);
    diag = H[t];
    const int bn = __viaddmax_s32(H[t], -p.boe, Bv[t] - p.be);
    const int h0 = __vimax3_s32(hd, 0, bn);
    const int h = max(h0, e);
    e = __viaddmax_s32(h0, -p.aoe, e - p.ae);
    H[t] = h;
    Bv[t] = bn;
    best = (MASK && t >= n_live) ? best : max(best, h);
  }
}

// One strip of W columns starting at j0 over all n rows of the pair.
// Row i's boundary is bound[32 * i] (a warp's lanes side by side).
template <int W, bool MASK>
__device__ __forceinline__ void strip(const int8_t* win, const int8_t* win0,
                                      const int8_t* rd, int2* bound, int n,
                                      int j0, int n_live, const Params& p,
                                      int& best) {
  int g[T];
  load_codes(win + j0, g);
  int H[T], Bv[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    H[t] = 0;
    Bv[t] = NEG_INF;
  }
  const bool first = j0 == 0;
  int prev_left = 0;  // H[i-1][j0-1]
  int i = 0;
  if (win0 && n > 0) {  // the read's row 0 against the row-0 plane
    int g0[T];
    load_codes(win0 + j0, g0);
    const int2 bd = first ? make_int2(0, NEG_INF) : bound[0];
    int e = bd.y;
    strip_row<W, MASK>(g0, rd[0], prev_left, e, H, Bv, best, p, n_live);
    bound[0] = make_int2(H[W - 1], e);
    prev_left = bd.x;
    i = 1;
  }
  for (; i < n; ++i) {
    const int2 bd = first ? make_int2(0, NEG_INF) : bound[i * 32];
    int e = bd.y;
    strip_row<W, MASK>(g, rd[i * 32], prev_left, e, H, Bv, best, p, n_live);
    bound[i * 32] = make_int2(H[W - 1], e);
    prev_left = bd.x;
  }
}

__global__ void sw_vector_kernel(
    const int8_t* __restrict__ plane, long long plane_len,
    const long long* __restrict__ lo, const int* __restrict__ wlen,
    const int* __restrict__ rid, const int* __restrict__ st,
    const int8_t* __restrict__ reads, int n_strands, int R,
    const int8_t* __restrict__ row0, const int8_t* __restrict__ ls_plane,
    const int8_t* __restrict__ initbp, int B, int G, Params p, int trunc,
    int2* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ __align__(16) int8_t smem[];
  const Layout L = make_layout(G, R, row0 || ls_plane);
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int8_t* wbase = smem + (size_t)w * L.per_warp;
  int8_t* win_all = wbase;                                 // [32][Gs]
  int8_t* win0_all = L.nwin == 2 ? wbase + 32 * L.Gs : nullptr;
  int8_t* rd_all = wbase + 32 * L.Gs * L.nwin;             // [R][32]
  int2* bsm = reinterpret_cast<int2*>(rd_all + 32 * ((R + 3) & ~3));

  const long long n_groups = ((long long)B + 31) >> 5;
  for (long long grp = (long long)blockIdx.x * warps + w; grp < n_groups;
       grp += (long long)gridDim.x * warps) {
    const long long b0 = grp << 5;
    int my_n = 0, my_cols = 0;
    bool my_row0 = false;
    // gather the 32 windows and compact the 32 reads, lanes across bytes
    for (int q = 0; q < 32; ++q) {
      const long long b = b0 + q;
      if (b >= B) break;
      const long long l0 = lo[b];
      const int wl = wlen[b];
      const int ib = ls_plane ? initbp[b] : 0;
      int8_t* win = win_all + q * L.Gs;
      int8_t* win0 = win0_all ? win0_all + q * L.Gs : nullptr;
      for (int j = lane; j < L.Gs; j += 32) {
        const long long gpos = l0 + j;
        const bool in = j < G && j < wl && gpos >= 0 && gpos < plane_len;
        win[j] = in ? plane[gpos] : (int8_t)GENOME_PAD;
        if (ls_plane) {
          const int l = in ? ls_plane[gpos] : GENOME_PAD;
          win0[j] = (int8_t)((l >= 0 && l <= 3) ? (l ^ ib)
                             : (l == GENOME_PAD ? GENOME_PAD : BASE_N));
        } else if (win0) {
          win0[j] = j < G ? row0[b * G + j] : (int8_t)GENOME_PAD;
        }
      }
      const int8_t* rrow = reads + ((long long)rid[b] * n_strands + st[b]) * R;
      int cnt = 0;
      bool neg1 = false;
      for (int k0 = 0; k0 < R; k0 += 32) {
        const int c = k0 + lane < R ? rrow[k0 + lane] : READ_PAD;
        const bool keep = c != READ_PAD;
        const unsigned m = __ballot_sync(FULL, keep);
        neg1 |= __any_sync(FULL, c == GENOME_PAD) != 0;
        if (keep)
          rd_all[(cnt + __popc(m & ((1u << lane) - 1))) * 32 + q] = (int8_t)c;
        cnt += __popc(m);
      }
      if (lane == q) {
        my_n = cnt;
        my_row0 = R > 0 && rrow[0] != READ_PAD;
        // past the window every column is a pad: stop there when pads can
        // only lower a score (see the head of this file)
        long long nc = G;
        if (trunc && !neg1 && l0 >= 0) {
          nc = min((long long)min(wl, G), plane_len - l0);
          nc = nc < 0 ? 0 : nc;
        }
        my_cols = (int)nc;
      }
    }
    __syncwarp();

    const long long b = b0 + lane;
    if (b < B) {
      int2* bound = L.bound_smem
          ? bsm + lane
          : scratch + ((long long)blockIdx.x * warps + w) * R * 32 + lane;
      const int8_t* win = win_all + lane * L.Gs;
      const int8_t* win0 = (win0_all && my_row0) ? win0_all + lane * L.Gs
                                                 : nullptr;
      const int8_t* rd = rd_all + lane;
      int best = 0;
      const int n = my_n, nc = my_cols;
      int j0 = 0;
      for (; j0 + T <= nc; j0 += T)
        strip<T, false>(win, win0, rd, bound, n, j0, T, p, best);
      const int rem = nc - j0;
      if (rem > 8)
        strip<T, true>(win, win0, rd, bound, n, j0, rem, p, best);
      else if (rem > 0)
        strip<8, true>(win, win0, rd, bound, n, j0, rem, p, best);
      out[b] = best;
    }
    __syncwarp();
  }
}

}  // namespace

// Bytes of global scratch sw_vector_launch needs for B pairs (0 when the
// row boundaries fit in shared memory).
extern "C" long long sw_vector_scratch_bytes(int B, int G, int R,
                                             int with_row0) {
  const Layout L = make_layout(G, R, with_row0 != 0);
  if (L.bound_smem || B <= 0) return 0;
  const long long warps_needed = ((long long)B + 31) / 32;
  const long long warps =
      warps_needed < GLOBAL_WARPS ? warps_needed : GLOBAL_WARPS;
  return warps * R * 32 * (long long)sizeof(int2);
}

// One launch over B pairs.  Window b is plane[lo[b] : lo[b] + G] with
// columns >= wlen[b] (or outside the plane) read as GENOME_PAD; its read
// row is reads[rid[b], st[b], :] of a [*, n_strands, R] int8 array.
// row0 is null or an int8 [B, G] row-0 plane.  ls_plane is null or the
// letter plane (plane_len bytes) whose window, with the int8 [B] initbp,
// makes the colour-space row-0 plane; row0 is then ignored.  scratch holds
// sw_vector_scratch_bytes bytes (null when that is 0).  Scoring parameters
// are the reference's signed scores (gap costs negative).  Runs on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sw_vector_launch(
    const void* plane, long long plane_len, const void* lo, const void* wlen,
    const void* rid, const void* st, const void* reads, int n_strands, int R,
    const void* row0, const void* ls_plane, const void* initbp, int B, int G,
    int match, int mismatch, int a_gap_open, int a_gap_extend,
    int b_gap_open, int b_gap_extend, void* scratch, void* out,
    void* stream) {
  if (B <= 0) return 0;
  if (G <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)B * sizeof(int),
                                          (cudaStream_t)stream);
  const bool with_row0 = row0 != nullptr || ls_plane != nullptr;
  const Layout L = make_layout(G, R, with_row0);
  Params p;
  p.match = match;
  p.mismatch = mismatch;
  p.aoe = -(a_gap_open + a_gap_extend);
  p.ae = -a_gap_extend;
  p.boe = -(b_gap_open + b_gap_extend);
  p.be = -b_gap_extend;
  const int trunc = p.mismatch <= 0 && p.aoe >= 0 && p.ae >= 0 &&
                    p.boe >= 0 && p.be >= 0;
  const long long groups = ((long long)B + 31) / 32;
  int warps = 1, grid;
  if (L.bound_smem) {
    warps = L.per_warp * 2 <= 96 * 1024 ? 2 : 1;
    grid = (int)((groups + warps - 1) / warps);
  } else {
    if (!scratch) return (int)cudaErrorInvalidValue;
    grid = (int)(groups < GLOBAL_WARPS ? groups : GLOBAL_WARPS);
  }
  const size_t smem = L.per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_vector_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_vector_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)plane, plane_len, (const long long*)lo,
      (const int*)wlen, (const int*)rid, (const int*)st,
      (const int8_t*)reads, n_strands, R, (const int8_t*)row0,
      (const int8_t*)ls_plane, (const int8_t*)initbp, B, G, p, trunc,
      (int2*)scratch, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
