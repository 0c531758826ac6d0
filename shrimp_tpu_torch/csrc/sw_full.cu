// Pass-2 band-packed 3-state Smith-Waterman with traceback (K3 + K4).
//
// Replaces shrimp_tpu/ops/sw_full.py::sw_full_batch_packed (the banded
// NW/N/W affine DP in packed band coordinates u = j - band_xmin[i]) and
// traceback_batch_packed_jax (the pointer walk), fused in one launch as
// sw_full_and_traceback_packed_jax is.  Same contract: stats int32
// [B, 10] = (score, read_start, genome_start, matches, mismatches,
// insertions, deletions, rmapped, gmapped, ops_len) and ops uint8
// [B, R + G] (MATCH/INS/DEL in alignment order, zero past ops_len).
//
// Semantics kept bit for bit: gaps open only from the NW state; local
// mode floors each state at 0 and zeroes its pointer; tie order is
// nw, n, w on the forward strand and w, n, nw for revcmpl lanes, decided
// by strict greater (the W pointer compares the two candidates with >=);
// virtual row -1 carries (NW, N, W) = (0, b_gap_open, a_gap_open) in both
// modes; predecessors outside the previous row's packed band read the
// border triple; out-of-band cells take the border triple, then cells
// outside the grid take 0 (local) or NEG_INF (glocal); the row-to-row
// band shift is clipped to [0, shift_max]; the best cell is the
// row-major first strict maximum (glocal: last read row only); the walk
// reads pointer 0 for a predecessor outside the packed band.
//
// What bounds it on an H100: integer issue and latency.  The DP is a
// chain of rlen dependent rows; a main-path alignment (50 rows, W 64)
// holds about 1,050 band cells, 16 to 34 a row, so a warp an alignment,
// sweeping all W columns of every row, computed three lane-slots for each
// band cell.  HBM is not the limit: a row reads a few bytes of input, and the
// bound counts 24 operations a band cell.
//
// Design: a tile of T lanes per alignment, each lane owning C adjacent
// columns of a segment of S = T * C (template parameters; (16, 2) at the
// main path's W), 32 / T alignments to a warp.  The tile first stages its
// window, and per row (xmin, nc, plane offset, read code), in shared
// memory; nc[i] = min(band width, W, glen - xmin[i]) is the row's
// computed prefix (0 from rlen on), and every other column's value is
// implied: past W or before column 0 the border triple, past glen the
// fill, past the band the border triple.  A row is swept segment after
// segment over its prefix only; the warp-wide segment count is the
// largest over its tiles, so the tiles run in step.  One row of states
// (an int4 per column) is updated in place, one segment late: segment s
// reads its predecessors (columns s*S + d - 1 and up), then writes
// segment s - 1's states, so every read sees the previous row.  The W
// state is each lane's running max of the tilted NW row over its columns,
// then a log2 T shfl_up scan of the lanes' maxima over the tile, with a
// carried segment maximum; its pointer compares the exact west
// neighbours.  Pointers (p_nw | p_n << 2 | p_w << 4) of the computed
// prefix only are packed row after row (row i at nc[0] + ... +
// nc[i - 1]).  The best cell is kept per lane as (score, i * W + u, start
// state) and reduced over the tile by xor shuffles.  Lane 0 of each tile
// then walks its own alignment (32 / T walks at once), buffers the ops in
// shared memory, and the tile writes them reversed.  One warp a block.
//
// Tiers, fixed per launch by make_plan from (G, R, W) alone (the bands
// stay on the card):
//  - the pointer plane sits in shared memory when an alignment's band
//    cells fit PLANE_SMEM bytes (every main-path alignment does), else in
//    the global scratch.  Without reading the bands the launcher cannot
//    tell, so whenever R * W exceeds PLANE_SMEM the caller allocates R * W
//    bytes an alignment (the main path's R 56, W 64 included), written
//    only by the alignments that overflow, at their band cells;
//  - the per-row info and the window are staged in shared memory when a
//    warp's tiles fit a block; past that (reads of thousands of rows) the
//    tile is the whole warp, the per-row info lives in the global scratch
//    and the window is read where it lies, so a block holds only the state
//    row and the op buffer: no more than the one-warp kernel this design
//    replaced needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr int GENOME_PAD = -1;
constexpr unsigned FULL = 0xffffffffu;
// one warp a block: a block's shared memory is its tiles', so small
// blocks pack an SM's 228 KB without a remainder of a whole warp's share
constexpr int MIN_BLOCKS = 16;           // registers: at most 128 a lane
constexpr int SMEM_MAX = 227 * 1024;     // shared memory a block may use
// an alignment's shared-memory pointer plane, bytes: covers the main
// path's 878 to 1,271 band cells an alignment; at 16 x 2 lanes it
// measured faster than the global plane (PERF.md section 6)
constexpr int PLANE_SMEM = 2048;

constexpr int STATE_NW = 0, STATE_N = 1, STATE_W = 2;
constexpr int NW_FROM_NW = 1, NW_FROM_N = 2, NW_FROM_W = 3;
constexpr int N_FROM_N = 1, N_FROM_NW = 2;
constexpr int W_FROM_W = 1, W_FROM_NW = 2;
constexpr uint8_t OP_MATCH = 0, OP_INS = 1, OP_DEL = 2;

struct Params {
  int match, mismatch, aoe, ae, boe, be, a_go, b_go;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// One alignment's shared memory, byte offsets: the state row (an int4 per
// column), when staged the per-row info (xmin, nc, plane offset, read
// code) and the window, the op buffer (in the state row when it fits: the
// row is dead once the sweep is over) and the pointer plane's budget P.
struct Layout {
  int row, info, gen, ops, plane, bytes;
  __host__ __device__ Layout(int G, int R, int W, int P, bool stage) {
    row = 0;
    int o = align16(W * 16);
    info = gen = o;
    if (stage) {
      o += R * 16;
      gen = o;
      o += align16(G);
    }
    if (R + G <= W * 16) {
      ops = row;
    } else {
      ops = o;
      o += align16(R + G);
    }
    plane = o;
    bytes = o + align16(P);
  }
};

// A launch's shape: T lanes of C columns an alignment, whether the
// per-row info and window are staged in shared memory, the shared plane
// budget P, and the global scratch an alignment (the plane, then, when
// not staged, the per-row info).
struct Plan {
  int T, C, stage, P, per;
};

// false when even one alignment a block does not fit its shared memory
bool make_plan(int G, int R, int W, Plan& pl) {
  const long long full = (long long)R * W;
  pl.T = W <= 128 ? 16 : 32;
  pl.C = 2;
  pl.stage = 1;
  pl.P = (int)(full < PLANE_SMEM ? full : PLANE_SMEM);
  const long long plane = (full + 15) & ~15LL;
  long long per = full > pl.P ? plane : 0;
  if ((32 / pl.T) * (long long)Layout(G, R, W, pl.P, true).bytes > SMEM_MAX) {
    pl.T = 32;
    pl.stage = 0;
    pl.P = 0;
    if (Layout(G, R, W, 0, false).bytes > SMEM_MAX) return false;
    per = (long long)R * 16 + plane;
  }
  if (per > 0x7fffffffLL) return false;
  pl.per = (int)per;
  return true;
}

// Cycle stamps for utils/pass2_probe.py, which defines PASS2_PROBE in the
// copy it builds; nothing in this build.
#ifndef PASS2_PROBE
#define PASS2_PROBE(k)
#endif

template <int T>
__device__ __forceinline__ int tile_sum(int v) {
#pragma unroll
  for (int o = T >> 1; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o, T);
  return v;
}

template <int T, int C, bool STAGE>
__global__ void __launch_bounds__(32, MIN_BLOCKS) sw_full_kernel(
    const int8_t* __restrict__ genome, const int8_t* __restrict__ read,
    const uint8_t* __restrict__ revcmpl, const int* __restrict__ band_xmin,
    const int* __restrict__ band_xmax, int B, int G, int R, int W,
    int shift_max, int local, Params p, int P, int per,
    uint8_t* __restrict__ scratch, int* __restrict__ stats,
    uint8_t* __restrict__ ops) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TPW = 32 / T;
  constexpr int S = T * C;  // columns a segment
  const int lane = threadIdx.x & 31;
  const int tl = lane & (T - 1);
  const int slot = lane / T;
  const int b = blockIdx.x * TPW + slot;
  const bool live = b < B;  // the others keep their lanes for the shuffles
  PASS2_PROBE(0);

  const Layout lay(G, R, W, P, STAGE);
  unsigned char* ts = smem + (size_t)slot * lay.bytes;
  // this alignment's global scratch: the plane, after the per-row info
  // when that is not staged
  uint8_t* gs = scratch + (long long)(live ? b : 0) * per;
  int4* row = reinterpret_cast<int4*>(ts + lay.row);
  int4* info = reinterpret_cast<int4*>(STAGE ? ts + lay.info : gs);
  int8_t* staged = reinterpret_cast<int8_t*>(ts + lay.gen);
  const int8_t* sg =
      STAGE ? staged : genome + (long long)(live ? b : 0) * G;
  uint8_t* opbuf = ts + lay.ops;
  const bool loc = local != 0;
  const bool rc = live && revcmpl[b] != 0;
  const int L = R + G;

  // rlen / glen = number of codes >= 0; the window into shared memory
  int rlen = 0, glen = 0;
  if (live) {
    const int8_t* g = genome + (long long)b * G;
    const int8_t* r = read + (long long)b * R;
    for (int k = tl; k < G; k += T) {
      const int c = g[k];
      if (STAGE) staged[k] = (int8_t)c;
      glen += c >= 0;
    }
    for (int k = tl; k < R; k += T) rlen += r[k] >= 0;
  }
  rlen = tile_sum<T>(rlen);
  glen = tile_sum<T>(glen);
  // per row: xmin, the computed prefix nc, the row's plane offset, the
  // read code; rows >= rlen compute nothing and are never walked
  if (live) {
    const int* xm = band_xmin + (long long)b * R;
    const int* xx = band_xmax + (long long)b * R;
    const int8_t* r = read + (long long)b * R;
    for (int k = tl; k < R; k += T) {
      const int x0 = xm[k];
      const int nc = k < rlen ? max(min(min(xx[k] - x0 + 1, W), glen - x0), 0)
                              : 0;
      info[k] = make_int4(x0, nc, 0, r[k]);
    }
  }
  __syncwarp();
  // plane offsets: each lane sums a run of rows, then a tile scan
  const int rows_per = (R + T - 1) / T;
  const int r0 = min(tl * rows_per, R), r1 = min(r0 + rows_per, R);
  int run = 0;
  if (live)
    for (int k = r0; k < r1; ++k) run += info[k].y;
  int incl = run;
#pragma unroll
  for (int o = 1; o < T; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o, T);
    if (tl >= o) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, T - 1, T);
  if (live) {
    int o = incl - run;
    for (int k = r0; k < r1; ++k) {
      reinterpret_cast<int*>(info + k)[2] = o;
      o += info[k].y;
    }
  }
  __syncwarp();
  // the pointer plane's tier
  uint8_t* plane = STAGE && total <= P ? ts + lay.plane
                                       : gs + (STAGE ? 0 : R * 16);

  const int fill = loc ? 0 : NEG_INF;
  const int4 fill4 = make_int4(fill, fill, fill, 0);
  const int4 bor4 = loc ? make_int4(0, p.b_go, p.a_go, 0)
                        : make_int4(NEG_INF, NEG_INF, NEG_INF, 0);
  const int4 top4 = make_int4(0, p.b_go, p.a_go, 0);

  // this lane's first strict maximum in row-major order: score, i*W + u,
  // and the walk's start state there
  int lb = 0, lpos = 0, lst = STATE_NW;
  int nc_p = 0, xmin_p = 0, gl_p = 0;
  const int rmax = __reduce_max_sync(FULL, rlen);
  for (int i = 0; i < rmax; ++i) {
    const int4 ri = i < rlen ? info[i] : make_int4(0, 0, 0, 0);
    const int xc = ri.x, nci = ri.y, rch = ri.w;
    const int nseg = __reduce_max_sync(FULL, (nci + S - 1) / S);
    const int d = i == 0 ? 0 : min(max(xc - xmin_p, 0), shift_max);
    const int gsh = min(max(xc, 0), shift_max);
    const bool elig = loc || i == rlen - 1;
    uint8_t* prow = plane + ri.z;
    int c_nw = bor4.x;   // floored NW at column s*S - 1
    int c_w = bor4.z;    // floored W at column s*S - 1
    int c_run = bor4.x;  // max over c <= s*S of cand[c] + ae*c
    int4 pend[C];        // the previous segment's states, not yet written
    int pend_u = 0, pend_n = 0;
    for (int s = 0; s < nseg; ++s) {
      const int u0 = s * S + tl * C;  // this lane's first column
      // predecessors: v[c] is (i-1, j-1) of column u0 + c, v[c + 1] its
      // (i-1, j); past the previous row's prefix the implied values
      int4 v[C + 1];
#pragma unroll
      for (int c = 0; c <= C; ++c) {
        const int k = u0 + d - 1 + c;
        v[c] = i == 0 ? top4  // virtual row -1, in both modes
               : (unsigned)k < (unsigned)nc_p ? row[k]
               : (k >= gl_p && k >= 0 && k < W) ? fill4 : bor4;
      }
      __syncwarp();  // every read of this segment precedes the writes
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < pend_n) row[pend_u + c] = pend[c];

      int s_nw[C], s_n[C], w_fl[C], ptr[C], tilt[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int u = u0 + c;
        const int gi = u + gsh;
        const int gc = gi < G ? (int)sg[gi] : GENOME_PAD;
        const int ms = gc == rch ? p.match : p.mismatch;
        // NW state (diagonal predecessors)
        const int a1 = v[c].x + ms, a2 = v[c].y + ms, a3 = v[c].z + ms;
        int snw, pnw;
        if (!rc) {
          snw = a1; pnw = NW_FROM_NW;
          if (a2 > snw) { snw = a2; pnw = NW_FROM_N; }
          if (a3 > snw) { snw = a3; pnw = NW_FROM_W; }
        } else {
          snw = a3; pnw = NW_FROM_W;
          if (a2 > snw) { snw = a2; pnw = NW_FROM_N; }
          if (a1 > snw) { snw = a1; pnw = NW_FROM_NW; }
        }
        if (loc && snw <= 0) { snw = 0; pnw = 0; }
        // N state (north predecessors)
        const int n1 = v[c + 1].x - p.boe, n2 = v[c + 1].y - p.be;
        int sn, pn;
        if (!rc) {
          sn = n1; pn = N_FROM_NW;
          if (n2 > sn) { sn = n2; pn = N_FROM_N; }
        } else {
          sn = n2; pn = N_FROM_N;
          if (n1 > sn) { sn = n1; pn = N_FROM_NW; }
        }
        if (loc && sn <= 0) { sn = 0; pn = 0; }
        s_nw[c] = snw;
        s_n[c] = sn;
        ptr[c] = pnw | (pn << 2);
        // the lane's running max of the tilted NW row
        const int t = snw + p.ae * (u + 1);
        tilt[c] = c ? max(tilt[c - 1], t) : t;
      }
      // W state: tilted prefix max over [border NW, floored NW row]: the
      // lanes' maxima scanned over the tile, then each lane's own columns
      int inc = tilt[C - 1];
#pragma unroll
      for (int o = 1; o < T; o <<= 1)
        inc = max(inc, __shfl_up_sync(FULL, inc, o, T));
      int ex = __shfl_up_sync(FULL, inc, 1, T);
      ex = tl == 0 ? c_run : max(ex, c_run);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int u = u0 + c;
        const int excl = c ? max(ex, tilt[c - 1]) : ex;
        const int sw = max(excl - p.aoe - p.ae * u, bor4.z - p.ae * (u + 1));
        w_fl[c] = loc ? max(sw, 0) : sw;
      }
      int nw_west = __shfl_up_sync(FULL, s_nw[C - 1], 1, T);
      int w_west = __shfl_up_sync(FULL, w_fl[C - 1], 1, T);
      if (tl == 0) { nw_west = c_nw; w_west = c_w; }
      c_nw = __shfl_sync(FULL, s_nw[C - 1], T - 1, T);
      c_w = __shfl_sync(FULL, w_fl[C - 1], T - 1, T);
      c_run = max(c_run, __shfl_sync(FULL, inc, T - 1, T));
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int u = u0 + c;
        const int cnw = (c ? s_nw[c - 1] : nw_west) - p.aoe;
        const int cw = (c ? w_fl[c - 1] : w_west) - p.ae;
        int pw = rc ? (cw >= cnw ? W_FROM_W : W_FROM_NW)
                    : (cnw >= cw ? W_FROM_NW : W_FROM_W);
        // the floored W equals w_fl; a floored cell has no pointer
        if (loc && w_fl[c] <= 0) pw = 0;
        if (u < nci) {
          const int cell = __vimax3_s32(s_nw[c], s_n[c], w_fl[c]);
          if (elig && cell > lb) {
            lb = cell;
            lpos = i * W + u;
            lst = w_fl[c] > s_nw[c] ? STATE_W : STATE_NW;
            if (s_n[c] > max(s_nw[c], w_fl[c])) lst = STATE_N;
          }
          prow[u] = (uint8_t)(ptr[c] | (pw << 4));
        }
        pend[c] = make_int4(s_nw[c], s_n[c], w_fl[c], 0);
      }
      pend_u = u0;
      pend_n = min(max(nci - u0, 0), C);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < pend_n) row[pend_u + c] = pend[c];
    __syncwarp();
    nc_p = nci;
    xmin_p = xc;
    gl_p = glen - xc;
  }

  PASS2_PROBE(1);
  // best cell over the tile: max score, then the lowest i*W + u
#pragma unroll
  for (int o = T >> 1; o; o >>= 1) {
    const int ob = __shfl_xor_sync(FULL, lb, o, T);
    const int opos = __shfl_xor_sync(FULL, lpos, o, T);
    const int ost = __shfl_xor_sync(FULL, lst, o, T);
    if (ob > lb || (ob == lb && opos < lpos)) {
      lb = ob;
      lpos = opos;
      lst = ost;
    }
  }
  __syncwarp();  // the pointers written by all lanes are visible

  int nops = 0;
  if (tl == 0 && live) {
    int rs = 0, gs = 0, mt = 0, mm = 0, ins = 0, dl = 0;
    if (lb > 0) {
      int i = lpos / W;
      int j = info[i].x + (lpos - i * W);
      int state = lst;
      for (int step = 0; step < L; ++step) {
        const int ii = min(max(i, 0), R - 1);
        const int jj = min(max(j, 0), G - 1);
        const int4 rr = info[ii];
        const int ur = jj - rr.x;
        const int cell =
            (unsigned)ur < (unsigned)rr.y ? plane[rr.z + ur] : 0;
        const int ptr = (cell >> (2 * state)) & 3;
        if (ptr == 0) break;
        if (state == STATE_NW) {
          opbuf[nops++] = OP_MATCH;
          if (sg[jj] == rr.w) ++mt; else ++mm;
          rs = i; gs = j;
          --i; --j;
          state = ptr == NW_FROM_NW ? STATE_NW
                  : ptr == NW_FROM_N ? STATE_N : STATE_W;
        } else if (state == STATE_N) {
          opbuf[nops++] = OP_DEL;
          ++dl;
          rs = i;
          --i;
          state = ptr == N_FROM_N ? STATE_N : STATE_NW;
        } else {
          opbuf[nops++] = OP_INS;
          ++ins;
          gs = j;
          --j;
          state = ptr == W_FROM_W ? STATE_W : STATE_NW;
        }
        if (i < 0 || j < 0) break;
      }
    }
    int* st = stats + (long long)b * 10;
    st[0] = lb; st[1] = rs; st[2] = gs; st[3] = mt; st[4] = mm;
    st[5] = ins; st[6] = dl; st[7] = mt + mm + dl; st[8] = mt + mm + ins;
    st[9] = nops;
  }
  nops = __shfl_sync(FULL, nops, 0, T);
  __syncwarp();
  if (live) {
    uint8_t* orow = ops + (long long)b * L;
    for (int k = tl; k < L; k += T)
      orow[k] = k < nops ? opbuf[nops - 1 - k] : (uint8_t)0;
  }
  PASS2_PROBE(2);
}

template <int T, int C, bool STAGE>
int launch(const int8_t* genome, const int8_t* read, const uint8_t* revcmpl,
           const int* band_xmin, const int* band_xmax, int B, int G, int R,
           int W, int shift_max, int local, Params p, int P, int per,
           uint8_t* scratch, int* stats, uint8_t* ops, cudaStream_t stream) {
  const int smem = (32 / T) * Layout(G, R, W, P, STAGE).bytes;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_full_kernel<T, C, STAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + 32 / T - 1) / (32 / T);
  sw_full_kernel<T, C, STAGE><<<grid, 32, smem, stream>>>(
      genome, read, revcmpl, band_xmin, band_xmax, B, G, R, W, shift_max,
      local, p, P, per, scratch, stats, ops);
  return (int)cudaGetLastError();
}

Params make_params(int match, int mismatch, int a_gap_open, int a_gap_extend,
                   int b_gap_open, int b_gap_extend) {
  Params p;
  p.match = match;
  p.mismatch = mismatch;
  p.aoe = -(a_gap_open + a_gap_extend);
  p.ae = -a_gap_extend;
  p.boe = -(b_gap_open + b_gap_extend);
  p.be = -b_gap_extend;
  p.a_go = a_gap_open;
  p.b_go = b_gap_open;
  return p;
}

}  // namespace

// The launch's shape for an alignment of G, R, W: out = (lanes a tile,
// columns a lane, staged, shared plane budget, global scratch bytes an
// alignment).  Returns -1 when an alignment does not fit a block's shared
// memory, else 0.
extern "C" int sw_full_plan(int G, int R, int W, int* out) {
  Plan pl;
  if (!make_plan(G, R, W, pl)) return -1;
  out[0] = pl.T; out[1] = pl.C; out[2] = pl.stage; out[3] = pl.P;
  out[4] = pl.per;
  return 0;
}

// One launch over B alignments: genome int8 [B, G] (GENOME_PAD-padded),
// read int8 [B, R] (READ_PAD-padded), revcmpl uint8 [B], band_xmin /
// band_xmax int32 [B, R]; stats int32 [B, 10] and ops uint8 [B, R + G] are
// written in full.  shift_max is the TPU kernel's shift clip (smallest
// power of two >= G, minus 1).  scratch holds B times the bytes
// sw_full_plan gives an alignment (null when that is 0).  Scoring
// parameters are the reference's signed scores.  Runs on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int sw_full_launch(
    const void* genome, const void* read, const void* revcmpl,
    const void* band_xmin, const void* band_xmax, int B, int G, int R,
    int W, int shift_max, int local, int match, int mismatch,
    int a_gap_open, int a_gap_extend, int b_gap_open, int b_gap_extend,
    void* scratch, void* stats, void* ops, void* stream) {
  if (B <= 0) return 0;
  Plan pl;
  if (!make_plan(G, R, W, pl)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(match, mismatch, a_gap_open, a_gap_extend,
                               b_gap_open, b_gap_extend);
  auto* g = (const int8_t*)genome;
  auto* r = (const int8_t*)read;
  auto* rc = (const uint8_t*)revcmpl;
  auto* x0 = (const int*)band_xmin;
  auto* x1 = (const int*)band_xmax;
  auto* sc = (uint8_t*)scratch;
  auto* st = (int*)stats;
  auto* op = (uint8_t*)ops;
  auto* s = (cudaStream_t)stream;
  if (!pl.stage)
    return launch<32, 2, false>(g, r, rc, x0, x1, B, G, R, W, shift_max,
                                local, p, 0, pl.per, sc, st, op, s);
  if (pl.T == 16)
    return launch<16, 2, true>(g, r, rc, x0, x1, B, G, R, W, shift_max,
                               local, p, pl.P, pl.per, sc, st, op, s);
  return launch<32, 2, true>(g, r, rc, x0, x1, B, G, R, W, shift_max, local,
                             p, pl.P, pl.per, sc, st, op, s);
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
