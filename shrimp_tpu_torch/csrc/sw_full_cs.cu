// Colour-space pass 2: band-packed 4-layer Smith-Waterman with traceback
// (K7 + K8).
//
// Replaces shrimp_tpu/ops/sw_full_cs.py::sw_full_cs_batch_packed (the
// banded 4-layer affine DP with crossovers in packed band coordinates
// u = j - band_xmin[i]) and traceback_cs_batch_packed_jax (the pointer
// walk), fused in one launch as sw_full_cs_and_traceback_packed_jax is.
// Run at W = round_up(G, 32) over the full band it also stands in for the
// unbanded sw_full_cs_batch + traceback_cs_batch_jax (K9).  Same contract:
// stats int32 [B, 11] = (score, read_start, genome_start, matches,
// mismatches, insertions, deletions, rmapped, gmapped, ops_len,
// crossovers) and ops uint8 [B, R + G] (type | layer << 2 | 0x10 for a
// crossover, in alignment order, zero past ops_len).
//
// Semantics kept bit for bit (common/sw-full-cs.c as the JAX kernel has
// it): layer k is the read decoded from letter (initbp + k) % 4; NW takes
// the same layer's (i-1, j-1) states and, at the row's crossover cost
// xover[i], the other layers'; N likewise from (i-1, j); W only from its
// own layer.  Each source layer first picks its best candidate (forward
// order nw, n, w; reverse w, n, nw; first strict maximum), then each
// destination picks over its own layer, then the cross layers in
// ascending order.  The W pointer compares its two candidates with >=
// (forward prefers NW, reverse W).  A BASE_N letter on either side scores
// 0.  In taboo rows (i >= rlen - taboo_len) no gap opens.  Local mode
// floors layer 0 at 0 and layers 1-3 at the row's crossover, zeroing the
// pointer; the virtual top row carries (0, b_go, a_go) plus the GLOBAL
// crossover for layers 1-3 in both modes; the border of a row is that
// row's floor triple (local) or NEG_INF (glocal), the previous row's is
// taken with the previous row's crossover.  Cells outside the band or the
// grid take the border values and pointer 0.  The row-to-row band shift is
// clipped to [0, shift_max] as the TPU kernel's log-decomposed shift is.
// The best cell is the row-major first strict maximum over (i, j, k)
// (glocal: last read row only).  The walk starts in NW, then W, then N if
// strictly greater, reads pointer 0 outside the packed band, counts a
// BASE_N column as a match, and ends in a non-primary layer at the cost
// of one more crossover flagged on the first column.
//
// What bounds it on an H100: integer issue and latency, as in the
// letter-space kernel at about six times the work per cell (4 layers x 3
// states, 6-way picks; the bound counts 144 operations a band cell), then
// the serial pointer walk; a row reads a few bytes of input, so HBM is
// not the limit.  A main-path alignment (50 rows, W 64) holds about
// 1,065 band cells.
//
// Design: the letter-space kernel's (csrc/sw_full.cu) with one column a
// lane and four layers a lane.  A tile of T lanes per alignment (T = 16 or
// 32, picked per launch from W), 32 / T alignments to a warp.  The tile
// stages its window, its per-row info (xmin, computed prefix nc, plane
// offset, crossover) and the four read decodings in shared memory; every
// row is swept in segments of T columns over its prefix only, the
// warp-wide segment count being the largest over its tiles.  Past the
// prefix a predecessor reads the previous row's border: in colour space
// the band, W and glen give the same value.  One row of 12 states a
// column (3 int4: NW, N, W of the four layers) is updated in place one
// segment late, so every read of a segment sees the previous row.  Each
// lane first makes the four layers' NW and N, then the four W-state
// scans (log2 T shfl_up steps of width T, side by side) with carried
// segment maxima; each W pointer compares the exact west neighbours.  The
// pointers of a cell (4 layers x p_nw | p_n << 4 | p_w << 8, 8 bytes) are
// packed row after row over the computed prefixes, in the global scratch:
// a shared-memory plane measured slower at every budget tried, its
// occupancy lost being worth more than the walk it speeds.  The launcher
// cannot read the bands, so the scratch is R * W * 8 bytes an alignment,
// as large as the one-warp kernel's pointer plane; only the band cells
// are written.  The best cell is kept per lane as (score, (i * W + u) * 4
// + k, start state) and reduced over the tile by xor shuffles.  Lane 0 of
// each tile walks its own alignment, buffers the ops, and the tile writes
// them reversed.  One warp a block.
//
// When a warp's tiles do not fit a block's shared memory (reads of
// thousands of rows), the tile is the whole warp, the per-row info and the
// decodings live in the global scratch before the plane, and the window is
// read where it lies: a block then holds only the state row and the op
// buffer, no more than the one-warp kernel this design replaced needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr int GENOME_PAD = -1;
constexpr int BASE_N = 15;
constexpr unsigned FULL = 0xffffffffu;
// one warp a block: a block's shared memory is its tiles', so small
// blocks pack an SM's 228 KB without a remainder of a whole warp's share
constexpr int MIN_BLOCKS = 16;           // registers: at most 128 a lane
constexpr int SMEM_MAX = 227 * 1024;     // shared memory a block may use

constexpr int STATE_NW = 0, STATE_N = 1, STATE_W = 2;
constexpr uint8_t OP_MATCH = 0, OP_INS = 1, OP_DEL = 2, OP_XOVER = 0x10;

struct Params {
  int match, mismatch, aoe, ae, boe, be, a_go, b_go, gxp;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ int ptr_code(int layer, int state) {
  return 1 + layer * 3 + state;
}

// One alignment's shared memory, byte offsets: the state row (3 int4 a
// column), when staged the per-row info (xmin, nc, plane offset,
// crossover), the read decodings (4 codes an int) and the window, then the
// op buffer (in the state row when it fits).
struct Layout {
  int row, info, qd, gen, ops, bytes;
  __host__ __device__ Layout(int G, int R, int W, bool stage) {
    row = 0;
    int o = align16(W * 48);
    info = qd = gen = o;
    if (stage) {
      o += R * 16;
      qd = o;
      o += align16(R * 4);
      gen = o;
      o += align16(G);
    }
    if (R + G <= W * 48) {
      ops = row;
    } else {
      ops = o;
      o += align16(R + G);
    }
    bytes = o;
  }
};

// A launch's shape: T lanes an alignment, whether the per-row info,
// decodings and window are staged in shared memory, and the global scratch
// an alignment (when not staged the per-row info and decodings, then the
// pointer plane).
struct Plan {
  int T, stage, per;
};

// false when even one alignment a block does not fit its shared memory
bool make_plan(int G, int R, int W, Plan& pl) {
  pl.T = W <= 64 ? 16 : 32;
  pl.stage = 1;
  long long per = (long long)R * W * 8;
  if ((32 / pl.T) * (long long)Layout(G, R, W, true).bytes > SMEM_MAX) {
    pl.T = 32;
    pl.stage = 0;
    if (Layout(G, R, W, false).bytes > SMEM_MAX) return false;
    per += (long long)R * 16 + align16(R * 4);
  }
  per = (per + 15) & ~15LL;
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

__device__ __forceinline__ int lane4(const int4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

template <int T, bool STAGE>
__global__ void __launch_bounds__(32, MIN_BLOCKS) sw_full_cs_kernel(
    const int8_t* __restrict__ genome, const int8_t* __restrict__ qr4,
    const int* __restrict__ xover, const uint8_t* __restrict__ revcmpl,
    const int* __restrict__ band_xmin, const int* __restrict__ band_xmax,
    int B, int G, int R, int W, int shift_max, int local, int taboo_len,
    Params p, int per, uint8_t* __restrict__ scratch,
    int* __restrict__ stats, uint8_t* __restrict__ ops) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TPW = 32 / T;
  const int lane = threadIdx.x & 31;
  const int tl = lane & (T - 1);
  const int slot = lane / T;
  const int b = blockIdx.x * TPW + slot;
  const bool live = b < B;  // the others keep their lanes for the shuffles
  PASS2_PROBE(0);

  const Layout lay(G, R, W, STAGE);
  unsigned char* ts = smem + (size_t)slot * lay.bytes;
  // this alignment's global scratch: when not staged the per-row info and
  // decodings, then the pointer plane
  uint8_t* gs = scratch + (long long)(live ? b : 0) * per;
  const int qoff = R * 16, poff = STAGE ? 0 : qoff + align16(R * 4);
  int4* row = reinterpret_cast<int4*>(ts + lay.row);
  int4* info = reinterpret_cast<int4*>(STAGE ? ts + lay.info : gs);
  int* sq = reinterpret_cast<int*>(STAGE ? ts + lay.qd : gs + qoff);
  int8_t* staged = reinterpret_cast<int8_t*>(ts + lay.gen);
  const int8_t* sg =
      STAGE ? staged : genome + (long long)(live ? b : 0) * G;
  uint8_t* opbuf = ts + lay.ops;
  const bool loc = local != 0;
  const bool rc = live && revcmpl[b] != 0;
  const int L = R + G;

  // rlen (layer 0) / glen = number of codes >= 0; the window into shared
  // memory
  int rlen = 0, glen = 0;
  if (live) {
    const int8_t* g = genome + (long long)b * G;
    const int8_t* q = qr4 + (long long)b * 4 * R;
    for (int k = tl; k < G; k += T) {
      const int c = g[k];
      if (STAGE) staged[k] = (int8_t)c;
      glen += c >= 0;
    }
    for (int k = tl; k < R; k += T) rlen += q[k] >= 0;
  }
  rlen = tile_sum<T>(rlen);
  glen = tile_sum<T>(glen);
  // per row: xmin, the computed prefix nc, the plane offset, the row's
  // crossover; the four decodings packed a byte a layer
  if (live) {
    const int* xm = band_xmin + (long long)b * R;
    const int* xx = band_xmax + (long long)b * R;
    const int* xo = xover + (long long)b * R;
    const uint8_t* q = reinterpret_cast<const uint8_t*>(qr4) +
                       (long long)b * 4 * R;
    for (int k = tl; k < R; k += T) {
      const int x0 = xm[k];
      const int nc = k < rlen ? max(min(min(xx[k] - x0 + 1, W), glen - x0), 0)
                              : 0;
      info[k] = make_int4(x0, nc, 0, xo[k]);
      sq[k] = (int)q[k] | ((int)q[R + k] << 8) | ((int)q[2 * R + k] << 16) |
              ((int)q[3 * R + k] << 24);
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
  if (live) {
    int o = incl - run;
    for (int k = r0; k < r1; ++k) {
      reinterpret_cast<int*>(info + k)[2] = o;
      o += info[k].y;
    }
  }
  __syncwarp();
  // the pointer plane: 4 x uint16 a band cell
  ushort4* plane = reinterpret_cast<ushort4*>(gs + poff);

  // this lane's first strict maximum in (row, column, layer) order:
  // score, (i*W + u)*4 + k, and the walk's start state there
  int lb = 0, lpos = 0, lst = STATE_NW;
  int nc_p = 0, xmin_p = 0, xp_p = 0;
  const int rmax = __reduce_max_sync(FULL, rlen);
  for (int i = 0; i < rmax; ++i) {
    const int4 ri = i < rlen ? info[i] : make_int4(0, 0, 0, 0);
    const int xc = ri.x, nci = ri.y, xp = ri.w;
    const int qpack = i < rlen ? sq[i] : 0;
    const int nseg = __reduce_max_sync(FULL, (nci + T - 1) / T);
    const int d = i == 0 ? 0 : min(max(xc - xmin_p, 0), shift_max);
    const int gsh = min(max(xc, 0), shift_max);
    const bool tok = i < rlen - taboo_len;
    const bool elig = loc || i == rlen - 1;
    ushort4* prow = plane + ri.z;
    // the previous row's border (what a predecessor past its prefix reads)
    // and this row's
    int4 b_nw, b_n, b_w, c_nw4, c_w4;
    if (loc) {
      b_nw = make_int4(0, xp_p, xp_p, xp_p);
      b_n = make_int4(p.b_go, p.b_go + xp_p, p.b_go + xp_p, p.b_go + xp_p);
      b_w = make_int4(p.a_go, p.a_go + xp_p, p.a_go + xp_p, p.a_go + xp_p);
      c_nw4 = make_int4(0, xp, xp, xp);
      c_w4 = make_int4(p.a_go, p.a_go + xp, p.a_go + xp, p.a_go + xp);
    } else {
      b_nw = b_n = b_w = c_nw4 = c_w4 =
          make_int4(NEG_INF, NEG_INF, NEG_INF, NEG_INF);
    }
    if (i == 0) {  // virtual top row, the global crossover for k > 0
      const int e = p.gxp;
      b_nw = make_int4(0, e, e, e);
      b_n = make_int4(p.b_go, p.b_go + e, p.b_go + e, p.b_go + e);
      b_w = make_int4(p.a_go, p.a_go + e, p.a_go + e, p.a_go + e);
    }
    // carries of the W-state scans, per layer: floored NW and W at column
    // s*T - 1, and the max over c <= s*T of cand[c] + ae*c
    int c_nw[4], c_w[4], c_run[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c_nw[k] = lane4(c_nw4, k);
      c_w[k] = lane4(c_w4, k);
      c_run[k] = tok ? c_nw[k] : NEG_INF;
    }
    int4 pend0 = b_nw, pend1 = b_n, pend2 = b_w;  // written a segment late
    int pend_u = -1;
    for (int s = 0; s < nseg; ++s) {
      const int u = s * T + tl;
      // predecessors: (i-1, j-1) all three states, (i-1, j) NW and N;
      // row 0 reads the virtual top row, past the previous row's prefix
      // its border
      int4 dnw = b_nw, dn = b_n, dw = b_w, nnw = b_nw, nn = b_n;
      if (i > 0) {
        const int kn = u + d;
        const int kd = kn - 1;
        if ((unsigned)kd < (unsigned)nc_p) {
          dnw = row[3 * kd];
          dn = row[3 * kd + 1];
          dw = row[3 * kd + 2];
        }
        if ((unsigned)kn < (unsigned)nc_p) {
          nnw = row[3 * kn];
          nn = row[3 * kn + 1];
        }
      }
      __syncwarp();  // every read of this segment precedes the writes
      if (pend_u >= 0) {
        row[3 * pend_u] = pend0;
        row[3 * pend_u + 1] = pend1;
        row[3 * pend_u + 2] = pend2;
      }
      const int gi = u + gsh;
      const int gc = gi < G ? (int)sg[gi] : GENOME_PAD;

      // per-source-layer first strict maxima of the diagonal (NW) and
      // north (N) candidates
      int md_s[4], md_p[4], mn_s[4], mn_p[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int d_nw = lane4(dnw, l);
        const int d_n = tok ? lane4(dn, l) : NEG_INF;
        const int d_w = lane4(dw, l);
        int sc, pp;
        if (!rc) {
          sc = d_nw; pp = ptr_code(l, STATE_NW);
          if (d_n > sc) { sc = d_n; pp = ptr_code(l, STATE_N); }
          if (d_w > sc) { sc = d_w; pp = ptr_code(l, STATE_W); }
        } else {
          sc = d_w; pp = ptr_code(l, STATE_W);
          if (d_n > sc) { sc = d_n; pp = ptr_code(l, STATE_N); }
          if (d_nw > sc) { sc = d_nw; pp = ptr_code(l, STATE_NW); }
        }
        md_s[l] = sc;
        md_p[l] = pp;
        const int c1 = tok ? lane4(nnw, l) - p.boe : NEG_INF;
        const int c2 = lane4(nn, l) - p.be;
        if (!rc) {
          sc = c1; pp = ptr_code(l, STATE_NW);
          if (c2 > sc) { sc = c2; pp = ptr_code(l, STATE_N); }
        } else {
          sc = c2; pp = ptr_code(l, STATE_N);
          if (c1 > sc) { sc = c1; pp = ptr_code(l, STATE_NW); }
        }
        mn_s[l] = sc;
        mn_p[l] = pp;
      }

      // each destination layer's NW and N: own layer first, then the
      // cross layers ascending
      int o_nw[4], o_n[4], w_fl[4], o_p[4], inc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int reset = k ? xp : 0;
        const int qk = (int)(int8_t)(qpack >> (8 * k));
        const int ms = (gc == BASE_N || qk == BASE_N)
                           ? 0
                           : (gc == qk ? p.match : p.mismatch);
        int s_nw = md_s[k] + ms, p_nw = md_p[k];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (l == k) continue;
          const int cand = md_s[l] + ms + xp;
          if (cand > s_nw) { s_nw = cand; p_nw = md_p[l]; }
        }
        if (loc && s_nw <= reset) { s_nw = reset; p_nw = 0; }
        int s_n = mn_s[k], p_n = mn_p[k];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (l == k) continue;
          const int cand = mn_s[l] + xp;
          if (cand > s_n) { s_n = cand; p_n = mn_p[l]; }
        }
        if (loc && s_n <= reset) { s_n = reset; p_n = 0; }
        o_nw[k] = s_nw;
        o_n[k] = s_n;
        o_p[k] = p_nw | (p_n << 4);
        inc[k] = (tok ? s_nw : NEG_INF) + p.ae * (u + 1);
      }
      // each layer's W state: a tilted prefix max over [border NW, floored
      // NW row] across the tile, the four scans side by side
#pragma unroll
      for (int o = 1; o < T; o <<= 1)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          inc[k] = max(inc[k], __shfl_up_sync(FULL, inc[k], o, T));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int reset = k ? xp : 0;
        int excl = __shfl_up_sync(FULL, inc[k], 1, T);
        excl = tl == 0 ? c_run[k] : max(excl, c_run[k]);
        const int sw = max(excl - p.aoe - p.ae * u,
                           lane4(c_w4, k) - p.ae * (u + 1));
        w_fl[k] = loc ? max(sw, reset) : sw;
        int nw_west = __shfl_up_sync(FULL, o_nw[k], 1, T);
        int w_west = __shfl_up_sync(FULL, w_fl[k], 1, T);
        if (tl == 0) { nw_west = c_nw[k]; w_west = c_w[k]; }
        const int cnw = tok ? nw_west - p.aoe : NEG_INF;
        const int cw = w_west - p.ae;
        int p_w = rc ? (cw >= cnw ? ptr_code(k, STATE_W)
                                  : ptr_code(k, STATE_NW))
                     : (cnw >= cw ? ptr_code(k, STATE_NW)
                                  : ptr_code(k, STATE_W));
        // the floored W equals w_fl; a floored cell has no pointer
        if (loc && w_fl[k] <= reset) p_w = 0;
        o_p[k] |= p_w << 8;
        c_nw[k] = __shfl_sync(FULL, o_nw[k], T - 1, T);
        c_w[k] = __shfl_sync(FULL, w_fl[k], T - 1, T);
        c_run[k] = max(c_run[k], __shfl_sync(FULL, inc[k], T - 1, T));
      }
      // best cell in (column, layer) order, the pointers, pending states
      const bool act = u < nci;
      if (act) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int cell = __vimax3_s32(o_nw[k], o_n[k], w_fl[k]);
          if (elig && cell > lb) {
            lb = cell;
            lpos = ((i * W + u) << 2) | k;
            lst = w_fl[k] > o_nw[k] ? STATE_W : STATE_NW;
            if (o_n[k] > max(o_nw[k], w_fl[k])) lst = STATE_N;
          }
        }
        prow[u] = make_ushort4((unsigned short)o_p[0], (unsigned short)o_p[1],
                               (unsigned short)o_p[2], (unsigned short)o_p[3]);
      }
      pend0 = make_int4(o_nw[0], o_nw[1], o_nw[2], o_nw[3]);
      pend1 = make_int4(o_n[0], o_n[1], o_n[2], o_n[3]);
      pend2 = make_int4(w_fl[0], w_fl[1], w_fl[2], w_fl[3]);
      pend_u = act ? u : -1;
    }
    __syncwarp();
    if (pend_u >= 0) {
      row[3 * pend_u] = pend0;
      row[3 * pend_u + 1] = pend1;
      row[3 * pend_u + 2] = pend2;
    }
    __syncwarp();
    nc_p = nci;
    xmin_p = xc;
    xp_p = xp;
  }

  PASS2_PROBE(1);
  // best cell over the tile: max score, then the lowest (i*W + u)*4 + k
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
    int rs = 0, gs = 0, mt = 0, mm = 0, ins = 0, dl = 0, xo = 0;
    int k = 0;
    if (lb > 0) {
      const int cellpos = lpos >> 2;
      k = lpos & 3;
      int i = cellpos / W;
      int j = info[i].x + (cellpos - i * W);
      int state = lst;
      const auto* pl = reinterpret_cast<const unsigned short*>(plane);
      for (int step = 0; step < L; ++step) {
        const int ii = min(max(i, 0), R - 1);
        const int jj = min(max(j, 0), G - 1);
        const int4 rr = info[ii];
        const int ur = jj - rr.x;
        const int cell =
            (unsigned)ur < (unsigned)rr.y ? pl[(rr.z + ur) * 4 + k] : 0;
        const int ptr = (cell >> (4 * state)) & 15;
        if (ptr == 0) break;
        const int sl = (ptr - 1) / 3, ss = (ptr - 1) % 3;
        const bool xv = sl != k;
        int op;
        if (state == STATE_NW) {
          const int gch = sg[jj];
          const int qch = (int)(int8_t)(sq[ii] >> (8 * k));
          if (gch == qch || gch == BASE_N || qch == BASE_N) ++mt; else ++mm;
          rs = i; gs = j;
          --i; --j;
          op = OP_MATCH;
        } else if (state == STATE_N) {
          ++dl;
          rs = i;
          --i;
          op = OP_DEL;
        } else {
          ++ins;
          gs = j;
          --j;
          op = OP_INS;
        }
        opbuf[nops++] = (uint8_t)(op | (k << 2) | (xv ? OP_XOVER : 0));
        xo += xv;
        k = sl;
        state = ss;
        if (i < 0 || j < 0) break;
      }
    }
    // beginning in a non-primary layer costs one more crossover, flagged
    // on the first column
    if (k != 0 && nops > 0) {
      opbuf[nops - 1] |= OP_XOVER;
      ++xo;
    }
    int* st = stats + (long long)b * 11;
    st[0] = lb; st[1] = rs; st[2] = gs; st[3] = mt; st[4] = mm;
    st[5] = ins; st[6] = dl; st[7] = mt + mm + dl; st[8] = mt + mm + ins;
    st[9] = nops; st[10] = xo;
  }
  nops = __shfl_sync(FULL, nops, 0, T);
  __syncwarp();
  if (live) {
    uint8_t* orow = ops + (long long)b * L;
    for (int t = tl; t < L; t += T)
      orow[t] = t < nops ? opbuf[nops - 1 - t] : (uint8_t)0;
  }
  PASS2_PROBE(2);
}

template <int T, bool STAGE>
int launch(const int8_t* genome, const int8_t* qr4, const int* xover,
           const uint8_t* revcmpl, const int* band_xmin,
           const int* band_xmax, int B, int G, int R, int W, int shift_max,
           int local, int taboo_len, Params p, int per, uint8_t* scratch,
           int* stats, uint8_t* ops, cudaStream_t stream) {
  const int smem = (32 / T) * Layout(G, R, W, STAGE).bytes;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_full_cs_kernel<T, STAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + 32 / T - 1) / (32 / T);
  sw_full_cs_kernel<T, STAGE><<<grid, 32, smem, stream>>>(
      genome, qr4, xover, revcmpl, band_xmin, band_xmax, B, G, R, W,
      shift_max, local, taboo_len, p, per, scratch, stats, ops);
  return (int)cudaGetLastError();
}

Params make_params(int match, int mismatch, int a_gap_open, int a_gap_extend,
                   int b_gap_open, int b_gap_extend, int crossover) {
  Params p;
  p.match = match;
  p.mismatch = mismatch;
  p.aoe = -(a_gap_open + a_gap_extend);
  p.ae = -a_gap_extend;
  p.boe = -(b_gap_open + b_gap_extend);
  p.be = -b_gap_extend;
  p.a_go = a_gap_open;
  p.b_go = b_gap_open;
  p.gxp = crossover;
  return p;
}

}  // namespace

// The launch's shape for an alignment of G, R, W: out = (lanes a tile,
// staged, global scratch bytes an alignment).  Returns -1 when an
// alignment does not fit a block's shared memory, else 0.
extern "C" int sw_full_cs_plan(int G, int R, int W, int* out) {
  Plan pl;
  if (!make_plan(G, R, W, pl)) return -1;
  out[0] = pl.T; out[1] = pl.stage; out[2] = pl.per;
  return 0;
}

// One launch over B alignments: genome int8 [B, G] (GENOME_PAD-padded),
// qr4 int8 [B, 4, R] (READ_PAD-padded), xover int32 [B, R], revcmpl uint8
// [B], band_xmin / band_xmax int32 [B, R]; stats int32 [B, 11] and ops
// uint8 [B, R + G] are written in full.  shift_max is the TPU kernel's
// shift clip (smallest power of two >= G, minus 1).  scratch holds B times
// the bytes sw_full_cs_plan gives an alignment.  Scoring parameters are
// the reference's signed scores, crossover included.  Runs on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int sw_full_cs_launch(
    const void* genome, const void* qr4, const void* xover,
    const void* revcmpl, const void* band_xmin, const void* band_xmax, int B,
    int G, int R, int W, int shift_max, int local, int taboo_len, int match,
    int mismatch, int a_gap_open, int a_gap_extend, int b_gap_open,
    int b_gap_extend, int crossover, void* scratch, void* stats, void* ops,
    void* stream) {
  if (B <= 0) return 0;
  Plan pl;
  if (!make_plan(G, R, W, pl)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(match, mismatch, a_gap_open, a_gap_extend,
                               b_gap_open, b_gap_extend, crossover);
  auto* g = (const int8_t*)genome;
  auto* q = (const int8_t*)qr4;
  auto* xo = (const int*)xover;
  auto* rc = (const uint8_t*)revcmpl;
  auto* x0 = (const int*)band_xmin;
  auto* x1 = (const int*)band_xmax;
  auto* sc = (uint8_t*)scratch;
  auto* st = (int*)stats;
  auto* op = (uint8_t*)ops;
  auto* s = (cudaStream_t)stream;
  if (!pl.stage)
    return launch<32, false>(g, q, xo, rc, x0, x1, B, G, R, W, shift_max,
                             local, taboo_len, p, pl.per, sc, st, op, s);
  if (pl.T == 16)
    return launch<16, true>(g, q, xo, rc, x0, x1, B, G, R, W, shift_max,
                            local, taboo_len, p, pl.per, sc, st, op, s);
  return launch<32, true>(g, q, xo, rc, x0, x1, B, G, R, W, shift_max, local,
                          taboo_len, p, pl.per, sc, st, op, s);
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
