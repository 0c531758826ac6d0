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
// What bounds it on an H100: integer ALU work and latency, as in the
// letter-space sw_full kernel but about 12 times the work per cell (4
// layers x 3 states, 6-way picks), then the serial pointer walk; a row
// reads a few bytes of input, so HBM is not the limit.
//
// Design: one warp per alignment, scanning read rows.  The previous and
// current rows of 3 states x 4 layers (2 x 12 x W int32, 96 W bytes) live
// in shared memory; lane l owns columns u = 32*s + l of each 32-wide
// segment, reads its predecessors at u + d straight from shared memory,
// and keeps the per-source-layer maxima in registers.  Each layer's W
// state is a tilted warp prefix max over the floored NW row with a
// carried segment maximum; its pointer compares the exact west
// neighbours, fetched with __shfl_up_sync.  Pointers go to a global
// scratch bits[B, R, 4, W] of uint16 (p_nw | p_n << 4 | p_w << 8, 4-bit
// payload 1 + layer*3 + state).  The best cell is kept per lane in scan
// order and reduced across the warp (max score, then lowest row, then
// lowest column; the lane kept the lowest layer).  Lane 0 then walks the
// pointers, buffers the ops in shared memory, and the warp writes them
// reversed.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 28);
constexpr int GENOME_PAD = -1;
constexpr int BASE_N = 15;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_BUDGET = 40 * 1024;

constexpr int STATE_NW = 0, STATE_N = 1, STATE_W = 2;
constexpr uint8_t OP_MATCH = 0, OP_INS = 1, OP_DEL = 2, OP_XOVER = 0x10;

struct Params {
  int match, mismatch, aoe, ae, boe, be, a_go, b_go, gxp;
};

__device__ __forceinline__ int ptr_code(int layer, int state) {
  return 1 + layer * 3 + state;
}

__global__ void sw_full_cs_kernel(
    const int8_t* __restrict__ genome, const int8_t* __restrict__ qr4,
    const int* __restrict__ xover, const uint8_t* __restrict__ revcmpl,
    const int* __restrict__ band_xmin, const int* __restrict__ band_xmax,
    int B, int G, int R, int W, int shift_max, int local, int taboo_len,
    Params p, uint16_t* __restrict__ bits, int* __restrict__ stats,
    uint8_t* __restrict__ ops) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + w;
  if (b >= B) return;  // the whole warp leaves together

  const int L = R + G;
  const int Ls = (L + 15) & ~15;
  // rows[(state * 4 + layer) * W + u]: previous row, then current row
  int* prv = smem + (size_t)w * 24 * W;
  int* cur = prv + 12 * W;
  uint8_t* opbuf = reinterpret_cast<uint8_t*>(smem + (size_t)warps * 24 * W) +
                   (size_t)w * Ls;

  const int8_t* g = genome + (long long)b * G;
  const int8_t* q = qr4 + (long long)b * 4 * R;
  const int* xrow = xover + (long long)b * R;
  const int* xmin = band_xmin + (long long)b * R;
  const int* xmax = band_xmax + (long long)b * R;
  uint16_t* bt = bits + (long long)b * R * 4 * W;
  const bool rc = revcmpl[b] != 0;
  const bool loc = local != 0;

  // rlen / glen = number of codes >= 0 (layer 0 for the read)
  int cnt = 0;
  for (int k = lane; k < R; k += 32) cnt += q[k] >= 0;
  const int rlen = __reduce_add_sync(FULL, cnt);
  cnt = 0;
  for (int k = lane; k < G; k += 32) cnt += g[k] >= 0;
  const int glen = __reduce_add_sync(FULL, cnt);

  // this lane's first strict maximum, in (row, column, layer) scan order
  int lb = 0, li = 0, lu = 0, lj = 0, lk = 0, lnw = 0, ln = 0, lw = 0;
  int xmin_p = 0;
  // rows >= rlen are invalid in every column and never walked: skip them
  for (int i = 0; i < rlen; ++i) {
    const int xc = xmin[i];
    const int bw = xmax[i] - xc;
    const int d = i == 0 ? 0 : min(max(xc - xmin_p, 0), shift_max);
    const int gsh = min(max(xc, 0), shift_max);
    const int xp = xrow[i];
    const int xp_prev = i == 0 ? 0 : xrow[i - 1];
    const bool tok = i < rlen - taboo_len;
    const bool eligible_row = loc || i == rlen - 1;
    int qk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) qk[k] = q[k * R + i];
    // carries of the W-state scans, per layer: floored NW and W at column
    // u0 - 1, and the max over c <= u0 of cand[c] + ae*c
    int c_nw[4], c_w[4], c_run[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ie = k ? xp : 0;
      c_nw[k] = loc ? ie : NEG_INF;
      c_w[k] = loc ? p.a_go + ie : NEG_INF;
      c_run[k] = tok ? c_nw[k] : NEG_INF;
    }
    uint16_t* brow = bt + (long long)i * 4 * W;
    for (int u0 = 0; u0 < W; u0 += 32) {
      const int u = u0 + lane;
      const bool live = u < W;
      const int kk = u + d;  // previous-row packed column of (i-1, j)
      const int gi = u + gsh;
      const int gc = gi < G ? (int)g[gi] : GENOME_PAD;

      // per-source-layer first strict maxima of the diagonal (NW) and
      // north (N) candidates
      int md_s[4], md_p[4], mn_s[4], mn_p[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        int d_nw, d_n, d_w, n_nw, n_n;
        if (i == 0) {  // virtual top row, global crossover for k > 0
          const int e = l ? p.gxp : 0;
          d_nw = n_nw = e;
          d_n = n_n = p.b_go + e;
          d_w = p.a_go + e;
        } else {
          const int e = l ? xp_prev : 0;
          const int b_nw = loc ? e : NEG_INF;
          const int b_n = loc ? p.b_go + e : NEG_INF;
          const int b_w = loc ? p.a_go + e : NEG_INF;
          if (kk >= 1 && kk <= W) {
            d_nw = prv[(0 * 4 + l) * W + kk - 1];
            d_n = prv[(1 * 4 + l) * W + kk - 1];
            d_w = prv[(2 * 4 + l) * W + kk - 1];
          } else {
            d_nw = b_nw;
            d_n = b_n;
            d_w = b_w;
          }
          if (kk <= W - 1) {
            n_nw = prv[(0 * 4 + l) * W + kk];
            n_n = prv[(1 * 4 + l) * W + kk];
          } else {
            n_nw = b_nw;
            n_n = b_n;
          }
        }
        if (!tok) d_n = NEG_INF;
        int s, pp;
        if (!rc) {
          s = d_nw; pp = ptr_code(l, STATE_NW);
          if (d_n > s) { s = d_n; pp = ptr_code(l, STATE_N); }
          if (d_w > s) { s = d_w; pp = ptr_code(l, STATE_W); }
        } else {
          s = d_w; pp = ptr_code(l, STATE_W);
          if (d_n > s) { s = d_n; pp = ptr_code(l, STATE_N); }
          if (d_nw > s) { s = d_nw; pp = ptr_code(l, STATE_NW); }
        }
        md_s[l] = s;
        md_p[l] = pp;
        const int c1 = tok ? n_nw - p.boe : NEG_INF;
        const int c2 = n_n - p.be;
        if (!rc) {
          s = c1; pp = ptr_code(l, STATE_NW);
          if (c2 > s) { s = c2; pp = ptr_code(l, STATE_N); }
        } else {
          s = c2; pp = ptr_code(l, STATE_N);
          if (c1 > s) { s = c1; pp = ptr_code(l, STATE_NW); }
        }
        mn_s[l] = s;
        mn_p[l] = pp;
      }

      const bool valid = u <= bw && xc + u < glen;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int reset = k ? xp : 0;
        const int ms = (gc == BASE_N || qk[k] == BASE_N)
                           ? 0
                           : (gc == qk[k] ? p.match : p.mismatch);
        // NW: own layer first, then the cross layers ascending
        int s_nw = md_s[k] + ms, p_nw = md_p[k];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (l == k) continue;
          const int c = md_s[l] + ms + xp;
          if (c > s_nw) { s_nw = c; p_nw = md_p[l]; }
        }
        if (loc && s_nw <= reset) { s_nw = reset; p_nw = 0; }
        // N
        int s_n = mn_s[k], p_n = mn_p[k];
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          if (l == k) continue;
          const int c = mn_s[l] + xp;
          if (c > s_n) { s_n = c; p_n = mn_p[l]; }
        }
        if (loc && s_n <= reset) { s_n = reset; p_n = 0; }
        // W: tilted prefix max over [border NW, floored NW row]
        int incl = (tok ? s_nw : NEG_INF) + p.ae * (u + 1);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl = max(incl, v);
        }
        int excl = __shfl_up_sync(FULL, incl, 1);
        excl = lane == 0 ? c_run[k] : max(excl, c_run[k]);
        const int col_w = loc ? p.a_go + reset : NEG_INF;
        int s_w = max(excl - p.aoe - p.ae * u, col_w - p.ae * (u + 1));
        const int w_fl = loc ? max(s_w, reset) : s_w;
        int nw_west = __shfl_up_sync(FULL, s_nw, 1);
        int w_west = __shfl_up_sync(FULL, w_fl, 1);
        if (lane == 0) { nw_west = c_nw[k]; w_west = c_w[k]; }
        const int cnw = tok ? nw_west - p.aoe : NEG_INF;
        const int cw = w_west - p.ae;
        int p_w = rc ? (cw >= cnw ? ptr_code(k, STATE_W) : ptr_code(k, STATE_NW))
                     : (cnw >= cw ? ptr_code(k, STATE_NW) : ptr_code(k, STATE_W));
        if (loc && s_w <= reset) { s_w = reset; p_w = 0; }
        c_nw[k] = __shfl_sync(FULL, s_nw, 31);
        c_w[k] = __shfl_sync(FULL, w_fl, 31);
        c_run[k] = max(c_run[k], __shfl_sync(FULL, incl, 31));

        // band-width + grid masking to the row's border values
        if (!valid) {
          s_nw = loc ? reset : NEG_INF;
          s_n = loc ? p.b_go + reset : NEG_INF;
          s_w = col_w;
          p_nw = p_n = p_w = 0;
        }
        if (live) {
          if (valid && eligible_row) {
            const int cell = __vimax3_s32(s_nw, s_n, s_w);
            if (cell > lb) {
              lb = cell; li = i; lu = u; lj = xc + u; lk = k;
              lnw = s_nw; ln = s_n; lw = s_w;
            }
          }
          cur[(0 * 4 + k) * W + u] = s_nw;
          cur[(1 * 4 + k) * W + u] = s_n;
          cur[(2 * 4 + k) * W + u] = s_w;
          brow[k * W + u] = (uint16_t)(p_nw | (p_n << 4) | (p_w << 8));
        }
      }
    }
    __syncwarp();
    int* t = prv; prv = cur; cur = t;
    xmin_p = xc;
  }

  // best cell: max score, then the lowest row, then the lowest column
  const int score = __reduce_max_sync(FULL, lb);
  const bool m1 = lb == score;
  const int imin = __reduce_min_sync(FULL, m1 ? li : INT_MAX);
  const bool m2 = m1 && li == imin;
  const int umin = __reduce_min_sync(FULL, m2 ? lu : INT_MAX);
  const int src = __ffs(__ballot_sync(FULL, m2 && lu == umin)) - 1;
  const int bi = __shfl_sync(FULL, li, src);
  const int bj = __shfl_sync(FULL, lj, src);
  const int bk = __shfl_sync(FULL, lk, src);
  const int s_nw0 = __shfl_sync(FULL, lnw, src);
  const int s_n0 = __shfl_sync(FULL, ln, src);
  const int s_w0 = __shfl_sync(FULL, lw, src);
  __syncwarp();  // the pointer rows written by all lanes are visible

  int nops = 0;
  if (lane == 0) {
    int state = STATE_NW, sb = s_nw0;
    if (s_w0 > sb) { state = STATE_W; sb = s_w0; }
    if (s_n0 > sb) state = STATE_N;
    int i = bi, j = bj, k = bk;
    int rs = 0, gs = 0, mt = 0, mm = 0, ins = 0, dl = 0, xo = 0;
    bool active = score > 0;
    for (int step = 0; active && step < L; ++step) {
      const int ii = min(max(i, 0), R - 1);
      const int jj = min(max(j, 0), G - 1);
      const int ur = jj - xmin[ii];
      const int cell =
          (ur >= 0 && ur < W) ? bt[((long long)ii * 4 + k) * W + ur] : 0;
      const int ptr = (cell >> (4 * state)) & 15;
      if (ptr == 0) break;
      const int sl = (ptr - 1) / 3, ss = (ptr - 1) % 3;
      const bool xv = sl != k;
      int op;
      if (state == STATE_NW) {
        const int gch = g[jj], qch = q[k * R + ii];
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
      active = i >= 0 && j >= 0;
    }
    // beginning in a non-primary layer costs one more crossover, flagged
    // on the first column
    if (k != 0 && nops > 0) {
      opbuf[nops - 1] |= OP_XOVER;
      ++xo;
    }
    int* s = stats + (long long)b * 11;
    s[0] = score; s[1] = rs; s[2] = gs; s[3] = mt; s[4] = mm;
    s[5] = ins; s[6] = dl; s[7] = mt + mm + dl; s[8] = mt + mm + ins;
    s[9] = nops; s[10] = xo;
  }
  nops = __shfl_sync(FULL, nops, 0);
  __syncwarp();
  uint8_t* orow = ops + (long long)b * L;
  for (int t = lane; t < L; t += 32)
    orow[t] = t < nops ? opbuf[nops - 1 - t] : (uint8_t)0;
}

}  // namespace

// One launch over B alignments: genome int8 [B, G] (GENOME_PAD-padded),
// qr4 int8 [B, 4, R] (READ_PAD-padded), xover int32 [B, R], revcmpl uint8
// [B], band_xmin / band_xmax int32 [B, R]; bits is uint16 scratch of
// B * R * 4 * W entries; stats int32 [B, 11] and ops uint8 [B, R + G] are
// written in full.  shift_max is the TPU kernel's shift clip (smallest
// power of two >= G, minus 1).  Scoring parameters are the reference's
// signed scores, crossover included.  Runs on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int sw_full_cs_launch(
    const void* genome, const void* qr4, const void* xover,
    const void* revcmpl, const void* band_xmin, const void* band_xmax, int B,
    int G, int R, int W, int shift_max, int local, int taboo_len, int match,
    int mismatch, int a_gap_open, int a_gap_extend, int b_gap_open,
    int b_gap_extend, int crossover, void* bits, void* stats, void* ops,
    void* stream) {
  if (B <= 0) return 0;
  const size_t per_warp =
      (size_t)24 * W * sizeof(int) + (size_t)((R + G + 15) & ~15);
  int warps = (int)(SMEM_BUDGET / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_full_cs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  p.a_go = a_gap_open;
  p.b_go = b_gap_open;
  p.gxp = crossover;
  const int grid = (B + warps - 1) / warps;
  sw_full_cs_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)genome, (const int8_t*)qr4, (const int*)xover,
      (const uint8_t*)revcmpl, (const int*)band_xmin, (const int*)band_xmax,
      B, G, R, W, shift_max, local, taboo_len, p, (uint16_t*)bits,
      (int*)stats, (uint8_t*)ops);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
