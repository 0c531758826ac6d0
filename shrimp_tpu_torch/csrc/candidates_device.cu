// On-device candidate generation, L3 (K10): seed lookups, posting
// expansion, region-count pruning, anchor collapse, window pairing and
// emission for one strand of a batch of reads.
//
// Replaces shrimp_tpu/ops/candidates_device.py::_device_candidates (via
// device_candidates), a jitted XLA program that is itself a port of the
// host path pipeline/candidates_batch.py (anchors_batch + hit_list_batch).
// The JAX program leaves its two stable sorts and its prefix sums to XLA;
// the port leaves them to torch.sort(stable=True) and torch.cumsum, and
// every other stage is one of the kernels below, launched in this order by
// ops/candidates_device.py::device_candidates_cuda:
//
//   l3_lens          one thread per (read, k-mer) row of one seed: k-mer id
//                    (2-bit packing, or the Jenkins chain of -H), the
//                    minpos shift, the rlen bound, positioned seeds, the
//                    CSR offsets lookup and the list cut-off
//   l3_expand        one warp per row: the row's postings at its exclusive
//                    prefix-sum start, and the dense (read, region) visits
//   l3_region_keep   dense region counts: the keep test per anchor
//   l3_region_visits / l3_region_runs
//                    sparse region counts: (read, region) visit keys, then,
//                    after a stable sort, runs of length >= 2
//   l3_compact_a2    the stable compaction into the a2 plane, with the
//                    (rid << 32 | x) sort key
//   l3_collapse_prep the (rid, x) order, contig numbers, diagonal-slot keys
//   l3_collapse_runs run heads over equal (rid, slot, diag, contig) after
//                    the stable slot sort: run weight and extent
//   l3_pair_emit     one thread per anchor: the backward pairing scan,
//                    threshold and emit flag, window and anchor join
//   l3_compact       the stable compaction of a column plane by a flag
//
// What bounds it on an H100: bytes, through gathers.  Each row reads two
// CSR offsets at a random k-mer id; each posting is read once, and with
// region counts it costs one or two random int32 atomics into a (read,
// region) table.  The rest touches each anchor a few times.  Arithmetic is
// a few dozen int32 operations per row and per anchor.
//
// Design: simple kernels that are right; the host sizes every plane from
// the counts it reads back (total postings, survivors, collapsed anchors),
// so no stage works on padding.  Arithmetic is int32 as in the JAX
// program, with its sentinels; floor division where jnp's // floors.  The
// pairing scan is exact as a per-thread loop that stops at the first
// neighbour of another read or below the window floor: anchors are sorted
// by (rid, x), so a neighbour that fails stays failed for every larger k.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned HASH_MASK = (1u << 24) - 1;  // HASH_BITS 24
constexpr int NEG = -(1 << 30);

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {  // b > 0
  int r = a % b;
  return r < 0 ? r + b : r;
}

// The reference's 32-bit integer hash (gmapper.h:308-318).
__device__ __forceinline__ uint32_t jenkins32(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}

__global__ void l3_lens_kernel(const int8_t* __restrict__ codes,
                               const int* __restrict__ rlen,
                               const int* __restrict__ minpos, int B, int R,
                               int K, int span, const int* __restrict__ ones,
                               int n_ones, const int* __restrict__ seed_pos,
                               int n_seed_pos, int use_hashing,
                               int hash_words,
                               const int* __restrict__ offsets,
                               int list_cutoff, int* __restrict__ lens,
                               int* __restrict__ lo) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)B * K) return;
  const int b = (int)(row / K), k = (int)(row % K);
  const int start = k + minpos[b];
  bool valid = start + span <= rlen[b];
  if (n_seed_pos >= 0) {  // positioned seed: allowed k-mer offsets only
    bool allow = false;
    for (int i = 0; i < n_seed_pos; ++i) allow |= seed_pos[i] == k;
    valid = valid && allow;
  }
  const int8_t* c = codes + (long long)b * R;
  uint32_t mi;
  if (!use_hashing) {
    uint32_t acc = 0;
    for (int q = 0; q < n_ones; ++q) {
      const int idx = min(start + ones[q], R - 1);
      acc |= ((uint32_t)(int)c[idx] & 3u) << (2 * q);
    }
    mi = acc;
  } else {
    // kmer_to_mapidx_hash: nibbles of the seed's ones, 8 per word, each
    // word chained through the Jenkins mix
    uint32_t key = 0;
    for (int w = 0; w < hash_words; ++w) {
      uint32_t v = 0;
      for (int q = 0; q < n_ones; ++q) {
        const int o = ones[q];
        const int j = span - 1 - o;
        if (j / 8 != w) continue;
        const int idx = min(start + o, R - 1);
        v |= ((uint32_t)(int)c[idx] & 0xFu) << (4 * (j % 8));
      }
      key = jenkins32(v ^ key);
    }
    mi = key & HASH_MASK;
  }
  const int l = offsets[valid ? mi : 0];
  int n = 0;
  if (valid) {
    n = offsets[mi + 1] - l;
    if (n > list_cutoff) n = 0;
  }
  lens[row] = n;
  lo[row] = l;
}

// plane: int32 [4, a_cap] rows (x, rid, y, length).
__global__ void l3_expand_kernel(
    const int* __restrict__ lens, const long long* __restrict__ starts,
    const int* __restrict__ lo, long long L,
    const long long* __restrict__ seed_row_base,
    const int* __restrict__ seed_K, const int* __restrict__ seed_span,
    int n_seeds, const int* __restrict__ minpos,
    const int* __restrict__ positions, long long P, long long a_cap,
    int* __restrict__ plane, int* __restrict__ table, long long n_regions,
    int region_bits, int region_overlap) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= L) return;
  const int n = lens[row];
  const long long s0 = starts[row];
  if (n <= 0 || s0 >= a_cap) return;
  int sn = 0;
  while (sn + 1 < n_seeds && row >= seed_row_base[sn + 1]) ++sn;
  const long long local = row - seed_row_base[sn];
  const int K = seed_K[sn];
  const int b = (int)(local / K);
  const int y = (int)(local % K) + minpos[b];
  const int span = seed_span[sn];
  const long long base = lo[row];
  const int off_mask = (1 << region_bits) - 1;
  for (int i = lane; i < n; i += 32) {
    const long long s = s0 + i;
    if (s >= a_cap) break;
    long long src = base + i;
    src = src < 0 ? 0 : (src >= P ? P - 1 : src);
    const int x = positions[src];
    plane[s] = x;
    plane[a_cap + s] = b;
    plane[2 * a_cap + s] = y;
    plane[3 * a_cap + s] = span;
    if (table) {
      const int reg = x >> region_bits;
      const long long flat = (long long)b * n_regions + reg;
      atomicAdd(table + flat, 1);
      if ((x & off_mask) < region_overlap && reg > 0)
        atomicAdd(table + flat - 1, 1);
    }
  }
}

__global__ void l3_region_keep_kernel(const int* __restrict__ plane,
                                      long long n, const int* __restrict__ table,
                                      long long n_regions, int region_bits,
                                      int region_overlap,
                                      uint8_t* __restrict__ flag) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int x = plane[s], b = plane[n + s];
  const int reg = x >> region_bits;
  const long long flat = (long long)b * n_regions + reg;
  const bool ext = (x & ((1 << region_bits) - 1)) < region_overlap && reg > 0;
  flag[s] = table[flat] >= 2 || (ext && table[flat - 1] >= 2);
}

// Visit keys (rid << 32 | region): the main visit of anchor s at s, its
// previous-region extension at n + s (a sentinel key past every real one,
// with source n, when the anchor has none).
__global__ void l3_region_visits_kernel(const int* __restrict__ plane,
                                        long long n, int B, int region_bits,
                                        int region_overlap,
                                        long long* __restrict__ vkeys,
                                        long long* __restrict__ vsrc) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int x = plane[s], b = plane[n + s];
  const int reg = x >> region_bits;
  const bool ext = (x & ((1 << region_bits) - 1)) < region_overlap && reg > 0;
  vkeys[s] = ((long long)b << 32) | (unsigned)reg;
  vsrc[s] = s;
  vkeys[n + s] = ext ? (((long long)b << 32) | (unsigned)(reg - 1))
                     : (((long long)B << 32) | 0x7FFFFFF0LL);
  vsrc[n + s] = ext ? s : n;
}

// skeys: the visit keys sorted; order: their source positions in vkeys.
__global__ void l3_region_runs_kernel(const long long* __restrict__ skeys,
                                      const long long* __restrict__ order,
                                      const long long* __restrict__ vsrc,
                                      long long n_vis, long long n,
                                      uint8_t* __restrict__ flag) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_vis) return;
  const long long key = skeys[p];
  const bool has2 = (p > 0 && skeys[p - 1] == key) ||
                    (p + 1 < n_vis && skeys[p + 1] == key);
  const long long src = vsrc[order[p]];
  if (has2 && src < n) flag[src] = 1;
}

// Anchor s of the [4, n] expansion plane goes to row pos[s] - 1 of the
// [4, cap] a2 plane when flag[s] (flag null: every anchor, at row s), with
// its sort key rid << 32 | x.
__global__ void l3_compact_a2_kernel(const int* __restrict__ plane,
                                     long long n,
                                     const uint8_t* __restrict__ flag,
                                     const long long* __restrict__ pos,
                                     long long cap, int* __restrict__ out,
                                     long long* __restrict__ key) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  if (flag && !flag[s]) return;
  const long long t = flag ? pos[s] - 1 : s;
  if (t >= cap) return;
  const int x = plane[s], b = plane[n + s];
  out[t] = x;
  out[cap + t] = b;
  out[2 * cap + t] = plane[2 * n + s];
  out[3 * cap + t] = plane[3 * n + s];
  key[t] = ((long long)b << 32) | (unsigned)x;
}

// a2: [4, n] rows (x, rid, y, length); perm: the stable (rid, x) order.
// Writes sorted: [6, n] rows (x, y, length, rid, contig, weight 1) and,
// for the collapse, gkey = rid * (R + 1) + diagonal slot.
__global__ void l3_collapse_prep_kernel(
    const int* __restrict__ a2, const long long* __restrict__ perm,
    long long n, const int* __restrict__ rlen,
    const int* __restrict__ contig_offsets, int C, int R1,
    int* __restrict__ sorted, int* __restrict__ gkey) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long p = perm[i];
  const int x = a2[p], b = a2[n + p], y = a2[2 * n + p], ln = a2[3 * n + p];
  // get_contig_num: the last contig whose offset is <= max(x, 0)
  const int xc = max(x, 0);
  int lo = 0, hi = C;  // first offset > xc lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (contig_offsets[mid] <= xc) lo = mid + 1; else hi = mid;
  }
  const int cn = min(max(lo - 1, 0), C - 1);
  sorted[i] = x;
  sorted[n + i] = y;
  sorted[2 * n + i] = ln;
  sorted[3 * n + i] = b;
  sorted[4 * n + i] = cn;
  sorted[5 * n + i] = 1;
  if (gkey) {
    const int rl = max(rlen[b], 1);
    gkey[i] = b * R1 + floormod(x + rl - y, rl);
  }
}

// g_order: the stable gkey order.  A run is a maximal stretch of g_order
// with equal (rid, slot) = gkey, diagonal x - y and contig; its head (the
// first, so the least x) keeps the run's weight and extent, updated in
// place, and is flagged; every other member is dropped.
__global__ void l3_collapse_runs_kernel(int* __restrict__ sorted,
                                        const int* __restrict__ gkey,
                                        const long long* __restrict__ g_order,
                                        long long n,
                                        uint8_t* __restrict__ flag) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int* X = sorted;
  const int* Y = sorted + n;
  const int* CN = sorted + 4 * n;
  const long long i = g_order[p];
  const int gk = gkey[i], diag = X[i] - Y[i], cn = CN[i];
  if (p > 0) {
    const long long q = g_order[p - 1];
    if (gkey[q] == gk && X[q] - Y[q] == diag && CN[q] == cn) {
      flag[i] = 0;
      return;
    }
  }
  int wt = 1;
  int ext = X[i] + sorted[2 * n + i];
  for (long long pq = p + 1; pq < n; ++pq) {
    const long long q = g_order[pq];
    if (gkey[q] != gk || X[q] - Y[q] != diag || CN[q] != cn) break;
    ++wt;
    ext = max(ext, X[q] + sorted[2 * n + q]);
  }
  sorted[2 * n + i] = ext - X[i];
  sorted[5 * n + i] = wt;
  flag[i] = 1;
}

// Column c of in [ncols, n] goes to out [ncols, cap] at row pos[s] - 1
// when flag[s] (flag null: row s).
__global__ void l3_compact_kernel(const int* __restrict__ in, int ncols,
                                  long long n, const uint8_t* __restrict__ flag,
                                  const long long* __restrict__ pos,
                                  long long cap, int* __restrict__ out) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  if (flag && !flag[s]) return;
  const long long t = flag ? pos[s] - 1 : s;
  if (t >= cap) return;
  for (int c = 0; c < ncols; ++c) out[c * cap + t] = in[c * n + s];
}

// anchors: [6, n] rows (x, y, length, rid, contig, weight), sorted by
// (rid, x).  out: [11, n] rows (rid, cn, g_off, w_len, score_window_gen,
// matches, score_max, anchor_x, anchor_y, anchor_length, anchor_width).
__global__ void l3_pair_emit_kernel(
    const int* __restrict__ anchors, long long n,
    const int* __restrict__ rlen, const int* __restrict__ wlen_cfg,
    const int* __restrict__ thr_read, const int* __restrict__ contig_offsets,
    const int* __restrict__ contig_len, int match, int b_gap_open,
    int b_gap_extend, int gapless, int match_mode, int pct_threshold,
    int thr_abs, int* __restrict__ out, uint8_t* __restrict__ emit,
    int* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* X = anchors;
  const int* Y = anchors + n;
  const int* LN = anchors + 2 * n;
  const int* RID = anchors + 3 * n;
  const int* WT = anchors + 5 * n;
  const int x = X[i], y = Y[i], ln = LN[i], r = RID[i];
  const int cn = anchors[4 * n + i], wt = WT[i];
  const int rl = rlen[r], wc = wlen_cfg[r];
  const int coff = contig_offsets[cn], clen = contig_len[cn];
  const int w_len = min(wc, clen);
  const int gend = min((x - coff) + rl - 1 - y, clen - 1);
  const int gstart = gend >= wc ? gend - wc : 0;
  const int floor_x = coff + gstart;

  int ms = ln * match;
  if (!gapless && match_mode == 2 && wt == 1) ms = -1;
  long long mi = i;
  if (!gapless) {
    // read_get_hit_list_per_strand's backward scan over [lo_idx, i - 1]
    for (long long j = i - 1; j >= 0; --j) {
      if (RID[j] != r) break;
      const int xj = X[j];
      if (xj < floor_x) break;
      const int yj = Y[j];
      if (yj >= y) continue;
      const int dx = x - xj, dy = y - yj;
      const bool del_in_read = dx - dy > 0;
      const int short_len = (del_in_read ? dy : dx) + ln;
      const int long_len = (del_in_read ? dx : dy) + ln;
      const int tmp = short_len * match +
                      (long_len > short_len
                           ? b_gap_open + (long_len - short_len) * b_gap_extend
                           : 0);
      if (tmp > ms) {
        ms = tmp;
        mi = j;
      }
    }
  }

  const int base = min(rl, w_len) * match;
  int thr = thr_abs;
  if (pct_threshold) {
    thr = thr_read[r];
    // a window clamped by a short contig has another truncation base:
    // the caller maps such a batch on the host
    if (w_len != wc && rl > w_len) atomicOr(overflow, 1);
  }
  emit[i] = (gapless || match_mode == 1) ? 1 : (ms >= thr);

  // window coordinates and the anchor join (hit_list_batch formulas)
  const int xj = X[mi], yj = Y[mi], lj = LN[mi];
  const int x_len = (x - xj) + ln;
  const int half = floordiv(wc - x_len, 2);
  int goff = half < xj - coff ? (xj - coff) - half : 0;
  if (goff + w_len > clen) goff = clen - w_len;
  const bool has_pair = mi < i;
  const int xi = x - coff - goff, yi = y, li = ln;
  const int xjw = xj - coff - goff;
  int nw = min(xi + yi, has_pair ? xjw + yj : xi + yi);
  const int sw = min(xi - yi, has_pair ? xjw - yj : xi - yi);
  int ne = max(xi - yi, has_pair ? xjw - yj : xi - yi);
  int se = max(xi + yi + 2 * (li - 1),
               has_pair ? xjw + yj + 2 * (lj - 1) : xi + yi + 2 * (li - 1));
  if ((nw + sw) % 2 != 0) nw -= 1;
  int axj = floordiv(nw + sw, 2);
  int ayj = nw - axj;
  if ((ne - sw) % 2 != 0) ne += 1;
  int aw = floordiv(ne - sw, 2) + 1;
  if ((se - nw) % 2 != 0) se += 1;
  int al = floordiv(se - nw, 2) + 1;
  if (!has_pair) {
    axj = xi;
    ayj = yi;
    al = li;
    aw = 1;
  }
  const int nmat = has_pair ? wt + WT[mi] : wt;

  out[i] = r;
  out[n + i] = cn;
  out[2 * n + i] = goff;
  out[3 * n + i] = w_len;
  out[4 * n + i] = ms;
  out[5 * n + i] = nmat;
  out[6 * n + i] = base;
  out[7 * n + i] = axj;
  out[8 * n + i] = ayj;
  out[9 * n + i] = al;
  out[10 * n + i] = aw;
}

inline unsigned blocks(long long n, long long per_block = THREADS) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

// Each entry point launches one kernel on `stream`, allocates nothing and
// returns cudaGetLastError().  Shapes are as the kernels above describe.

extern "C" int l3_lens_launch(const void* codes, const void* rlen,
                              const void* minpos, int B, int R, int K,
                              int span, const void* ones, int n_ones,
                              const void* seed_pos, int n_seed_pos,
                              int use_hashing, int hash_words,
                              const void* offsets, int list_cutoff,
                              void* lens, void* lo, void* stream) {
  const long long rows = (long long)B * K;
  if (rows <= 0) return 0;
  l3_lens_kernel<<<blocks(rows), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int*)rlen, (const int*)minpos, B, R, K,
      span, (const int*)ones, n_ones, (const int*)seed_pos, n_seed_pos,
      use_hashing, hash_words, (const int*)offsets, list_cutoff, (int*)lens,
      (int*)lo);
  return (int)cudaGetLastError();
}

extern "C" int l3_expand_launch(const void* lens, const void* starts,
                                const void* lo, long long L,
                                const void* seed_row_base, const void* seed_K,
                                const void* seed_span, int n_seeds,
                                const void* minpos, const void* positions,
                                long long P, long long a_cap, void* plane,
                                void* table, long long n_regions,
                                int region_bits, int region_overlap,
                                void* stream) {
  if (L <= 0) return 0;
  l3_expand_kernel<<<blocks(L, THREADS / 32), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const int*)lens, (const long long*)starts, (const int*)lo, L,
      (const long long*)seed_row_base, (const int*)seed_K,
      (const int*)seed_span, n_seeds, (const int*)minpos,
      (const int*)positions, P, a_cap, (int*)plane, (int*)table, n_regions,
      region_bits, region_overlap);
  return (int)cudaGetLastError();
}

extern "C" int l3_region_keep_launch(const void* plane, long long n,
                                     const void* table, long long n_regions,
                                     int region_bits, int region_overlap,
                                     void* flag, void* stream) {
  if (n <= 0) return 0;
  l3_region_keep_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)plane, n, (const int*)table, n_regions, region_bits,
      region_overlap, (uint8_t*)flag);
  return (int)cudaGetLastError();
}

extern "C" int l3_region_visits_launch(const void* plane, long long n, int B,
                                       int region_bits, int region_overlap,
                                       void* vkeys, void* vsrc,
                                       void* stream) {
  if (n <= 0) return 0;
  l3_region_visits_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)plane, n, B, region_bits, region_overlap,
      (long long*)vkeys, (long long*)vsrc);
  return (int)cudaGetLastError();
}

extern "C" int l3_region_runs_launch(const void* skeys, const void* order,
                                     const void* vsrc, long long n_vis,
                                     long long n, void* flag, void* stream) {
  if (n_vis <= 0) return 0;
  l3_region_runs_kernel<<<blocks(n_vis), THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)skeys, (const long long*)order,
      (const long long*)vsrc, n_vis, n, (uint8_t*)flag);
  return (int)cudaGetLastError();
}

extern "C" int l3_compact_a2_launch(const void* plane, long long n,
                                    const void* flag, const void* pos,
                                    long long cap, void* out, void* key,
                                    void* stream) {
  if (n <= 0) return 0;
  l3_compact_a2_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)plane, n, (const uint8_t*)flag, (const long long*)pos, cap,
      (int*)out, (long long*)key);
  return (int)cudaGetLastError();
}

extern "C" int l3_collapse_prep_launch(const void* a2, const void* perm,
                                       long long n, const void* rlen,
                                       const void* contig_offsets, int C,
                                       int R1, void* sorted, void* gkey,
                                       void* stream) {
  if (n <= 0) return 0;
  l3_collapse_prep_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a2, (const long long*)perm, n, (const int*)rlen,
      (const int*)contig_offsets, C, R1, (int*)sorted, (int*)gkey);
  return (int)cudaGetLastError();
}

extern "C" int l3_collapse_runs_launch(void* sorted, const void* gkey,
                                       const void* g_order, long long n,
                                       void* flag, void* stream) {
  if (n <= 0) return 0;
  l3_collapse_runs_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (int*)sorted, (const int*)gkey, (const long long*)g_order, n,
      (uint8_t*)flag);
  return (int)cudaGetLastError();
}

extern "C" int l3_compact_launch(const void* in, int ncols, long long n,
                                 const void* flag, const void* pos,
                                 long long cap, void* out, void* stream) {
  if (n <= 0) return 0;
  l3_compact_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)in, ncols, n, (const uint8_t*)flag, (const long long*)pos,
      cap, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int l3_pair_emit_launch(
    const void* anchors, long long n, const void* rlen, const void* wlen_cfg,
    const void* thr_read, const void* contig_offsets, const void* contig_len,
    int match, int b_gap_open, int b_gap_extend, int gapless, int match_mode,
    int pct_threshold, int thr_abs, void* out, void* emit, void* overflow,
    void* stream) {
  if (n <= 0) return 0;
  l3_pair_emit_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)anchors, n, (const int*)rlen, (const int*)wlen_cfg,
      (const int*)thr_read, (const int*)contig_offsets,
      (const int*)contig_len, match, b_gap_open, b_gap_extend, gapless,
      match_mode, pct_threshold, thr_abs, (int*)out, (uint8_t*)emit,
      (int*)overflow);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
