// On-device candidate generation, L3 (K10): seed lookups, posting
// expansion, region-count pruning, anchor collapse, window pairing and
// emission for one strand of a batch of reads.
//
// Replaces shrimp_tpu/ops/candidates_device.py::_device_candidates (via
// device_candidates), a jitted XLA program that is itself a port of the
// host path pipeline/candidates_batch.py (anchors_batch + hit_list_batch).
//
// What bounds it on an H100: bytes, through gathers: two CSR offsets per
// (read, k-mer) row at a random k-mer id and each posting once.  In
// practice the time goes to the reads of repeats, with ten thousand
// postings or more, each of which one block sorts alone; and, for a call
// made from Python, to launching.
//
// Design: a fixed sequence of kernels from one entry point
// (l3_candidates_launch), captured once as a CUDA graph and replayed, with
// every count kept on the device, so the host reads back one small
// counters vector per call.  Every plane is sized by the caller's
// capacities (a_cap postings, a2_cap survivors, h_cap windows) and reused
// from call to call.  The work is read-major: all of a read's postings
// belong to one block, in the order (seed, k-mer, list), which is the
// host's seed-major order restricted to the read, so no stage needs a
// (read, region) table or a global sort:
//
//   l3_lens      one block per read: per (seed, k-mer) row the k-mer id
//                (2-bit packing, or the Jenkins chain of -H), the minpos
//                shift, the rlen bound, positioned seeds, the CSR offsets
//                lookup and the list cut-off; postings per (read, seed)
//   l3_scan_postings   one block: the seed-major prefix of those counts,
//                which cuts the postings past a_cap in the host's
//                seed-major order, and each read's start in the planes
//   l3_keep      one block per read: the read's kept postings, sorted by
//                (x, expansion order); the region-count keep test;
//                survivors to the survivor plane in that order with their
//                rank in the read's expansion order
//   l3_scan_survivors  one block: the seed-major prefix of the survivors,
//                which cuts the survivors past a2_cap, and each read's
//                start in the window staging plane
//   l3_collapse  one block per read: the a2_cap cut, contig numbers, the
//                colinear collapse over (diagonal slot, diagonal, contig)
//                runs, the backward pairing scan (mapping.c:1121-1184), the
//                emission threshold, the window coordinates and the anchor
//                join; emitted windows to the staging plane
//   l3_scan_windows    one block: each read's start in the output
//   l3_final     the output columns [11, h_cap] and the emit flags
//
// Region counts without a (read, region) table: the visits of region r are
// the read's postings with x in [r << bits, ((r + 1) << bits) + overlap)
// (its own postings and the previous-region extensions of region r + 1's),
// an interval of x.  In x order the postings inside an interval are
// contiguous, so a posting's region has a second visit iff its neighbour
// in x order (before or after) lies in the same interval: one comparison
// per neighbour, for any genome size.
//
// The per-read kernels run as three launches each, on side streams so
// that they overlap, every block leaving at once unless its read is in
// the launch's tier: two shared-memory tiers, small blocks for the many
// small reads and 1,024 threads for the few large ones, and one for reads
// too large for them that keeps the same arrays in global scratch at the
// read's plane offset (the reads it takes are counted in the counters
// vector).
// A block sorts up to BITONIC_MAX pairs with a bitonic network and more
// with a least-significant-digit radix sort (stable, so the expansion
// order breaks ties of x).  The collapse's runs are numbered by a prefix
// sum and their extents taken with atomicMax, and the pairing scan walks
// the heads only.  Arithmetic is int32 as in the JAX program, with its
// sentinels; floor division where jnp's // floors.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned HASH_MASK = (1u << 24) - 1;  // HASH_BITS 24
constexpr int MAX_SEEDS = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 1024;
constexpr int NCOLS = 11;
// shared-memory tiers: elements per read (postings for l3_keep, survivors
// for l3_collapse) and threads per block; larger reads take the global tier
// (the large tier's capacity shrinks where the rows' offsets need room)
constexpr int N_SMEM_TIERS = 2;
constexpr int KEEP_CAP[N_SMEM_TIERS] = {1024, 15360};
constexpr int COLLAPSE_CAP[N_SMEM_TIERS] = {512, 4864};
constexpr int TIER_THREADS[N_SMEM_TIERS] = {256, 1024};
constexpr int N_SIDE = N_SMEM_TIERS + 1;  // side streams: tiers, global
constexpr int GLOBAL_THREADS = 1024;
// dynamic shared memory one block may opt into, less room for the static
// (the radix sort's tables among it)
constexpr size_t SMEM_MAX = 232448 - 21504;
// the block's radix sort: bits per pass, bins (32: a warp's lanes) and
// items a thread per tile
constexpr int RADIX_BITS = 5;
constexpr int RADIX_BINS = 1 << RADIX_BITS;
constexpr int RADIX_ITEMS = 4;
// up to this many keys a block sorts by a bitonic network instead
constexpr int BITONIC_MAX = 2048;
// bytes per element of the per-read arrays
constexpr int KEEP_ELEM_BYTES = 2 * (4 + 2);        // two (x, position)
constexpr int COLLAPSE_ELEM_BYTES = 10 * 4 + 2;     // 10 int, 2 flags

// counters (int64)
enum { C_TOTAL = 0, C_SURVIVORS, C_WINDOWS, C_CLAMPED, C_KEEP_GLOBAL,
       C_COLLAPSE_GLOBAL, C_COUNT = 8 };

// seed table (int64 per seed)
enum { S_K = 0, S_SPAN, S_NONES, S_ONES_OFF, S_NPOS, S_POS_OFF, S_ROW_BASE,
       S_OFFSETS, S_FIELDS };

struct Args {
  // inputs: codes [B, R] int8; rlen, minpos, wlen_cfg, thr_read [B] int32
  const int8_t* codes;
  const int* rlen;
  const int* minpos;
  const int* wlen_cfg;
  const int* thr_read;
  // index
  const int* positions;
  const int* contig_offsets;
  const int* contig_len;
  const long long* seedtab;  // [S, S_FIELDS]
  const int* seedints;       // ones and positions of every seed
  // workspace
  int* lens;           // [B, Ktot] postings per row
  int* lo;             // [B, Ktot] CSR start per row
  long long* tot;      // [B, S] postings per (read, seed)
  int* kept;           // [B, S] of them under a_cap
  long long* kbase;    // [B + 1] read starts in the a_cap planes
  int* scnt;           // [B, S] survivors per (read, seed)
  int* a2kept;         // [B, S] of them under a2_cap
  long long* abase;    // [B + 1] read starts in the a2_cap planes
  int* wcnt;           // [B] windows per read
  long long* ebase;    // [B + 1] read starts in the output
  unsigned* kscr;            // [4, a_cap]  keep tier in global memory
  int* surv;                 // [3, a_cap]  survivors: x, row, rank
  int* cints;                // [10, a2_cap] collapse tier in global memory
  uint8_t* cflags;           // [2, a2_cap]
  int* staging;              // [11, a2_cap]
  int* out;                  // [11, h_cap]
  uint8_t* emit;             // [h_cap]
  long long* counters;       // [C_COUNT]
  long long P, a_cap, a2_cap, h_cap;
  int B, R, S, Ktot, C;
  int xbits, sbits;  // bits of a genome position, of a diagonal slot
  int use_hashing, hash_words, list_cutoff;
  int use_region_counts, region_bits, region_overlap, collapse, gapless;
  int match_mode, pct_threshold, thr_abs, match, b_gap_open, b_gap_extend;
};

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

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.  ws holds 32 values.
__device__ long long block_excl_scan(long long v, long long* ws,
                                     long long* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    long long s = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) ws[lane] = s;
  }
  __syncthreads();
  const long long excl = x - v + (w > 0 ? ws[w - 1] : 0);
  *total = ws[nw - 1];
  __syncthreads();
  return excl;
}

// Exclusive scan of get(i) over i in [0, n), in chunks of the block; put(i,
// prefix) for each i.  Returns the sum.  Every thread of the block calls it.
template <typename Get, typename Put>
__device__ long long block_scan(long long n, long long* ws, Get get,
                                Put put) {
  long long carry = 0;
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const long long v = i < n ? get(i) : 0;
    long long tot;
    const long long ex = block_excl_scan(v, ws, &tot);
    if (i < n) put(i, carry + ex);
    carry += tot;
  }
  return carry;
}

// Ascending sort of n (key, value) pairs with distinct values by the
// block, ties of keys in value order: a bitonic network over the next power
// of two N, whose merges compare i with its mirror i ^ (k - 1), then i
// with i ^ j, the lesser pair to the lower index, so pairs missing past n
// act as +infinity and the comparators that reach them are skipped.  For
// small n, where its log^2 stages are fewer barriers than the radix
// sort's passes.
template <typename V>
__device__ void block_bitonic_sort(unsigned* k, V* v, int n) {
  if (n < 2) return;
  int N = 1;
  while (N < n) N <<= 1;
  for (int kk = 2; kk <= N; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const int lj = __ffs(j) - 1;
      for (int t = threadIdx.x; t < (N >> 1); t += blockDim.x) {
        const int i = ((t >> lj) << (lj + 1)) | (t & (j - 1));
        const int p = j == (kk >> 1) ? (i ^ (kk - 1)) : (i | j);
        if (p < n) {
          const unsigned ki = k[i], kp = k[p];
          const V vi = v[i], vp = v[p];
          if (ki > kp || (ki == kp && vi > vp)) {
            k[i] = kp;
            k[p] = ki;
            v[i] = vp;
            v[p] = vi;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Stable ascending sort of n (key, value) pairs by the low `bits` bits of
// the keys: least significant digit first, RADIX_BITS a pass, from
// (ka, va) to (kb, vb) and back; the result ends in (ka, va).  Each pass
// counts the digits, then places the elements a tile at a time, RADIX_ITEMS
// a thread, in index order (item e of thread t is element e * blockDim + t
// of the tile): an element's place is its digit's start, the counts of its
// digit in the tile's earlier (item, warp) slots (a warp-level scan over an
// [item][digit][warp] table) and its rank among the lanes of its warp with
// the same digit in the same item (__match_any_sync).  hist, tot:
// RADIX_BINS ints; wc: RADIX_ITEMS * RADIX_BINS * 32 ints.
template <typename V>
__device__ void block_radix_sort(unsigned* ka, V* va, unsigned* kb, V* vb,
                                 int n, int bits, int* hist, int* tot,
                                 int* wc) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int tile = RADIX_ITEMS * blockDim.x;
  constexpr int WC = RADIX_ITEMS * RADIX_BINS * 32;
  unsigned* ks = ka;
  V* vs = va;
  unsigned* kd = kb;
  V* vd = vb;
  for (int x = threadIdx.x; x < WC; x += blockDim.x) wc[x] = 0;
  for (int sh = 0; sh < bits; sh += RADIX_BITS) {
    for (int d = threadIdx.x; d < RADIX_BINS; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    // the digits' counts, one atomic per digit and warp
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const int d = i < n ? (int)((ks[i] >> sh) & (RADIX_BINS - 1)) : -1;
      const unsigned peers = __match_any_sync(FULL, d);
      if (d >= 0 && (peers & lt) == 0) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (w == 0) {  // exclusive prefix of the bins (RADIX_BINS == 32)
      const int v = hist[lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      hist[lane] = incl - v;
    }
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += tile) {
      unsigned key[RADIX_ITEMS];
      V val[RADIX_ITEMS];
      int dg[RADIX_ITEMS], rk[RADIX_ITEMS];
#pragma unroll
      for (int e = 0; e < RADIX_ITEMS; ++e) {
        const int i = t0 + e * blockDim.x + threadIdx.x;
        dg[e] = -1;
        if (i < n) {
          key[e] = ks[i];
          val[e] = vs[i];
          dg[e] = (int)((key[e] >> sh) & (RADIX_BINS - 1));
        }
        const unsigned peers = __match_any_sync(FULL, dg[e]);
        rk[e] = __popc(peers & lt);
        if (dg[e] >= 0 && rk[e] == 0)
          wc[(e * RADIX_BINS + dg[e]) * 32 + w] = __popc(peers);
      }
      __syncthreads();
      // per digit, exclusive prefix over the (item, warp) slots; the
      // tile's count
      for (int dd = w; dd < RADIX_BINS; dd += nw) {
        int base = 0;
#pragma unroll
        for (int e = 0; e < RADIX_ITEMS; ++e) {
          int* cell = &wc[(e * RADIX_BINS + dd) * 32 + lane];
          const int c = *cell;
          int incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
          }
          *cell = base + incl - c;
          base += __shfl_sync(FULL, incl, 31);
        }
        if (lane == 0) tot[dd] = base;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < RADIX_ITEMS; ++e) {
        if (dg[e] < 0) continue;
        const int pos =
            hist[dg[e]] + wc[(e * RADIX_BINS + dg[e]) * 32 + w] + rk[e];
        kd[pos] = key[e];
        vd[pos] = val[e];
      }
      __syncthreads();
      for (int d = threadIdx.x; d < RADIX_BINS; d += blockDim.x)
        hist[d] += tot[d];
      for (int x = threadIdx.x; x < WC; x += blockDim.x) wc[x] = 0;
      __syncthreads();
    }
    unsigned* tk = ks;
    ks = kd;
    kd = tk;
    V* tv = vs;
    vs = vd;
    vd = tv;
  }
  if (ks != ka) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      ka[i] = ks[i];
      va[i] = vs[i];
    }
    __syncthreads();
  }
}

// The seed whose rows hold row r of a read (row bases ascending).
__device__ __forceinline__ int seed_of_row(const int* rb, int S, int r) {
  int sn = 0;
  while (sn + 1 < S && r >= rb[sn + 1]) ++sn;
  return sn;
}

// ---------------------------------------------------------------------------
__global__ void l3_lens_kernel(Args a) {
  __shared__ unsigned long long acc[MAX_SEEDS];
  __shared__ int rb[MAX_SEEDS + 1];
  const int b = blockIdx.x;
  const int S = a.S;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    acc[t] = 0;
    rb[t] = (int)a.seedtab[t * S_FIELDS + S_ROW_BASE];
  }
  if (threadIdx.x == 0) rb[S] = a.Ktot;
  __syncthreads();
  const int R = a.R;
  const int8_t* c = a.codes + (long long)b * R;
  const int rl = a.rlen[b], mp = a.minpos[b];
  for (int r = threadIdx.x; r < a.Ktot; r += blockDim.x) {
    const int sn = seed_of_row(rb, S, r);
    const long long* st = a.seedtab + sn * S_FIELDS;
    const int k = r - rb[sn];
    const int span = (int)st[S_SPAN], n_ones = (int)st[S_NONES];
    const int* ones = a.seedints + st[S_ONES_OFF];
    const int n_pos = (int)st[S_NPOS];
    const int start = k + mp;
    bool valid = start + span <= rl;
    if (n_pos >= 0) {  // positioned seed: allowed k-mer offsets only
      const int* sp = a.seedints + st[S_POS_OFF];
      bool allow = false;
      for (int i = 0; i < n_pos; ++i) allow |= sp[i] == k;
      valid = valid && allow;
    }
    uint32_t mi;
    if (!a.use_hashing) {
      uint32_t v = 0;
      for (int q = 0; q < n_ones; ++q) {
        const int idx = min(start + ones[q], R - 1);
        v |= ((uint32_t)(int)c[idx] & 3u) << (2 * q);
      }
      mi = v;
    } else {
      // kmer_to_mapidx_hash: nibbles of the seed's ones, 8 per word, each
      // word chained through the Jenkins mix
      uint32_t key = 0;
      for (int w = 0; w < a.hash_words; ++w) {
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
    const int* offsets = reinterpret_cast<const int*>(st[S_OFFSETS]);
    const int l = offsets[valid ? mi : 0];
    int n = 0;
    if (valid) {
      n = offsets[mi + 1] - l;
      if (n > a.list_cutoff) n = 0;
    }
    a.lens[(long long)b * a.Ktot + r] = n;
    a.lo[(long long)b * a.Ktot + r] = l;
    if (n) atomicAdd(&acc[sn], (unsigned long long)n);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < S; t += blockDim.x)
    a.tot[(long long)b * S + t] = (long long)acc[t];
}

// counts [B, S] in seed-major order (seed, then read): the first `cap`
// are kept, kept [B, S] gets how many of each; base [B + 1] the exclusive
// read-major prefix of the kept counts.  Returns the total.
template <typename V>
__device__ long long cut_seed_major(const V* counts, int B, int S,
                                    long long cap, int* kept,
                                    long long* base, long long* ws) {
  const long long n = (long long)B * S;
  const long long total = block_scan(
      n, ws,
      [&](long long i) { return (long long)counts[(i % B) * S + i / B]; },
      [&](long long i, long long pre) {
        const long long v = counts[(i % B) * S + i / B];
        long long k = cap - pre;
        k = k < 0 ? 0 : (k > v ? v : k);
        kept[(i % B) * S + i / B] = (int)k;
      });
  __syncthreads();
  const long long sum = block_scan(
      (long long)B, ws,
      [&](long long b) {
        long long s = 0;
        for (int t = 0; t < S; ++t) s += kept[b * S + t];
        return s;
      },
      [&](long long b, long long pre) { base[b] = pre; });
  if (threadIdx.x == 0) base[B] = sum;
  return total;
}

__global__ void __launch_bounds__(1024) l3_scan_postings_kernel(Args a) {
  __shared__ long long ws[32];
  for (int t = threadIdx.x; t < C_COUNT; t += blockDim.x) a.counters[t] = 0;
  const long long total = cut_seed_major(a.tot, a.B, a.S, a.a_cap, a.kept,
                                         a.kbase, ws);
  if (threadIdx.x == 0) a.counters[C_TOTAL] = total;
}

__global__ void __launch_bounds__(1024) l3_scan_survivors_kernel(Args a) {
  __shared__ long long ws[32];
  const long long total = cut_seed_major(a.scnt, a.B, a.S, a.a2_cap,
                                         a.a2kept, a.abase, ws);
  if (threadIdx.x == 0) a.counters[C_SURVIVORS] = total;
  __syncthreads();
  // reads left with no survivor emit nothing (l3_collapse skips them)
  for (int b = threadIdx.x; b < a.B; b += blockDim.x)
    if (a.abase[b + 1] == a.abase[b]) a.wcnt[b] = 0;
}

__global__ void __launch_bounds__(1024) l3_scan_windows_kernel(Args a) {
  __shared__ long long ws[32];
  const long long n = block_scan(
      (long long)a.B, ws, [&](long long b) { return (long long)a.wcnt[b]; },
      [&](long long b, long long pre) { a.ebase[b] = pre; });
  if (threadIdx.x == 0) {
    a.ebase[a.B] = n;
    a.counters[C_WINDOWS] = n;
  }
}

// ---------------------------------------------------------------------------
// One read per block; reads with lo_n < postings <= hi_n.  Shared memory:
// W, koff [Ktot + 1], then (shared tiers) the per-posting arrays: x and
// position twice over for the sort, later a flag pair and the ranks in
// the second pair's room.  GLOBAL keeps them in kscr at the read's offset.
template <bool GLOBAL>
__global__ void __launch_bounds__(1024)
    l3_keep_kernel(Args a, long long lo_n, long long hi_n) {
  using V = typename std::conditional<GLOBAL, unsigned, uint16_t>::type;
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ long long ws[32];
  __shared__ int rb[MAX_SEEDS + 1], skept[MAX_SEEDS];
  __shared__ int r_hist[RADIX_BINS], r_tot[RADIX_BINS],
      r_wc[RADIX_ITEMS * RADIX_BINS * 32];
  const int b = blockIdx.x;
  const long long kb = a.kbase[b];
  const long long n_ll = a.kbase[b + 1] - kb;
  if (n_ll <= lo_n || n_ll > hi_n) return;
  const int n = (int)n_ll;
  const int S = a.S, Kt = a.Ktot;
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    rb[t] = (int)a.seedtab[t * S_FIELDS + S_ROW_BASE];
    skept[t] = a.kept[(long long)b * S + t];
  }
  if (threadIdx.x == 0) {
    rb[S] = Kt;
    if (GLOBAL) atomicAdd((unsigned long long*)&a.counters[C_KEEP_GLOBAL],
                          1ull);
  }
  long long* W = reinterpret_cast<long long*>(sm);
  int* koff = reinterpret_cast<int*>(W + Kt + 1);
  unsigned *XA, *XB;
  V *PA, *PB;
  if (GLOBAL) {
    XA = a.kscr + kb;
    XB = XA + a.a_cap;
    PA = reinterpret_cast<V*>(XB + a.a_cap);
    PB = PA + a.a_cap;
  } else {
    XA = reinterpret_cast<unsigned*>(
        sm + (((size_t)(Kt + 1) * 12 + 15) & ~(size_t)15));
    XB = XA + n;
    PA = reinterpret_cast<V*>(XB + n);
    PB = PA + n;
  }
  // after the sort: the flags in XB's room, the ranks in PB's
  uint8_t* flag_o = reinterpret_cast<uint8_t*>(XB);
  uint8_t* flag_q = flag_o + n;
  V* rank = PB;
  __syncthreads();
  const int* lens = a.lens + (long long)b * Kt;
  const int* lo = a.lo + (long long)b * Kt;

  // the rows' offsets in the read, then their postings under a_cap (a
  // prefix of each seed's postings in seed-major order)
  const long long wtot = block_scan(
      Kt, ws, [&](long long r) { return (long long)lens[r]; },
      [&](long long r, long long pre) { W[r] = pre; });
  if (threadIdx.x == 0) W[Kt] = wtot;
  __syncthreads();
  block_scan(
      Kt, ws,
      [&](long long r) {
        const int sn = seed_of_row(rb, S, (int)r);
        long long k = skept[sn] - (W[r] - W[rb[sn]]);
        k = k < 0 ? 0 : (k > lens[r] ? lens[r] : k);
        return k;
      },
      [&](long long r, long long pre) { koff[r] = (int)pre; });
  if (threadIdx.x == 0) koff[Kt] = n;
  __syncthreads();

  // expansion: posting i of the read is list entry i - koff[r] of the row
  // r with koff[r] <= i < koff[r + 1]
  auto row_of = [&](int i) {
    int lo_r = 0, hi_r = Kt;  // koff[lo_r] <= i < koff[hi_r]
    while (hi_r - lo_r > 1) {
      const int mid = (lo_r + hi_r) >> 1;
      if (koff[mid] <= i) lo_r = mid; else hi_r = mid;
    }
    return lo_r;
  };
  // four postings at a time, their loads first
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
    long long src[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = row_of(i < n ? i : n - 1);
      src[u] = (long long)lo[r] + (i - koff[r]);
      src[u] = src[u] < 0 ? 0 : (src[u] >= a.P ? a.P - 1 : src[u]);
    }
    int x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = a.positions[src[u]];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) {
        XA[i] = (unsigned)x[u];
        PA[i] = (V)i;
      }
    }
  }
  __syncthreads();
  // stable by x: ties keep the expansion order
  if (n <= BITONIC_MAX)
    block_bitonic_sort(XA, PA, n);
  else
    block_radix_sort(XA, PA, XB, PB, n, a.xbits, r_hist, r_tot, r_wc);

  // region counts: a neighbour in x order inside the region's interval
  const int bits = a.region_bits;
  long long ov = a.region_overlap;
  ov = ov < 0 ? 0 : (ov > (1LL << bits) ? (1LL << bits) : ov);
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int x = (int)XA[q];
    bool keep = true;
    if (a.use_region_counts) {
      const int reg = x >> bits;
      const bool ext = (x & ((1 << bits) - 1)) < a.region_overlap && reg > 0;
      const bool hp = q > 0, hn = q + 1 < n;
      const long long xp = hp ? (int)XA[q - 1] : 0;
      const long long xn = hn ? (int)XA[q + 1] : 0;
      const long long r0 = (long long)reg << bits;
      keep = (hp && xp >= r0) || (hn && xn < r0 + (1LL << bits) + ov) ||
             (ext && ((hp && xp >= r0 - (1LL << bits)) || (hn && xn < r0 + ov)));
    }
    flag_o[PA[q]] = keep;
    flag_q[q] = keep;
  }
  __syncthreads();
  // survivor ranks in expansion order, survivors per seed
  const long long nsur = block_scan(
      n, ws, [&](long long i) { return (long long)flag_o[i]; },
      [&](long long i, long long pre) { rank[i] = (V)pre; });
  __syncthreads();
  for (int t = threadIdx.x; t < S; t += blockDim.x) {
    const int i0 = koff[rb[t]], i1 = koff[rb[t + 1]];
    const long long r0 = i0 < n ? (long long)rank[i0] : nsur;
    const long long r1 = i1 < n ? (long long)rank[i1] : nsur;
    a.scnt[(long long)b * S + t] = (int)(r1 - r0);
  }
  // survivors in x order to the survivor plane
  block_scan(
      n, ws, [&](long long q) { return (long long)flag_q[q]; },
      [&](long long q, long long pre) {
        if (!flag_q[q]) return;
        const int i = PA[q];
        const long long d = kb + pre;
        a.surv[d] = (int)XA[q];
        a.surv[a.a_cap + d] = row_of(i);
        a.surv[2 * a.a_cap + d] = (int)rank[i];
      });
}

// ---------------------------------------------------------------------------
// One read per block; reads with lo_n < a2-kept survivors <= hi_n.
template <bool GLOBAL>
__global__ void __launch_bounds__(1024)
    l3_collapse_kernel(Args a, long long lo_n, long long hi_n) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ long long ws[32];
  __shared__ int rb[MAX_SEEDS + 1], sspan[MAX_SEEDS], spre[MAX_SEEDS],
      sa2[MAX_SEEDS];
  __shared__ int r_hist[RADIX_BINS], r_tot[RADIX_BINS],
      r_wc[RADIX_ITEMS * RADIX_BINS * 32];
  __shared__ int any_clamped;
  const int b = blockIdx.x;
  const long long ab = a.abase[b];
  const long long m2_ll = a.abase[b + 1] - ab;
  if (m2_ll <= lo_n || m2_ll > hi_n) return;
  const int m2 = (int)m2_ll;
  const int S = a.S;
  if (threadIdx.x == 0) {
    int pre = 0;
    for (int t = 0; t < S; ++t) {
      rb[t] = (int)a.seedtab[t * S_FIELDS + S_ROW_BASE];
      sspan[t] = (int)a.seedtab[t * S_FIELDS + S_SPAN];
      spre[t] = pre;
      pre += a.scnt[(long long)b * S + t];
      sa2[t] = a.a2kept[(long long)b * S + t];
    }
    rb[S] = a.Ktot;
    any_clamped = 0;
    if (GLOBAL)
      atomicAdd((unsigned long long*)&a.counters[C_COLLAPSE_GLOBAL], 1ull);
  }
  // per survivor in x order: X, Y, CN, SP (span, later the score), WT,
  // NL (collapsed length), HD (head); per run: RS (first position in slot
  // order, later the heads in x order), RE (extent); SK, SV the slot sort's
  // keys and positions (SK later the runs, then the pairs), with RS, RE as
  // its second buffer; EM the emit flags
  const long long stride = GLOBAL ? a.a2_cap : m2;
  int* base = GLOBAL ? a.cints + ab : reinterpret_cast<int*>(sm);
  unsigned* SK = reinterpret_cast<unsigned*>(base);
  unsigned* SV = SK + stride;
  int *X, *Y, *CN, *SP, *WT, *NL, *RS, *RE;
  uint8_t *HD, *EM;
  X = base + 2 * stride;
  Y = X + stride;
  CN = Y + stride;
  SP = CN + stride;
  WT = SP + stride;
  NL = WT + stride;
  RS = NL + stride;
  RE = RS + stride;
  HD = GLOBAL ? a.cflags + ab : reinterpret_cast<uint8_t*>(RE + m2);
  EM = HD + stride;
  __syncthreads();
  const long long kb = a.kbase[b];
  const long long m = spre[S - 1] + a.scnt[(long long)b * S + S - 1];
  const int mp = a.minpos[b];
  const int C = a.C;

  // the a2_cap cut (a prefix of each seed's survivors in expansion order),
  // compacted in x order; y, seed span and contig number
  block_scan(
      m, ws,
      [&](long long q) {
        const int r = a.surv[a.a_cap + kb + q];
        const int sn = seed_of_row(rb, S, r);
        return (long long)(a.surv[2 * a.a_cap + kb + q] - spre[sn] < sa2[sn]);
      },
      [&](long long q, long long pre) {
        const int r = a.surv[a.a_cap + kb + q];
        const int sn = seed_of_row(rb, S, r);
        if (a.surv[2 * a.a_cap + kb + q] - spre[sn] >= sa2[sn]) return;
        const int i = (int)pre;
        const int x = a.surv[kb + q];
        X[i] = x;
        Y[i] = (r - rb[sn]) + mp;
        SP[i] = sspan[sn];
        // get_contig_num: the last contig whose offset is <= max(x, 0)
        const int xc = max(x, 0);
        int lo_c = 0, hi_c = C;
        while (lo_c < hi_c) {
          const int mid = (lo_c + hi_c) >> 1;
          if (a.contig_offsets[mid] <= xc) lo_c = mid + 1; else hi_c = mid;
        }
        CN[i] = min(max(lo_c - 1, 0), C - 1);
      });
  __syncthreads();

  // colinear collapse: runs of equal (slot, diagonal, contig) in the
  // stable slot order; the head (least x) keeps the run's weight and extent
  if (a.collapse) {
    const int rl = max(a.rlen[b], 1);
    for (int i = threadIdx.x; i < m2; i += blockDim.x) {
      SK[i] = (unsigned)floormod(X[i] + rl - Y[i], rl);
      SV[i] = (unsigned)i;
    }
    __syncthreads();
    if (m2 <= BITONIC_MAX)
      block_bitonic_sort(SK, SV, m2);
    else
      block_radix_sort(SK, SV, reinterpret_cast<unsigned*>(RS),
                       reinterpret_cast<unsigned*>(RE), m2, a.sbits, r_hist,
                       r_tot, r_wc);
    // run heads in slot order (flags in EM for now)
    for (int q = threadIdx.x; q < m2; q += blockDim.x) {
      bool head = true;
      if (q > 0) {
        const int e = SV[q], p = SV[q - 1];
        head = SK[q - 1] != SK[q] || X[p] - Y[p] != X[e] - Y[e] ||
               CN[p] != CN[e];
      }
      EM[q] = head;
    }
    __syncthreads();
    // number the runs: SK gets each position's run, RS each run's first
    // position
    const long long n_runs = block_scan(
        m2, ws, [&](long long q) { return (long long)EM[q]; },
        [&](long long q, long long pre) {
          const int run = (int)(pre + EM[q] - 1);
          if (EM[q]) {
            RS[run] = (int)q;
            RE[run] = INT_MIN;
          }
          SK[q] = (unsigned)run;
        });
    for (int i = threadIdx.x; i < m2; i += blockDim.x) HD[i] = 0;
    __syncthreads();
    for (int q = threadIdx.x; q < m2; q += blockDim.x) {
      const int e = SV[q];
      atomicMax(&RE[SK[q]], X[e] + SP[e]);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < n_runs; r += blockDim.x) {
      const int q0 = RS[r];
      const int e = SV[q0];
      HD[e] = 1;
      WT[e] = (r + 1 < n_runs ? RS[r + 1] : m2) - q0;
      NL[e] = RE[r] - X[e];
    }
  } else {
    for (int i = threadIdx.x; i < m2; i += blockDim.x) {
      HD[i] = 1;
      WT[i] = 1;
      NL[i] = SP[i];
    }
  }
  __syncthreads();
  // the anchors (heads) in x order: RS[h] is the h-th
  const long long n_heads = block_scan(
      m2, ws, [&](long long i) { return (long long)HD[i]; },
      [&](long long i, long long pre) {
        if (HD[i]) RS[pre] = (int)i;
      });
  __syncthreads();

  // the backward pairing scan over the read's anchors in x order,
  // threshold and emit flag (EM[h]); the pair's index goes where the keys
  // were (MI[h]), the score to SP
  int* MI = reinterpret_cast<int*>(SK);
  const int rl = a.rlen[b], wc = a.wlen_cfg[b];
  for (int h = threadIdx.x; h < n_heads; h += blockDim.x) {
    const int i = RS[h];
    const int x = X[i], y = Y[i], ln = NL[i], wt = WT[i], cn = CN[i];
    const int coff = a.contig_offsets[cn], clen = a.contig_len[cn];
    const int w_len = min(wc, clen);
    const int gend = min((x - coff) + rl - 1 - y, clen - 1);
    const int gstart = gend >= wc ? gend - wc : 0;
    const int floor_x = coff + gstart;
    int ms = ln * a.match;
    if (!a.gapless && a.match_mode == 2 && wt == 1) ms = -1;
    int mi = i;
    if (!a.gapless) {
      // read_get_hit_list_per_strand's backward scan over [lo_idx, i - 1]
      for (int k = h - 1; k >= 0; --k) {
        const int j = RS[k];
        const int xj = X[j];
        if (xj < floor_x) break;
        const int yj = Y[j];
        if (yj >= y) continue;
        const int dx = x - xj, dy = y - yj;
        const bool del_in_read = dx - dy > 0;
        const int short_len = (del_in_read ? dy : dx) + ln;
        const int long_len = (del_in_read ? dx : dy) + ln;
        const int tmp =
            short_len * a.match +
            (long_len > short_len
                 ? a.b_gap_open + (long_len - short_len) * a.b_gap_extend
                 : 0);
        if (tmp > ms) {
          ms = tmp;
          mi = j;
        }
      }
    }
    int thr = a.thr_abs;
    if (a.pct_threshold) {
      thr = a.thr_read[b];
      // a window clamped by a short contig has another truncation base:
      // the caller maps such a batch on the host
      if (w_len != wc && rl > w_len) any_clamped = 1;
    }
    EM[h] = (a.gapless || a.match_mode == 1) ? 1 : (ms >= thr);
    MI[h] = mi;
    SP[i] = ms;
  }
  __syncthreads();

  // window coordinates and the anchor join (hit_list_batch formulas) of
  // the emitted anchors, compacted to the read's staging rows
  const long long n_emit = block_scan(
      n_heads, ws, [&](long long h) { return (long long)EM[h]; },
      [&](long long h, long long pre) {
        if (!EM[h]) return;
        const int i = RS[h];
        const int x = X[i], y = Y[i], ln = NL[i], wt = WT[i], cn = CN[i];
        const int mi = MI[h];
        const int coff = a.contig_offsets[cn], clen = a.contig_len[cn];
        const int w_len = min(wc, clen);
        const int xj = X[mi], yj = Y[mi], lj = NL[mi];
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
        const int vals[NCOLS] = {b, cn, goff, w_len, SP[i],
                                 has_pair ? wt + WT[mi] : wt,
                                 min(rl, w_len) * a.match, axj, ayj, al, aw};
        const long long d = ab + pre;
#pragma unroll
        for (int c = 0; c < NCOLS; ++c) a.staging[c * a.a2_cap + d] = vals[c];
      });
  if (threadIdx.x == 0) {
    a.wcnt[b] = (int)n_emit;
    if (any_clamped)
      atomicOr((unsigned long long*)&a.counters[C_CLAMPED], 1ull);
  }
}

__global__ void l3_final_kernel(Args a) {
  const long long n = a.counters[C_WINDOWS];
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < a.h_cap; r += (long long)gridDim.x * blockDim.x) {
    if (r < n) {
      int lo_b = 0, hi_b = a.B;  // ebase[lo_b] <= r < ebase[hi_b]
      while (hi_b - lo_b > 1) {
        const int mid = (lo_b + hi_b) >> 1;
        if (a.ebase[mid] <= r) lo_b = mid; else hi_b = mid;
      }
      const long long s = a.abase[lo_b] + (r - a.ebase[lo_b]);
      for (int c = 0; c < NCOLS; ++c)
        a.out[c * a.h_cap + r] = a.staging[c * a.a2_cap + s];
      a.emit[r] = 1;
    } else {
      for (int c = 0; c < NCOLS; ++c) a.out[c * a.h_cap + r] = 0;
      a.emit[r] = 0;
    }
  }
}

size_t keep_smem(int Ktot, int cap) {
  return (((size_t)(Ktot + 1) * 12 + 15) & ~(size_t)15) +
         (size_t)cap * KEEP_ELEM_BYTES;
}

// Opt `fn` into `bytes` of dynamic shared memory; `*done` remembers the
// most it was opted into on this device, so a call repeats nothing.
cudaError_t set_smem(const void* fn, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = bytes;
  return e;
}

// Side streams of one device, so that the tiers of a per-read kernel run
// side by side: the global tier, the large and the small shared tier.
struct Side {
  cudaStream_t st[N_SIDE];
  cudaStream_t cap;  // where a call's graph is captured
  cudaEvent_t fork, join[N_SIDE];
  bool made;
  size_t smem_keep[2], smem_collapse;  // set_smem's record
};

cudaError_t side_streams(Side** out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (!sd.made) {
    for (int t = 0; t < N_SIDE; ++t) {
      e = cudaStreamCreateWithFlags(&sd.st[t], cudaStreamNonBlocking);
      if (e == cudaSuccess)
        e = cudaEventCreateWithFlags(&sd.join[t], cudaEventDisableTiming);
      if (e != cudaSuccess) return e;
    }
    e = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaStreamCreateWithFlags(&sd.cap, cudaStreamNonBlocking);
    if (e != cudaSuccess) return e;
    sd.made = true;
  }
  *out = &sd;
  return cudaSuccess;
}

#define CHECK(x)                              \
  do {                                        \
    const cudaError_t e_ = (x);               \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

// l3_keep's shared tiers: tier t takes the reads with cap[t - 1] <
// postings <= cap[t], as far as the rows' offsets leave room.
void keep_caps(const Args& a, long long (&cap)[N_SMEM_TIERS]) {
  const size_t head = keep_smem(a.Ktot, 0);
  for (int t = 0; t < N_SMEM_TIERS; ++t) {
    const long long room = (long long)((SMEM_MAX - head) / KEEP_ELEM_BYTES);
    cap[t] = KEEP_CAP[t] < room ? KEEP_CAP[t] : room;
    if (t > 0 && cap[t] < cap[t - 1]) cap[t] = cap[t - 1];
  }
}

// The shared memory the per-read kernels opt into (outside any capture).
cudaError_t prepare(const Args& a, Side* sd) {
  long long cap[N_SMEM_TIERS];
  keep_caps(a, cap);
  cudaError_t e = set_smem((const void*)l3_keep_kernel<true>,
                           keep_smem(a.Ktot, 0), &sd->smem_keep[1]);
  if (e == cudaSuccess)
    e = set_smem((const void*)l3_keep_kernel<false>,
                 keep_smem(a.Ktot, (int)cap[N_SMEM_TIERS - 1]),
                 &sd->smem_keep[0]);
  if (e == cudaSuccess)
    e = set_smem((const void*)l3_collapse_kernel<false>,
                 (size_t)COLLAPSE_CAP[N_SMEM_TIERS - 1] * COLLAPSE_ELEM_BYTES,
                 &sd->smem_collapse);
  return e;
}

// One strand call on stream s: the copy of `bytes` of packed inputs from
// pinned host memory `src` to `dst` (none when bytes is 0), then every
// kernel above in order, the tiers of l3_keep and of l3_collapse on
// side streams that s forks and joins.
int enqueue(const Args& a, Side* sd, const void* src, void* dst,
            long long bytes, cudaStream_t s) {
  if (bytes > 0)
    CHECK(cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyHostToDevice, s));
  const int B = a.B;
  auto fork = [&]() -> cudaError_t {
    cudaError_t e = cudaEventRecord(sd->fork, s);
    for (int t = 0; t < N_SIDE && e == cudaSuccess; ++t)
      e = cudaStreamWaitEvent(sd->st[t], sd->fork, 0);
    return e;
  };
  auto join = [&]() -> cudaError_t {
    cudaError_t e = cudaSuccess;
    for (int t = 0; t < N_SIDE && e == cudaSuccess; ++t) {
      e = cudaEventRecord(sd->join[t], sd->st[t]);
      if (e == cudaSuccess) e = cudaStreamWaitEvent(s, sd->join[t], 0);
    }
    return e;
  };
  if (B > 0) {
    l3_lens_kernel<<<B, 128, 0, s>>>(a);
    CHECK(cudaGetLastError());
  }
  l3_scan_postings_kernel<<<1, SCAN_THREADS, 0, s>>>(a);
  CHECK(cudaGetLastError());
  if (B > 0) {
    // the largest tier first, so that its blocks start first
    long long cap[N_SMEM_TIERS];
    keep_caps(a, cap);
    CHECK(fork());
    l3_keep_kernel<true><<<B, GLOBAL_THREADS, keep_smem(a.Ktot, 0),
                           sd->st[0]>>>(a, cap[N_SMEM_TIERS - 1], 1LL << 62);
    CHECK(cudaGetLastError());
    for (int t = N_SMEM_TIERS - 1; t >= 0; --t) {
      // the first tier also takes the reads with no postings
      l3_keep_kernel<false><<<B, TIER_THREADS[t],
                              keep_smem(a.Ktot, (int)cap[t]),
                              sd->st[N_SMEM_TIERS - t]>>>(
          a, t ? cap[t - 1] : -1, cap[t]);
      CHECK(cudaGetLastError());
    }
    CHECK(join());
  }
  l3_scan_survivors_kernel<<<1, SCAN_THREADS, 0, s>>>(a);
  CHECK(cudaGetLastError());
  if (B > 0) {
    CHECK(fork());
    l3_collapse_kernel<true><<<B, GLOBAL_THREADS, 0, sd->st[0]>>>(
        a, COLLAPSE_CAP[N_SMEM_TIERS - 1], 1LL << 62);
    CHECK(cudaGetLastError());
    for (int t = N_SMEM_TIERS - 1; t >= 0; --t) {
      // reads with no survivors emit nothing (l3_scan_survivors)
      l3_collapse_kernel<false><<<B, TIER_THREADS[t],
                                  (size_t)COLLAPSE_CAP[t] *
                                      COLLAPSE_ELEM_BYTES,
                                  sd->st[N_SMEM_TIERS - t]>>>(
          a, t ? COLLAPSE_CAP[t - 1] : 0, COLLAPSE_CAP[t]);
      CHECK(cudaGetLastError());
    }
    CHECK(join());
  }
  l3_scan_windows_kernel<<<1, SCAN_THREADS, 0, s>>>(a);
  CHECK(cudaGetLastError());
  long long blocks = (a.h_cap + 255) / 256;
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  l3_final_kernel<<<(unsigned)blocks, 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// sizeof(Args), for the caller to check its mirror of the struct
extern "C" int l3_args_size() { return (int)sizeof(Args); }

// One strand call on `stream` (see enqueue), `args` pointing to an Args.
// *graph is the executable graph of this Args and copy: captured on the
// first call (*graph null), then launched whole, in one launch.
// Allocates no device memory; returns the first CUDA error, or 0.
extern "C" int l3_candidates_launch(const void* args, const void* src,
                                    void* dst, long long bytes, void* stream,
                                    void** graph) {
  const Args a = *static_cast<const Args*>(args);
  if (a.S > MAX_SEEDS) return (int)cudaErrorInvalidValue;
  Side* sd = nullptr;
  CHECK(side_streams(&sd));
  CHECK(prepare(a, sd));
  if (!*graph) {
    CHECK(cudaStreamBeginCapture(sd->cap, cudaStreamCaptureModeThreadLocal));
    const int rc = enqueue(a, sd, src, dst, bytes, sd->cap);
    cudaGraph_t g = nullptr;
    const cudaError_t e = cudaStreamEndCapture(sd->cap, &g);
    if (rc != 0 || e != cudaSuccess) {
      if (g) cudaGraphDestroy(g);
      return rc != 0 ? rc : (int)e;
    }
    cudaGraphExec_t exec = nullptr;
    const cudaError_t ei = cudaGraphInstantiate(&exec, g, 0);
    cudaGraphDestroy(g);
    CHECK(ei);
    *graph = exec;
  }
  return (int)cudaGraphLaunch((cudaGraphExec_t)*graph, (cudaStream_t)stream);
}

extern "C" int l3_graph_destroy(void* graph) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)graph);
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
