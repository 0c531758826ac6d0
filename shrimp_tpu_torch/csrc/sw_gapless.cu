// Gapless pass 1: the ungapped max-subarray score along each hit's anchor
// diagonal, with the diagonal gathered in the kernel (K6).
//
// Replaces shrimp_tpu/ops/sw_gapless.py::_gapless_core (via
// gapless_score_batch) together with the host gather in front of it,
// shrimp_tpu/pipeline/mapper.py::Mapper._gapless_scores: the -U / -M mirna
// pass-1 engine, which replicates common/sw-gapless.c:sw_gapless.
//
// Per hit n and column t in [0, R):
//   g_t = plane[start[n] + t] while t < glen[n] and the byte lies in the
//         plane, else GENOME_PAD;
//   r_t = reads[rid[n], st[n], r_left[n] + t] while r_left[n] + t lies in
//         [0, R), else READ_PAD;
//   s_t = match if g_t == r_t, else mismatch, where g_t != GENOME_PAD and
//         r_t != READ_PAD; 0 elsewhere.
// Colour space (ls_plane given), where r_left[n] == 0: column 0 scores match
// if lstocs(ls_plane[start[n]], initbp[rid[n]]) == r_0, else 0 (the forced
// first colour, sw-gapless.c:85-95), BASE_N standing in for a letter that is
// not 0-3 or lies past the contig end.  In the pre-gathered form (start
// null: hit n is row n of a [N, R] diagonal plane and of a [N, R] read
// plane) column 0 takes s0[n] when s0 is given.
//
// The score is Kadane's running scan in int32,
//     cur = max(cur, 0) + s_t;  best = max(best, cur)      (cur = best = 0),
// which equals the JAX function's prefix / running-minimum form
//     max(0, max_i (prefix_i - min(0, min_{j<i} prefix_j)))
// exactly: by induction cur_i = prefix_i - m_i with m_i = min(0,
// min_{j<i} prefix_j), since max(prefix_{i-1} - m_{i-1}, 0) = prefix_{i-1}
// - min(m_{i-1}, prefix_{i-1}) = prefix_{i-1} - m_i; and best_i >= 0.
// Columns that score 0 leave best as it is and cur at max(cur, 0), so the
// scan skips the columns before both sides are in range and stops at the
// first column past either side's range.
// tests/test_torch_sw_gapless_gather.py holds a numpy model of this order
// to the prefix form.
//
// What bounds it on an H100: memory.  A hit reads the genome bytes of its
// columns in range (about 50 at R 56) at a random place in a plane of 10^8
// bytes (two or three 32-byte sectors of DRAM) and as many read bytes,
// which stay in cache, and does a few integer operations a column.  At the
// main path's launch of 322,000 hits of R 56 its device time was about 4x
// the time those bytes take at the HBM's rate (an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md).
//
// Design: one thread a hit (the warp a hit this replaces left most lanes
// idle at R 56 and spent every 32-column segment on two shuffle scans), 128
// threads a block.  Each of the two streams (genome, read) is read through
// the read-only path in aligned 16-byte chunks; the 16 bytes of a step are
// cut out of two neighbouring chunks with a funnel shift, so a 50-column
// diagonal costs four or five loads a stream.  16-byte chunks took less
// device time than byte or 4-byte chunks on the main path's launches
// (PERF.md; scripts/gapless_probe.py builds the other widths from a copy
// of this file and times them).  A chunk is loaded only where it holds
// a byte of a column the scan visits, and a chunk that reaches past its
// tensor is read byte by byte, so no alignment of the tensors is assumed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GENOME_PAD = -1;
constexpr int READ_PAD = -2;
constexpr int BASE_N = 15;
constexpr int THREADS = 128;  // a block
constexpr int LOAD = 16;      // bytes a chunk
constexpr int WORDS = LOAD / 4;

struct Hits {
  const uint8_t* plane;
  long long plane_len;
  const long long* start;  // null: the pre-gathered form
  const long long* glen;
  const int* r_left;
  const int* rid;
  const int* st;           // null: strand 0
  const uint8_t* reads;
  long long reads_len;
  int strands;
  int R;
  const int8_t* ls_plane;  // colour space: the forced first colour
  const int8_t* initbp;
  const int* s0;           // pre-gathered form: column 0's score
  int N;
  int match;
  int mismatch;
  int* out;
};

// The bytes p[t] for t = t_begin, t_begin + LOAD, ..., LOAD of them a step
// (as words, byte i in bits 8 (i % 4) of word i / 4).  Bytes of columns
// outside [t_begin, t_end) are not read and come out as 0.
struct Stream {
  uintptr_t next;            // the next aligned chunk
  uintptr_t use_lo, use_hi;  // the bytes of the visited columns
  uintptr_t lo, hi;          // the tensor
  unsigned cur[WORDS];
  int word, shift;           // where column t_begin starts in a chunk

  __device__ __forceinline__ void init(uintptr_t p, int t_begin, int t_end,
                                       uintptr_t tensor_lo,
                                       uintptr_t tensor_hi) {
    use_lo = p + t_begin;
    use_hi = p + t_end;
    lo = tensor_lo;
    hi = tensor_hi;
    const uintptr_t c0 = use_lo & ~(uintptr_t)(LOAD - 1);
    const int off = (int)(use_lo - c0);
    word = off >> 2;
    shift = (off & 3) * 8;
    load(c0, cur);
    next = c0 + LOAD;
  }

  __device__ __forceinline__ void load(uintptr_t c,
                                       unsigned (&w)[WORDS]) const {
#pragma unroll
    for (int j = 0; j < WORDS; ++j) w[j] = 0u;
    if (c + LOAD <= use_lo || c >= use_hi) return;
    if (c >= lo && c + LOAD <= hi) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(c));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
      return;
    }
    // a chunk that reaches past the tensor: its bytes inside, one by one
#pragma unroll
    for (int i = 0; i < LOAD; ++i) {
      const uintptr_t b = c + i;
      if (b >= lo && b < hi)
        w[i >> 2] |= (unsigned)__ldg(reinterpret_cast<const unsigned char*>(b))
                     << (8 * (i & 3));
    }
  }

  __device__ __forceinline__ void step(unsigned (&out)[WORDS]) {
    unsigned nxt[WORDS];
    load(next, nxt);
    next += LOAD;
    // bytes [off, off + 16) of the 32-byte pair cur:nxt
    unsigned v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = cur[j];
      v[j + 4] = nxt[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned a = word == 0 ? v[j] : word == 1 ? v[j + 1]
                         : word == 2 ? v[j + 2] : v[j + 3];
      const unsigned b = word == 0 ? v[j + 1] : word == 1 ? v[j + 2]
                         : word == 2 ? v[j + 3] : v[j + 4];
      out[j] = __funnelshift_r(a, b, shift);
    }
#pragma unroll
    for (int j = 0; j < WORDS; ++j) cur[j] = nxt[j];
  }
};

// One hit's diagonal: the columns [lo, hi) where both the genome byte
// (in the plane, before the contig end) and the read byte (in the row) are
// in range, and column 0's score where it is forced (s0 given, or the
// colour-space first colour where r_left == 0).
struct Frame {
  long long s;  // plane offset of column 0
  int rl;       // read column of column 0
  const uint8_t* row;
  int lo, hi;
  bool forced;
  int s0;
};

__device__ __forceinline__ Frame frame(const Hits& h, int n) {
  const int R = h.R;
  Frame f;
  long long glen;
  int id, strand;
  if (h.start) {
    f.s = h.start[n];
    glen = h.glen[n];
    f.rl = h.r_left[n];
    id = h.rid[n];
    strand = h.st ? h.st[n] : 0;
  } else {
    f.s = (long long)n * R;
    glen = R;
    f.rl = 0;
    id = n;
    strand = 0;
  }
  const long long g_lo = f.s < 0 ? -f.s : 0;
  const long long g_hi = min(glen, h.plane_len - f.s);
  const long long r_lo = f.rl < 0 ? -(long long)f.rl : 0;
  const long long r_hi = (long long)R - f.rl;
  f.lo = (int)min(max(g_lo, r_lo), (long long)R);
  f.hi = (int)max(min(min(g_hi, r_hi), (long long)R), 0LL);
  f.row = h.reads + ((long long)id * h.strands + strand) * (long long)R;
  f.forced = h.s0 || (h.ls_plane && f.rl == 0);
  f.s0 = 0;
  if (h.s0) {
    f.s0 = h.s0[n];
  } else if (f.forced) {
    const int letter =
        (g_lo <= 0 && g_hi > 0) ? h.ls_plane[f.s] : GENOME_PAD;
    const int colour =
        (letter >= 0 && letter <= 3) ? (letter ^ h.initbp[id]) : BASE_N;
    const int r0 = R > 0 ? (int)(int8_t)f.row[0] : READ_PAD;
    f.s0 = colour == r0 ? h.match : 0;
  }
  return f;
}

// One thread a hit.
__global__ void __launch_bounds__(THREADS)
    sw_gapless_kernel(const Hits h) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= h.N) return;
  const Frame f = frame(h, n);
  int cur = 0, best = 0, t_begin = f.lo;
  if (f.forced) {
    cur = f.s0;
    best = max(f.s0, 0);
    t_begin = max(f.lo, 1);
  }
  const int hi = f.hi;
  if (t_begin < hi) {
    Stream g, r;
    g.init((uintptr_t)h.plane + (uintptr_t)f.s, t_begin, hi,
           (uintptr_t)h.plane, (uintptr_t)h.plane + h.plane_len);
    r.init((uintptr_t)f.row + (uintptr_t)(long long)f.rl, t_begin, hi,
           (uintptr_t)h.reads, (uintptr_t)h.reads + h.reads_len);
    for (int t0 = t_begin; t0 < hi; t0 += LOAD) {
      unsigned gw[WORDS], rw[WORDS];
      g.step(gw);
      r.step(rw);
#pragma unroll
      for (int i = 0; i < LOAD; ++i) {
        const int gc = (int)(int8_t)(gw[i >> 2] >> (8 * (i & 3)));
        const int rc = (int)(int8_t)(rw[i >> 2] >> (8 * (i & 3)));
        int sc = gc == rc ? h.match : h.mismatch;
        if (gc == GENOME_PAD || rc == READ_PAD || t0 + i >= hi) sc = 0;
        cur = max(cur, 0) + sc;
        best = max(best, cur);
      }
    }
  }
  h.out[n] = best;
}

int launch(const Hits& h, void* stream) {
  if (h.N <= 0) return 0;
  sw_gapless_kernel<<<(h.N + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(h);
  return (int)cudaGetLastError();
}

}  // namespace

// The fused gather and score over N hits: plane int8 [plane_len]; start,
// glen int64 [N]; r_left, rid int32 [N]; st int32 [N] or null (strand 0);
// reads int8 [B, strands, R] of reads_len bytes; colour space: ls_plane
// int8 [plane_len] and initbp int8 [B], else both null.  out int32 [N].
// Runs on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sw_gapless_gather_launch(
    const void* plane, long long plane_len, const void* start,
    const void* glen, const void* r_left, const void* rid, const void* st,
    const void* reads, long long reads_len, int strands, int R,
    const void* ls_plane, const void* initbp, int N, int match, int mismatch,
    void* out, void* stream) {
  Hits h{(const uint8_t*)plane, plane_len, (const long long*)start,
         (const long long*)glen, (const int*)r_left, (const int*)rid,
         (const int*)st, (const uint8_t*)reads, reads_len, strands, R,
         (const int8_t*)ls_plane, (const int8_t*)initbp, nullptr, N, match,
         mismatch, (int*)out};
  return launch(h, stream);
}

// The pre-gathered form (gapless_score_batch): diag and reads int8 [N, R],
// s0 null or int32 [N], out int32 [N].
extern "C" int sw_gapless_launch(const void* diag, const void* reads,
                                 const void* s0, int N, int R, int match,
                                 int mismatch, void* out, void* stream) {
  const long long len = (long long)N * R;
  Hits h{(const uint8_t*)diag, len, nullptr, nullptr, nullptr, nullptr,
         nullptr, (const uint8_t*)reads, len, 1, R, nullptr, nullptr,
         (const int*)s0, N, match, mismatch, (int*)out};
  return launch(h, stream);
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
