// Colour space's posterior: the 16-state forward/backward over each pass-2
// alignment, read from K7+K8's outputs where they lie on the card.
//
// Replaces no TPU kernel: the JAX package runs this step as host NumPy
// (shrimp_tpu/ops/post_sw.py::post_sw_batch), and so did the port until
// this kernel.  It computes SHRiMP2's sw-post.c (load_local_vectors,
// do_forwards, do_backwards, post_traceback, get_posterior) for every row
// of a K7+K8 launch whose score is at least 1 and at least the row's pass-2
// threshold, as shrimp_tpu_torch/ops/post_sw.py::post_sw_packed_plain does
// on the CPU.
//
// Per row: the alignment's columns are derived from its traceback ops
// (type | layer << 2 | OP_XOVER) as render_alignment_cs + _load_columns do
// from the rendered strings: the columns that consume a read colour, each
// with the genome letter or a gap, the read colour (the clipped prefix's
// colours XOR-folded into the first, a forced column at an N colour), its
// error class (the raw quality byte, the prefix's least byte folded into
// the first, FORCED or NO_QUAL) and the base call (the row's letter
// decoding in the op's layer; in a match column an N takes the genome
// letter).  The forward and backward sweeps follow with NumPy's per-column
// min-scaling, then each column's letter posterior and its quality (capped
// at 40, 0 for an N call), and the posterior Pr[read | location] times the
// gap priors in alignment order.
//
// Exactness: every term that depends on a quality byte or a constant of
// the configuration (log(1 - err), log(err / 3), log(1 - pr_snp),
// log(pr_snp / 3)) comes from the host's table, computed by NumPy as the
// plain version computes it, so the node priors are bit-equal.  Every sum
// keeps NumPy's order: the four predecessors (successors) of a state in
// m = 0..3, the 16-term total in state order, each letter's posterior over
// its four states in ascending order, w's exponent as
// (((F + B) + fscale) + bscale) - total.  A minimum is exact in any order.
// Only the card's exp and log (1 ulp each) differ from the host's, so the
// posterior agrees to about 1e-14 relative and the qualities, truncated
// logarithms, almost always exactly.  No product here is followed by an
// add, so the compiler's FMA contraction changes nothing.
//
// What bounds it on an H100: latency.  A column is a chain of a few
// dependent exp / log and shuffles in float64; a row's 2 x L columns run
// one after another, and the work a column (16 states) is tiny against the
// card's FP64 rate or the bytes a row reads (its ops, window and decodings,
// about R + G + 5 R bytes).  So the design puts many rows in flight:
//
// Design: 16 lanes a row, one lane a state (left letter j >> 2, right
// letter j & 3), 4 rows a block of 64 threads.  Predecessors and successors
// come from __shfl_sync over the row's 16 lanes; a column's minimum is an
// xor-shuffle reduction.  The column descriptors are derived in chunks of
// 16 ops, a lane an op, with ballots counting the genome and read columns
// before each.  The forward rows and scales are kept for the backward
// sweep, which computes each column's posterior as soon as its backward
// row is known: in shared memory where four rows of R columns fit (R up to
// STAGED_MAX_R), else in a global scratch the wrapper allocates, a row's
// slice at row * scratch_per_row.  [N, L, 16] is never written otherwise.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BASE_N = 15;
constexpr int OP_MATCH = 0;
constexpr int OP_INS = 1;
constexpr int OP_DEL = 2;
constexpr int STATES = 16;
constexpr int ROWS = 4;                 // rows a block
constexpr int THREADS = ROWS * STATES;  // 64
constexpr int FORCED = 256;             // error classes past the bytes
constexpr int NO_QUAL = 257;
constexpr int CLASSES = 258;
// shared memory a block may take for its rows' forward sweeps
constexpr int STAGED_MAX_BYTES = 160 * 1024;

// bytes a row's sweep keeps: F (R x 16 doubles), fscale (R doubles) and
// the column descriptors (R words), 8-byte aligned
__host__ __device__ inline long long row_bytes(int R) {
  return (long long)R * (STATES * 8 + 8) + (((long long)R * 4 + 7) & ~7LL);
}

struct Args {
  const uint8_t* ops;     // [N, T]
  const int* stats;       // [N, S]
  const int8_t* genome;   // [N, G]
  const int8_t* qr4;      // [N, 4, R]
  const int* rid;         // [N]
  const int* thresh;      // [N]
  const int8_t* colours;  // [B, RC]
  const uint8_t* qual;    // [B, Q]
  const uint8_t* has_qual;  // [B]
  const int8_t* initbp;     // [B]
  const double* table;    // log(1 - err) [258], log(err / 3) [258],
                          // log(1 - pr_snp), log(pr_snp / 3)
  int N, T, S, G, R, RC, Q, qoff;
  double ins_open, ins_ext, del_open, del_ext, ln10;
  uint8_t* scratch;       // global tier: [N, row_bytes(R)], else null
  double* posterior;      // [N]
  uint8_t* qv;            // [N, R]
};

// A column: letter (0-3 or BASE_N) bits 0-3, has a letter bit 4, colour
// bits 5-8, error class bits 9-17, base call bits 18-21.
__device__ __forceinline__ unsigned pack(int let, bool has_let, int col,
                                         int cls, int bcall) {
  return (unsigned)let | (unsigned)has_let << 4 | (unsigned)col << 5 |
         (unsigned)cls << 9 | (unsigned)bcall << 18;
}

// -log emission of state j in a column (nodePrior, sw-post.c:115-143):
// (0.0 - letter term, or 0.0) - colour term, as the plain version.
__device__ __forceinline__ double node_prior(const Args& a, unsigned d,
                                             int j) {
  const int let = d & 15;
  const bool has_let = (d >> 4) & 1;
  const int col = (d >> 5) & 15;
  const int cls = (d >> 9) & 511;
  const int left = j >> 2, right = j & 3;
  double v = 0.0;
  if (has_let)
    v = 0.0 - (right == let ? __ldg(a.table + 2 * CLASSES)
                            : __ldg(a.table + 2 * CLASSES + 1));
  return v - ((left ^ right) == col ? __ldg(a.table + cls)
                                    : __ldg(a.table + CLASSES + cls));
}

__device__ __forceinline__ double group_min(double v, unsigned mask) {
#pragma unroll
  for (int o = 8; o; o >>= 1)
    v = fmin(v, __shfl_xor_sync(mask, v, o, STATES));
  return v;
}

__global__ void __launch_bounds__(THREADS)
    post_sw_fwbw_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sub = threadIdx.x / STATES;
  const int j = threadIdx.x % STATES;
  const int n = blockIdx.x * ROWS + sub;
  if (n >= a.N) return;  // the row's 16 lanes leave together
  const int goff = (threadIdx.x & 31) & ~(STATES - 1);
  const unsigned mask = 0xFFFFu << goff;
  const int R = a.R;
  uint8_t* qv_row = a.qv + (long long)n * R;

  const int* st = a.stats + (long long)n * a.S;
  const int score = st[0];
  if (score <= 0 || score < a.thresh[n]) {
    for (int i = j; i < R; i += STATES) qv_row[i] = 0;
    if (j == 0) a.posterior[n] = 0.0;
    return;
  }
  const int rs = st[1], gs = st[2], ops_len = st[9];
  const int r = a.rid[n];
  const int8_t* colours = a.colours + (long long)r * a.RC;
  const uint8_t* qual = a.qual + (long long)r * a.Q + a.qoff;
  const bool use_q = a.has_qual[r] != 0;
  const int initbp = a.initbp[r];
  const uint8_t* ops = a.ops + (long long)n * a.T;
  const int8_t* window = a.genome + (long long)n * a.G;
  const int8_t* qr4 = a.qr4 + (long long)n * 4 * R;

  unsigned char* mine =
      a.scratch ? a.scratch + (long long)n * row_bytes(R)
                : smem + (long long)sub * row_bytes(R);
  double* F = reinterpret_cast<double*>(mine);
  double* fscale = F + (long long)R * STATES;
  unsigned* desc = reinterpret_cast<unsigned*>(fscale + R);

  // the clipped prefix: an N anywhere forces the first column, else its
  // colours XOR into it and its least quality byte stands in for the first
  bool bad = false;
  int x = 0, mn = 10000;
  for (int p = j; p < rs; p += STATES) {
    const int c = colours[p];
    bad |= c < 0 || c > 3;
    x ^= c;
    if (use_q) mn = min(mn, (int)qual[p]);
  }
  bad = __ballot_sync(mask, bad) != 0;
#pragma unroll
  for (int o = 8; o; o >>= 1) {
    x ^= __shfl_xor_sync(mask, x, o, STATES);
    mn = min(mn, __shfl_xor_sync(mask, mn, o, STATES));
  }
  const int start_run = bad ? BASE_N : x;

  // the columns, a chunk of 16 ops at a time
  int g_before = 0, L = 0;
  const unsigned below = (1u << j) - 1;
  for (int base = 0; base < ops_len; base += STATES) {
    const int t = base + j;
    const bool valid = t < ops_len;
    const int op = valid ? ops[t] : 0;
    const int typ = op & 3;
    const bool cg = valid && typ != OP_DEL;
    const bool cr = valid && typ != OP_INS;
    const unsigned bg = (__ballot_sync(mask, cg) >> goff) & 0xFFFFu;
    const unsigned br = (__ballot_sync(mask, cr) >> goff) & 0xFFFFu;
    if (cr) {
      const int c_i = L + __popc(br & below);
      const int gi = min(gs + g_before + __popc(bg & below), a.G - 1);
      const int ri = min(rs + c_i, R - 1);
      const int k = (op >> 2) & 3;
      const bool has_let = typ == OP_MATCH;
      const int gcode = (int)window[gi] & 15;
      const int let = has_let ? (gcode <= 3 ? gcode : BASE_N) : 0;
      int qcode = (int)qr4[k * R + ri] & 15;
      if (has_let && qcode == 15) qcode = gcode;
      const int bcall = qcode <= 3 ? qcode : BASE_N;
      const int rp = rs + c_i;
      const int c = colours[rp];
      const bool first = c_i == 0;
      const bool forced = (first && start_run == BASE_N) || c == BASE_N;
      const int col = forced ? 0 : (first ? (c ^ start_run) : c);
      int cls;
      if (forced) {
        cls = FORCED;
      } else if (!use_q) {
        cls = NO_QUAL;
      } else {
        const int qb = qual[rp];
        cls = first ? min(mn, qb) : qb;
      }
      desc[c_i] = pack(let, has_let, col & 15, cls, bcall);
    }
    g_before += __popc(bg);
    L += __popc(br);
  }
  __syncwarp(mask);

  const int left = j >> 2, right = j & 3;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);

  // forwards (do_forwards, sw-post.c:322-366)
  double f = left == initbp ? node_prior(a, desc[0], j) : inf;
  double fs = group_min(f, mask);
  f = f - fs;
  F[j] = f;
  if (j == 0) fscale[0] = fs;
  for (int i = 1; i < L; ++i) {
    const double e = exp(-f);
    double s = __shfl_sync(mask, e, left, STATES);
    s = s + __shfl_sync(mask, e, left + 4, STATES);
    s = s + __shfl_sync(mask, e, left + 8, STATES);
    s = s + __shfl_sync(mask, e, left + 12, STATES);
    const double row = node_prior(a, desc[i], j) - log(s);
    const double sc = group_min(row, mask);
    f = row - sc;
    fs = sc + fs;
    F[(long long)i * STATES + j] = f;
    if (j == 0) fscale[i] = fs;
  }
  const double ef = exp(-f);
  double tot = __shfl_sync(mask, ef, 0, STATES);
#pragma unroll
  for (int u = 1; u < STATES; ++u)
    tot = tot + __shfl_sync(mask, ef, u, STATES);
  const double total = -log(tot) + fs;

  // get_posterior (sw-post.c:575-597): the gap priors in alignment order
  double res = exp(-total);
  int prev = -1;
  for (int base = 0; base < ops_len; base += STATES) {
    const int t = base + j;
    const int typ = t < ops_len ? (ops[t] & 3) : -1;
    const int m = min(STATES, ops_len - base);
    for (int u = 0; u < m; ++u) {
      const int ty = __shfl_sync(mask, typ, u, STATES);
      if (ty == OP_DEL) {
        res = res * a.ins_ext;
        if (prev != OP_DEL) res = res * a.ins_open;
      } else if (ty == OP_INS) {
        res = res * a.del_ext;
        if (prev != OP_INS) res = res * a.del_open;
      }
      prev = ty;
    }
  }
  if (j == 0) a.posterior[n] = res;
  __syncwarp(mask);

  // backwards (do_backwards, sw-post.c:270-320) with each column's letter
  // posterior and quality (post_traceback, sw-post.c:183-208)
  double b = 0.0, bs = 0.0;
  for (int i = L - 1; i >= 0; --i) {
    if (i < L - 1) {
      const double e = exp(-(node_prior(a, desc[i + 1], j) + b));
      double s = __shfl_sync(mask, e, right * 4, STATES);
      s = s + __shfl_sync(mask, e, right * 4 + 1, STATES);
      s = s + __shfl_sync(mask, e, right * 4 + 2, STATES);
      s = s + __shfl_sync(mask, e, right * 4 + 3, STATES);
      const double row = -log(s);
      const double sc = group_min(row, mask);
      b = row - sc;
      bs = sc + bs;
    }
    const double w =
        exp(-((((F[(long long)i * STATES + j] + b) + fscale[i]) + bs) -
              total));
    const int bcall = (desc[i] >> 18) & 15;
    const int bc = min(bcall, 3);
    double post = __shfl_sync(mask, w, bc, STATES);
    post = post + __shfl_sync(mask, w, bc + 4, STATES);
    post = post + __shfl_sync(mask, w, bc + 8, STATES);
    post = post + __shfl_sync(mask, w, bc + 12, STATES);
    if (j == 0) {
      const double pr_err = 1 - post;
      int q;
      if (pr_err > 0.99999999)
        q = 0;
      else if (pr_err < 1e-25)
        q = 250;
      else
        q = (int)trunc(__dmul_rn(-10.0, log(fmax(pr_err, 1e-300))) / a.ln10);
      if (bcall == BASE_N) q = 0;
      qv_row[i] = (uint8_t)min(q, 40);
    }
  }
  for (int i = L + j; i < R; i += STATES) qv_row[i] = 0;
}

bool staged(int R) { return ROWS * row_bytes(R) <= STAGED_MAX_BYTES; }

}  // namespace

// The launcher's shape for reads of R columns: out[0] 1 when a block's
// rows keep their sweeps in shared memory, out[1] the global scratch bytes
// a row needs otherwise (0 when staged).  Returns 0.
extern "C" int post_sw_plan(int R, int* out) {
  out[0] = staged(R) ? 1 : 0;
  out[1] = staged(R) ? 0 : (int)row_bytes(R);
  return 0;
}

// The posterior of N pass-2 rows (see ops/post_sw.py::post_sw_packed for
// the tensors); scratch is [N, plan's scratch_per_row] bytes, or unused.
// Runs on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int post_sw_launch(
    const void* ops, const void* stats, const void* genome, const void* qr4,
    const void* rid, const void* thresh, const void* colours,
    const void* qual, const void* has_qual, const void* initbp,
    const void* table, int N, int T, int S, int G, int R, int RC, int Q,
    int qoff, double ins_open, double ins_ext, double del_open,
    double del_ext, double ln10, void* scratch, void* posterior, void* qv,
    void* stream) {
  if (N <= 0) return 0;
  const bool in_smem = staged(R);
  Args a{(const uint8_t*)ops, (const int*)stats, (const int8_t*)genome,
         (const int8_t*)qr4, (const int*)rid, (const int*)thresh,
         (const int8_t*)colours, (const uint8_t*)qual,
         (const uint8_t*)has_qual, (const int8_t*)initbp,
         (const double*)table, N, T, S, G, R, RC, Q, qoff, ins_open, ins_ext,
         del_open, del_ext, ln10, in_smem ? nullptr : (uint8_t*)scratch,
         (double*)posterior, (uint8_t*)qv};
  const size_t shmem = in_smem ? (size_t)(ROWS * row_bytes(R)) : 0;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        post_sw_fwbw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  post_sw_fwbw_kernel<<<(N + ROWS - 1) / ROWS, THREADS, shmem,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* shrimp_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
