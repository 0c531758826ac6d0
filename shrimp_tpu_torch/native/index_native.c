/* Native CSR index builder kernels.
 *
 * The reference builds its genomemap with per-kmer realloc'd lists
 * (gmapper/genome.c:1098-1186); the array reformulation here is a
 * counting sort: count keys, prefix-sum into offsets, then scatter each
 * window start to its bucket cursor.  NumPy's stable argsort on 24-bit
 * keys is a mergesort (minutes at Gbp scale); these two linear passes
 * replace it.  OpenMP parallelises the key computation; counting and
 * placement stay sequential (they are memory-bound single passes).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#ifdef __linux__
#include <sys/mman.h>
#endif
#ifdef __SSE2__
#include <emmintrin.h>
#endif

/* mapidx for every window start in [0, n): acc |= (codes[i+ones[k]]&3)<<2k
 * (kmer_to_mapidx_orig, gmapper/gmapper.h:348-366).  Invalid windows
 * (marked in valid[] == 0) get key 0xFFFFFFFF.
 *
 * Loop order is per-pattern-position over a cache-resident block of
 * windows: each inner loop is a unit-stride load/and/shift/or the
 * compiler vectorizes, instead of a 12-way scattered byte gather per
 * window (~6x on the Gbp build). */
void index_mapidx(const int8_t *codes, int64_t n, const int32_t *ones,
                  int32_t w, const uint8_t *valid, uint32_t *out)
{
    const int64_t BLK = (int64_t)1 << 16;   /* 256 KB of out per block */
    for (int64_t b0 = 0; b0 < n; b0 += BLK) {
        int64_t b1 = b0 + BLK < n ? b0 + BLK : n;
        {
            const int8_t *c = codes + ones[0];
            for (int64_t i = b0; i < b1; i++)
                out[i] = (uint32_t)(c[i] & 3);
        }
        for (int32_t k = 1; k < w; k++) {
            const int8_t *c = codes + ones[k];
            uint32_t sh = (uint32_t)(2 * k);
            for (int64_t i = b0; i < b1; i++)
                out[i] |= ((uint32_t)(c[i] & 3)) << sh;
        }
        for (int64_t i = b0; i < b1; i++)
            if (!valid[i])
                out[i] = 0xFFFFFFFFu;
    }
}

/* 64-bit finalizer mix (same as index.py::_mix64) for -H hashed seeds. */
void index_mix64(uint32_t *keys, int64_t n, int32_t hash_bits,
                 const uint8_t *valid)
{
    int64_t i;
    uint64_t mask = (1ull << hash_bits) - 1;
#pragma omp parallel for schedule(static)
    for (i = 0; i < n; i++) {
        if (!valid[i]) continue;
        uint64_t h = keys[i];
        h ^= h >> 33; h *= 0xFF51AFD7ED558CCDull;
        h ^= h >> 33; h *= 0xC4CEB9FE1A85EC53ull;
        h ^= h >> 33;
        keys[i] = (uint32_t)(h & mask);
    }
}

/* Window validity in one rolling pass: no N (code 15) inside the window
 * and the window does not span a contig boundary (genome.c:1104-1127's
 * skip rules).  contig_ends[] are the global end offsets (cumulative). */
void index_valid(const int8_t *codes, int64_t L, int32_t span,
                 const int64_t *contig_ends, int32_t n_contigs,
                 uint8_t *valid)
{
    int64_t nN = 0, i, ci = 0;
    (void)n_contigs;
    for (i = 0; i < span && i < L; i++)
        nN += (codes[i] == 15);
    for (i = 0; i + span <= L; i++) {
        if (i)
            nN += (codes[i + span - 1] == 15) - (codes[i - 1] == 15);
        while (i >= contig_ends[ci])
            ci++;
        valid[i] = (nN == 0) && (i + span <= contig_ends[ci]);
    }
}

/* Partitioned counting sort: one call equivalent to
 * index_count + prefix-sum + index_place, but cache-resident.
 *
 * The flat formulation does ~2 random DRAM accesses per window (a count
 * bump into a 134 MB table, then a scatter into a 4 GB positions array)
 * — ~100 ns each, minutes at Gbp scale.  Here the keys are first
 * partitioned by their high bits into ranges of SUB = 2^14 buckets
 * (pass B writes packed (key,pos) pairs into P sequential streams, which
 * the write-combining buffers keep at DRAM bandwidth), then each
 * partition is counting-sorted against a 128 KB count table that lives
 * in L2 (pass C).  Every pass is a streaming read; output ordering is
 * identical (stable: genome order within each bucket).
 *
 * keys:    uint32[n], 0xFFFFFFFF = invalid (skipped)
 * counts:  int64[nb]  (bucket sizes, written; caller prefix-sums)
 * pairs:   uint64[n]  caller-allocated scratch
 * out:     uint32[m]  sorted window starts (m = return value)
 */
#define SUB_BITS 12

int64_t index_partition_sort(const uint32_t *keys, int64_t n, int64_t nb,
                             int64_t *counts, uint64_t *pairs_unused,
                             uint32_t *out)
{
    (void)pairs_unused;
    const int64_t SUB = (int64_t)1 << SUB_BITS;     /* buckets/partition */
    int64_t P = (nb + SUB - 1) >> SUB_BITS;
    if (P < 1)
        P = 1;
    /* partition starts in the scratch buffer are 8-pair (64 B) aligned
     * so the write-combining flushes below are aligned streaming stores;
     * the scratch is malloc'd here (caller handles -1 = OOM) */
    int64_t *pstart = (int64_t *)malloc((size_t)(P + 1) * sizeof(int64_t));
    int64_t *pcur = (int64_t *)malloc((size_t)P * sizeof(int64_t));
    uint64_t *wc = NULL;
    int64_t *plen = (int64_t *)calloc((size_t)P, sizeof(int64_t));
    uint32_t *sub = (uint32_t *)malloc((size_t)SUB * sizeof(uint32_t));
    uint64_t *pairs = NULL;
    int64_t m = -1, cap, start, gbase;
    if (!pstart || !pcur || !plen || !sub)
        goto done;
    if (posix_memalign((void **)&wc, 64, (size_t)P * 8 * sizeof(uint64_t)))
        { wc = NULL; goto done; }

    /* pass A: partition histogram (cache-resident counters) */
    for (int64_t i = 0; i < n; i++) {
        uint32_t k = keys[i];
        if (k != 0xFFFFFFFFu)
            plen[k >> SUB_BITS]++;
    }
    cap = 0;
    for (int64_t p = 0; p < P; p++) {
        pstart[p] = cap;
        cap += (plen[p] + 7) & ~(int64_t)7;          /* 64 B aligned */
    }
    pstart[P] = cap;
    if (posix_memalign((void **)&pairs, 64,
                       (size_t)(cap ? cap : 1) * sizeof(uint64_t)))
        { pairs = NULL; goto done; }

    /* pass B: scatter (key,pos) pairs through per-partition 64 B
     * write-combining buffers, flushed with non-temporal stores — P
     * concurrent output streams would otherwise turn every 8-byte store
     * into an L1-miss RFO (the first cut of this routine measured no
     * faster than the flat scatter for exactly that reason) */
    memcpy(pcur, pstart, (size_t)P * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        uint32_t k = keys[i];
        if (k == 0xFFFFFFFFu)
            continue;
        int64_t p = k >> SUB_BITS;
        int64_t c = pcur[p]++;
        uint64_t *buf = wc + (p << 3);
        buf[c & 7] = ((uint64_t)k << 32) | (uint64_t)(uint32_t)i;
        if ((c & 7) == 7) {
#ifdef __SSE2__
            uint64_t *dst = pairs + (c - 7);
            _mm_stream_si128((__m128i *)(dst + 0),
                             *(const __m128i *)(buf + 0));
            _mm_stream_si128((__m128i *)(dst + 2),
                             *(const __m128i *)(buf + 2));
            _mm_stream_si128((__m128i *)(dst + 4),
                             *(const __m128i *)(buf + 4));
            _mm_stream_si128((__m128i *)(dst + 6),
                             *(const __m128i *)(buf + 6));
#else
            memcpy(pairs + (c - 7), buf, 64);
#endif
        }
    }
    /* drain partial write-combining buffers */
    for (int64_t p = 0; p < P; p++) {
        int64_t c = pcur[p], r = c & 7;
        uint64_t *buf = wc + (p << 3);
        for (int64_t j = 0; j < r; j++)
            pairs[c - r + j] = buf[j];
    }
#ifdef __SSE2__
    _mm_sfence();
#endif

    /* pass C: per-partition counting sort; sub[] (16 KB) lives in L1
     * and each partition's output range (~4 B * n/P) in L2 */
    m = 0;
    gbase = 0;
    for (int64_t p = 0; p < P; p++) {
        int64_t len = plen[p];
        if (!len)
            continue;
        start = pstart[p];
        int64_t lo_bucket = p << SUB_BITS;
        int64_t nsub = nb - lo_bucket;
        if (nsub > SUB)
            nsub = SUB;
        memset(sub, 0, (size_t)nsub * sizeof(uint32_t));
        for (int64_t i = start; i < start + len; i++)
            sub[(pairs[i] >> 32) & (SUB - 1)]++;
        uint32_t acc = 0;
        for (int64_t b = 0; b < nsub; b++) {
            uint32_t c = sub[b];
            counts[lo_bucket + b] = (int64_t)c;
            sub[b] = acc;
            acc += c;
        }
        uint32_t *outp = out + gbase;
        for (int64_t i = start; i < start + len; i++) {
            uint64_t pr = pairs[i];
            outp[sub[(pr >> 32) & (SUB - 1)]++] = (uint32_t)pr;
        }
        gbase += len;
    }
    m = gbase;
done:
    free(pstart);
    free(pcur);
    free(plen);
    free(sub);
    free(wc);
    free(pairs);
    return m;
}

/* Posting-list trim (trim_genome, genome.c:1188-1207): drop buckets
 * whose list length exceeds cutoff, compacting positions in place-order.
 * Sequential memcpys replace NumPy's np.repeat boolean mask (which
 * materialises a bool per posting — ~50 s at Gbp scale).
 * offsets: int64[nb+1] rewritten in place; returns the new total. */
int64_t index_trim(int64_t *offsets, int64_t nb, const uint32_t *pos_in,
                   uint32_t *pos_out, int64_t cutoff)
{
    int64_t w = 0, prev = offsets[0];
    offsets[0] = 0;
    for (int64_t b = 0; b < nb; b++) {
        int64_t end = offsets[b + 1], len = end - prev;
        if (len > 0 && len <= cutoff) {
            memmove(pos_out + w, pos_in + prev,
                    (size_t)len * sizeof(uint32_t));
            w += len;
        }
        prev = end;
        offsets[b + 1] = w;
    }
    return w;
}

/* counts[key]++ for every valid window (keys 0xFFFFFFFF skipped). */
void index_count(const uint32_t *keys, int64_t n, int64_t *counts)
{
    for (int64_t i = 0; i < n; i++)
        if (keys[i] != 0xFFFFFFFFu)
            counts[keys[i]]++;
}

/* Scatter window starts into their CSR buckets in genome order.
 * cursor[] must be a copy of the exclusive prefix sum of counts; it is
 * consumed.  out[cursor[key]++] = i. */
void index_place(const uint32_t *keys, int64_t n, int64_t *cursor,
                 uint32_t *out)
{
    for (int64_t i = 0; i < n; i++) {
        uint32_t k = keys[i];
        if (k != 0xFFFFFFFFu)
            out[cursor[k]++] = (uint32_t)i;
    }
}
