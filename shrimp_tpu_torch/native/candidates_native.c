/*
 * candidates_native — host-side L3 hot loops in C.
 *
 * The NumPy host path's region-count filter sorts all posting keys
 * (np.unique on ~millions of int64) per batch-strand; this replaces it
 * with a dense (read, region) uint16 visit table — O(n) scatter + O(n)
 * lookup, the same data structure the reference uses per read
 * (region_map, gmapper.h:284-295, mapping.c:475-780).
 *
 * Exposed C ABI (ctypes):
 *   region_has2_filter(rid, x, n, region_bits, region_overlap,
 *                      n_regions, n_reads, keep_out) -> 0 ok / -1 alloc
 *     rid: int32[n] (ascending per batch, not required)
 *     x:   int64[n] global positions
 *     keep_out: uint8[n]
 *
 *   expand_postings(lens int64[L], lo int64[L], total,
 *                   out_src int64[total]) -> rows written
 *     CSR expansion: out_src[k] = lo[seg(k)] + (k - start(seg(k))),
 *     replacing np.repeat + cumsum temporaries.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

long long region_has2_filter(const int32_t *rid, const int64_t *x,
                             long long n, int region_bits,
                             int region_overlap, long long n_regions,
                             long long n_reads, uint8_t *table,
                             uint8_t *keep_out)
{
    /* `table` is a caller-owned zeroed workspace (n_reads * n_regions
     * uint8, saturating at 255 — has-2 only needs >= 2); touched cells
     * are re-zeroed before returning so the buffer can be reused
     * without an O(table) clear per call. */
    long long i;
    int64_t mask = ((int64_t)1 << region_bits) - 1;
    for (i = 0; i < n; i++) {
        int64_t reg = x[i] >> region_bits;
        long long k = (long long)rid[i] * n_regions + reg;
        if (table[k] < 0xFF)
            table[k]++;
        if ((x[i] & mask) < region_overlap && reg > 0)
            if (table[k - 1] < 0xFF)
                table[k - 1]++;
    }
    for (i = 0; i < n; i++) {
        int64_t reg = x[i] >> region_bits;
        long long k = (long long)rid[i] * n_regions + reg;
        uint8_t ok = table[k] >= 2;
        if (!ok && (x[i] & mask) < region_overlap && reg > 0)
            ok = table[k - 1] >= 2;
        keep_out[i] = ok;
    }
    for (i = 0; i < n; i++) {         /* clear touched cells only */
        int64_t reg = x[i] >> region_bits;
        long long k = (long long)rid[i] * n_regions + reg;
        table[k] = 0;
        if ((x[i] & mask) < region_overlap && reg > 0)
            table[k - 1] = 0;
    }
    return 0;
}

long long expand_postings(const int64_t *lens, const int64_t *lo,
                          long long n_lists, int64_t *out_src,
                          int64_t *out_seg)
{
    long long i, k = 0;
    for (i = 0; i < n_lists; i++) {
        int64_t j, L = lens[i], base = lo[i];
        for (j = 0; j < L; j++) {
            out_seg[k] = i;
            out_src[k++] = base + j;
        }
    }
    return k;
}

/* Fused expansion: emits x (gathered positions), rid and y directly,
 * replacing three separate fancy-gather passes on the Python side.
 *   positions: uint32[]; rows/kcols: per-list metadata
 *   out_x int64[total], out_rid int32[total], out_y int32[total] */
long long expand_postings_fused(const int64_t *lens, const int64_t *lo,
                                const int32_t *rows, const int32_t *kcols,
                                const int64_t *minpos,
                                long long n_lists,
                                const uint32_t *positions,
                                int64_t *out_x, int32_t *out_rid,
                                int32_t *out_y)
{
    long long i, k = 0;
    for (i = 0; i < n_lists; i++) {
        int64_t j, L = lens[i], base = lo[i];
        int32_t r = rows[i];
        int32_t y = (int32_t)(kcols[i] + minpos[r]);
        for (j = 0; j < L; j++) {
            out_x[k] = (int64_t)positions[base + j];
            out_rid[k] = r;
            out_y[k] = y;
            k++;
        }
    }
    return k;
}

/* Pass-1 window-overlap suppression scan (read_pass1_per_strand,
 * gmapper/mapping.c:1303-1330): sequential per (read, strand) group in
 * hit-list order — a window is suppressed when it overlaps the last
 * window that cleared the threshold by more than window_overlap.
 *   order: int64[n] iteration order (lexsort by (rid, st));
 *   ovl:   int64 per-read abs_or_pct(window_overlap, window_len);
 *   wlen:  int64 per-read window length. */
void pass1_suppress(const int64_t *order, long long n,
                    const int32_t *rid, const int8_t *st,
                    const int32_t *cn, const int64_t *goff,
                    const int64_t *scores, const int64_t *thr,
                    const int64_t *ovl_r, const int64_t *wlen_r,
                    uint8_t *suppressed)
{
    long long i;
    int64_t lg = -1;
    int32_t prev_r = -1;
    int8_t prev_s = -1;
    for (i = 0; i < n; i++) {
        int64_t k = order[i];
        int32_t r = rid[k];
        int8_t s = st[k];
        if (r != prev_r || s != prev_s) {
            lg = -1;
            prev_r = r;
            prev_s = s;
        }
        if (lg >= 0 && cn[k] == cn[lg]
            && goff[k] + ovl_r[r] <= goff[lg] + wlen_r[r]) {
            suppressed[k] = 1;
            continue;
        }
        suppressed[k] = 0;
        if (scores[k] >= thr[k])
            lg = k;
    }
}

/* Paired-fallback variant (the unpaired rounds of handle_readpair,
 * mapping.c:1299-1356 with saved paired hits): rows flagged `saved`
 * become last_good unconditionally and are never suppressed; rows with
 * upd == 0 (score persisted from a paired round) skip the last_good
 * update.  Replaces a ~1M-iteration Python scan per strand. */
void pass1_suppress_flags(const int64_t *order, long long n,
                          const int32_t *rid, const int8_t *st,
                          const int32_t *cn, const int64_t *goff,
                          const int64_t *scores, const int64_t *thr,
                          const int64_t *ovl_r, const int64_t *wlen_r,
                          const uint8_t *saved, const uint8_t *upd,
                          uint8_t *suppressed)
{
    long long i;
    int64_t lg = -1;
    int32_t prev_r = -1;
    int8_t prev_s = -1;
    for (i = 0; i < n; i++) {
        int64_t k = order[i];
        int32_t r = rid[k];
        int8_t s = st[k];
        if (r != prev_r || s != prev_s) {
            lg = -1;
            prev_r = r;
            prev_s = s;
        }
        if (saved[k]) {
            suppressed[k] = 0;
            lg = k;
            continue;
        }
        if (lg >= 0 && cn[k] == cn[lg]
            && goff[k] + ovl_r[r] <= goff[lg] + wlen_r[r]) {
            suppressed[k] = 1;
            continue;
        }
        /* write 0 on every non-suppressed path so the routine is
         * self-contained even if the caller reuses the output buffer */
        suppressed[k] = 0;
        if (!upd[k])
            continue;
        if (scores[k] >= thr[k])
            lg = k;
    }
}


/* ------------------------------------------------------------------ *
 * Fused anchor-list construction (read_get_anchor_list_per_strand,
 * gmapper/mapping.c:877-1015): filter postings by a keep mask, stable
 * sort by (rid, x), collapse colinear same-diagonal anchors with the
 * reference's per-slot anchor cache (diag % rlen slots — the exact
 * semantics of the NumPy (rid, slot)-grouped run collapse and of
 * mapping.c:997-1013), and resolve contig numbers with a forward-moving
 * offset pointer.  Replaces two 13M-row argsorts plus ~8 fancy-gather
 * passes on the NumPy side with one C pass.
 *
 * Sort: stable LSD radix on key = rid << shift | x (16-bit digits,
 * shift = bits(max_x), pass count adapted to the key width) — matches
 * np.argsort(..., kind="stable") on the same combined key.
 *
 * Returns n_out (anchor rows written) or -1 on alloc failure.
 * Thread-safe: all workspace is thread-local (the -N worker pool calls
 * with the GIL released); the collapse cache epoch is monotonic across
 * calls so no clearing is ever needed.
 */

typedef struct {
    uint64_t key;                   /* rid << shift | x */
    int32_t y;
    int32_t ln;
} anch_rec;

static __thread anch_rec *tls_a = 0, *tls_b = 0;
static __thread long long tls_cap = 0;
static __thread int64_t *tls_slot_diag = 0, *tls_slot_epoch = 0,
                        *tls_slot_out = 0;
static __thread int32_t *tls_slot_cn = 0;
static __thread long long tls_slot_cap = 0;
static __thread int64_t tls_epoch = 0;
static __thread int64_t radix_counts[65536];

static int ensure_record_cap(long long n)
{
    if (tls_cap >= n)
        return 0;
    free(tls_a);
    free(tls_b);
    tls_cap = n + n / 4;
    tls_a = (anch_rec *)malloc((size_t)tls_cap * sizeof(anch_rec));
    tls_b = (anch_rec *)malloc((size_t)tls_cap * sizeof(anch_rec));
    if (!tls_a || !tls_b) {
        free(tls_a); free(tls_b);
        tls_a = tls_b = 0; tls_cap = 0;
        return -1;
    }
    return 0;
}

static int ensure_slot_cap(long long max_rlen)
{
    if (tls_slot_cap >= max_rlen)
        return 0;
    free(tls_slot_diag); free(tls_slot_epoch);
    free(tls_slot_out); free(tls_slot_cn);
    tls_slot_cap = max_rlen;
    tls_slot_diag = (int64_t *)calloc(max_rlen, sizeof(int64_t));
    tls_slot_epoch = (int64_t *)calloc(max_rlen, sizeof(int64_t));
    tls_slot_out = (int64_t *)calloc(max_rlen, sizeof(int64_t));
    tls_slot_cn = (int32_t *)calloc(max_rlen, sizeof(int32_t));
    if (!tls_slot_diag || !tls_slot_epoch || !tls_slot_out
        || !tls_slot_cn) {
        free(tls_slot_diag); free(tls_slot_epoch);
        free(tls_slot_out); free(tls_slot_cn);
        tls_slot_diag = tls_slot_epoch = tls_slot_out = 0;
        tls_slot_cn = 0;
        tls_slot_cap = 0;
        return -1;
    }
    tls_epoch = 0;
    return 0;
}

/* Stable LSD radix sort of tls_a[0..m) by key (16-bit digits, pass
 * count adapted to the key width) — matches np.argsort(kind="stable")
 * on the same combined key.  Sorted data ends in tls_a. */
static void radix_sort_records(long long m, uint64_t max_key)
{
    long long i;
    int passes = 1, p;
    while (passes < 4 && (max_key >> (16 * passes)) != 0)
        passes++;
    {
        anch_rec *src = tls_a, *dst = tls_b, *tmp;
        for (p = 0; p < passes; p++) {
            int sh = 16 * p;
            memset(radix_counts, 0, sizeof(radix_counts));
            for (i = 0; i < m; i++)
                radix_counts[(src[i].key >> sh) & 0xFFFF]++;
            {
                int64_t acc = 0, c;
                int d;
                for (d = 0; d < 65536; d++) {
                    c = radix_counts[d];
                    radix_counts[d] = acc;
                    acc += c;
                }
            }
            for (i = 0; i < m; i++)
                dst[radix_counts[(src[i].key >> sh) & 0xFFFF]++] = src[i];
            tmp = src; src = dst; dst = tmp;
        }
        if (src != tls_a)
            memcpy(tls_a, src, (size_t)m * sizeof(anch_rec));
    }
}

/* The slot-cache collapse walk over sorted tls_a[0..m) (semantics of
 * the NumPy (rid, slot)-grouped run collapse and mapping.c:997-1013).
 * Returns n_out. */
static long long collapse_walk(
    long long m, int shift,
    const int64_t *rlen,
    const int64_t *contig_offsets, long long n_contigs,
    int collapse,
    int32_t *out_rid, int64_t *out_x, int32_t *out_y,
    int32_t *out_ln, int32_t *out_wt, int32_t *out_cn)
{
    long long i, n_out = 0;
    int64_t cur_key_rid = -1;
    int64_t R = 1, cp = 0;
    uint64_t xmask = ((uint64_t)1 << shift) - 1;
    for (i = 0; i < m; i++) {
        int64_t xi = (int64_t)(tls_a[i].key & xmask);
        int64_t ri = (int64_t)(tls_a[i].key >> shift);
        int32_t yi = tls_a[i].y, li = tls_a[i].ln;
        int64_t diag, slot, ext;
        int32_t cn;
        if (ri != cur_key_rid) {
            cur_key_rid = ri;
            R = rlen[ri];
            if (R < 1)
                R = 1;
            tls_epoch++;
            cp = 0;
        }
        while (cp + 1 < n_contigs && xi >= contig_offsets[cp + 1])
            cp++;
        cn = (int32_t)cp;
        ext = xi + li;
        if (!collapse) {
            out_rid[n_out] = (int32_t)ri; out_x[n_out] = xi;
            out_y[n_out] = yi; out_ln[n_out] = li;
            out_wt[n_out] = 1; out_cn[n_out] = cn;
            n_out++;
            continue;
        }
        diag = xi - yi;
        slot = (xi + R - yi) % R;
        if (tls_slot_epoch[slot] == tls_epoch
            && tls_slot_diag[slot] == diag
            && tls_slot_cn[slot] == cn) {
            int64_t oi = tls_slot_out[slot];
            out_wt[oi]++;
            if (ext > out_x[oi] + out_ln[oi])
                out_ln[oi] = (int32_t)(ext - out_x[oi]);
        } else {
            out_rid[n_out] = (int32_t)ri; out_x[n_out] = xi;
            out_y[n_out] = yi;
            out_ln[n_out] = li;
            out_wt[n_out] = 1; out_cn[n_out] = cn;
            tls_slot_epoch[slot] = tls_epoch;
            tls_slot_diag[slot] = diag;
            tls_slot_cn[slot] = cn;
            tls_slot_out[slot] = n_out;
            n_out++;
        }
    }
    return n_out;
}

long long anchors_from_postings(
    const int32_t *rid, const int64_t *x, const int32_t *y,
    const int32_t *ln, const uint8_t *keep, long long n,
    const int64_t *rlen,            /* int64[n_reads] read lengths */
    long long max_rlen,
    const int64_t *contig_offsets, long long n_contigs,
    int collapse,
    int32_t *out_rid, int64_t *out_x, int32_t *out_y,
    int32_t *out_ln, int32_t *out_wt, int32_t *out_cn)
{
    long long i, m = 0;
    uint64_t max_x = 0, max_key = 0;
    int shift;

    if (n == 0)
        return 0;
    if (ensure_record_cap(n) < 0 || ensure_slot_cap(max_rlen) < 0)
        return -1;

    for (i = 0; i < n; i++)
        if ((keep == 0 || keep[i]) && (uint64_t)x[i] > max_x)
            max_x = (uint64_t)x[i];
    shift = 1;
    while (shift < 62 && (max_x >> shift) != 0)
        shift++;
    for (i = 0; i < n; i++) {
        if (keep && !keep[i])
            continue;
        tls_a[m].key = ((uint64_t)(uint32_t)rid[i] << shift)
                       | (uint64_t)x[i];
        tls_a[m].y = y[i];
        tls_a[m].ln = ln[i];
        if (tls_a[m].key > max_key)
            max_key = tls_a[m].key;
        m++;
    }
    if (m == 0)
        return 0;
    radix_sort_records(m, max_key);
    return collapse_walk(m, shift, rlen, contig_offsets, n_contigs,
                         collapse, out_rid, out_x, out_y, out_ln,
                         out_wt, out_cn);
}

/* ------------------------------------------------------------------ *
 * Fully fused L3: CSR posting-list expansion + has-2 region-count
 * pruning + stable (rid, x) sort + slot-cache collapse in one call —
 * the whole of read_get_region_counts + read_get_anchor_list_per_strand
 * (mapping.c:475-1015) without materializing any intermediate arrays
 * on the Python side.
 *
 * Region pruning (region_has2_filter semantics, exactly): each entry
 * visits its region (x >> region_bits), and also the previous region
 * when x lies within region_overlap of the region start; an entry
 * survives iff its own region has >= 2 visits, or (near the start,
 * reg > 0) the previous region has >= 2 visits.  Because records are
 * sorted by (rid, x) BEFORE filtering, visit counts reduce to a linear
 * group scan: count(reg) = n(reg) + p(reg+1), where n is the group
 * size and p the group's near-start prefix length — no (read, region)
 * table, no random memory traffic (the table walk was the hot spot).
 *
 * Lists are described per (read, kmer, seed):
 *   fl[i]      posting count (0 after list_cutoff truncation)
 *   base[i]    CSR start offset into positions[seedno[i]]
 *   rows[i]    read id
 *   kcols[i]   kmer column (y = kcols + minpos[row])
 *   spans[i]   seed span (anchor length)
 * Returns n_out or -1 on alloc failure.
 */

typedef struct {
    uint64_t gkey;                  /* key >> region_bits: (rid, reg) */
    int32_t n;                      /* entries in group */
    int32_t p;                      /* near-start prefix length */
} reg_group;

long long anchors_from_csr(
    const int64_t *fl, const int64_t *base, const int32_t *rows,
    const int32_t *kcols, const int32_t *spans, const int32_t *seedno,
    long long n_lists, long long total,
    const int64_t *minpos,
    const uint32_t **positions,
    int use_region, int region_bits, int region_overlap,
    const int64_t *rlen, long long max_rlen,
    const int64_t *contig_offsets, long long n_contigs,
    int collapse, int shift,
    int32_t *out_rid, int64_t *out_x, int32_t *out_y,
    int32_t *out_ln, int32_t *out_wt, int32_t *out_cn)
{
    long long i, m = 0;
    uint64_t max_key = 0;
    int64_t rmask = ((int64_t)1 << region_bits) - 1;
    uint64_t xmask = ((uint64_t)1 << shift) - 1;

    if (total == 0)
        return 0;
    if (ensure_record_cap(total) < 0 || ensure_slot_cap(max_rlen) < 0)
        return -1;

    /* pass 1: expand */
    for (i = 0; i < n_lists; i++) {
        int64_t j, L = fl[i], b = base[i];
        const uint32_t *pos = positions[seedno[i]];
        int32_t r = rows[i];
        int32_t y = (int32_t)(kcols[i] + minpos[r]);
        int32_t ln = spans[i];
        uint64_t rk = (uint64_t)(uint32_t)r << shift;
        for (j = 0; j < L; j++) {
            uint64_t key = rk | (uint64_t)pos[b + j];
            tls_a[m].key = key;
            tls_a[m].y = y;
            tls_a[m].ln = ln;
            if (key > max_key)
                max_key = key;
            m++;
        }
    }

    radix_sort_records(m, max_key);

    if (use_region && m > 0) {
        /* group scan over sorted records; tls_b is free after the sort
         * and holds the per-(rid, region) group table */
        reg_group *grp = (reg_group *)tls_b;
        long long ng = 0, w = 0, g = 0;
        uint64_t ridshift = (uint64_t)(shift - region_bits);
        for (i = 0; i < m; i++) {
            uint64_t gkey = tls_a[i].key >> region_bits;
            if (ng == 0 || grp[ng - 1].gkey != gkey) {
                grp[ng].gkey = gkey;
                grp[ng].n = 0;
                grp[ng].p = 0;
                ng++;
            }
            grp[ng - 1].n++;
            if (((int64_t)(tls_a[i].key & xmask) & rmask) < region_overlap
                && grp[ng - 1].p == grp[ng - 1].n - 1)
                grp[ng - 1].p++;
        }
        /* compact survivors (order preserved) */
        for (i = 0; i < m; i++) {
            uint64_t gkey = tls_a[i].key >> region_bits;
            int64_t x, off, reg;
            int64_t cnt, keepit;
            while (grp[g].gkey != gkey)
                g++;
            x = (int64_t)(tls_a[i].key & xmask);
            off = x & rmask;
            reg = x >> region_bits;
            cnt = grp[g].n;
            if (g + 1 < ng && grp[g + 1].gkey == gkey + 1
                && (grp[g + 1].gkey >> ridshift) == (gkey >> ridshift))
                cnt += grp[g + 1].p;
            keepit = cnt >= 2;
            if (!keepit && off < region_overlap && reg > 0) {
                /* count for reg - 1: its own entries + this group's
                 * near-start prefix (which also visits reg - 1) */
                int64_t pcnt = grp[g].p;
                if (g > 0 && grp[g - 1].gkey == gkey - 1
                    && (grp[g - 1].gkey >> ridshift) == (gkey >> ridshift))
                    pcnt += grp[g - 1].n;
                keepit = pcnt >= 2;
            }
            if (keepit)
                tls_a[w++] = tls_a[i];
        }
        m = w;
    }
    if (m == 0)
        return 0;
    return collapse_walk(m, shift, rlen, contig_offsets, n_contigs,
                         collapse, out_rid, out_x, out_y, out_ln,
                         out_wt, out_cn);
}

/* ------------------------------------------------------------------ */
/* Fused CMW generation (read_get_hit_list_per_strand,
 * gmapper/mapping.c:1052-1260): for each anchor, the backward scan over
 * in-window predecessors with the optimistic 2-anchor + 1-gap score
 * (mapping.c:1104-1177), threshold emission, window placement, and the
 * anchor join (anchors.c) — one sequential pass over the (rid, x)-sorted
 * anchor stream in place of the NumPy k-stepped masked loop.
 * Outputs are unsorted (caller applies the (rid, cn, g_off) lexsort).
 * Returns the emitted hit count. */

static int64_t fdiv2(int64_t v)
{
    return v >= 0 ? v / 2 : -((-v + 1) / 2);
}

long long hit_list_from_anchors(
    const int32_t *rid, const int8_t *st, const int64_t *x,
    const int32_t *y, const int32_t *ln, const int32_t *wt,
    const int32_t *cn, const uint8_t *heavy, long long n,
    const int64_t *rlen_per_read, const int64_t *wlen_per_read,
    const int64_t *contig_offsets, const int64_t *contig_len,
    int match, int b_gap_open, int b_gap_extend,
    double threshold, int gapless, int match_mode,
    int32_t *o_rid, int8_t *o_st, int32_t *o_cn, int64_t *o_goff,
    int32_t *o_wlen, int32_t *o_swg, int32_t *o_matches, int32_t *o_smax,
    int64_t *o_ax, int64_t *o_ay, int32_t *o_alen, int32_t *o_awid)
{
    long long i, n_out = 0;
    for (i = 0; i < n; i++) {
        int64_t R = rlen_per_read[rid[i]];
        int64_t wcfg = wlen_per_read[rid[i]];
        int64_t coff = contig_offsets[cn[i]];
        int64_t clen = contig_len[cn[i]];
        int64_t w_len = wcfg < clen ? wcfg : clen;
        int64_t gend, gstart, floor_x;
        int64_t ms;                   /* running optimistic max score */
        long long mi = i;             /* paired predecessor index */
        long long j;

        ms = (int64_t)ln[i] * match;
        if (!gapless) {
            if (match_mode == 2 && wt[i] == 1)
                ms = -1;
            else if (match_mode == 3 && heavy && wt[i] == 1 && !heavy[i])
                ms = -1;
        }

        if (!gapless) {
            gend = (x[i] - coff) + R - 1 - y[i];
            if (gend > clen - 1)
                gend = clen - 1;
            gstart = gend >= wcfg ? gend - wcfg : 0;
            floor_x = coff + gstart;
            for (j = i - 1; j >= 0 && rid[j] == rid[i]
                 && x[j] >= floor_x; j--) {
                int64_t dx, dy, li_, short_len, long_len, tmp;
                if (y[j] >= y[i])
                    continue;
                dx = x[i] - x[j];
                dy = (int64_t)y[i] - y[j];
                li_ = ln[i];
                if (dx - dy > 0) {        /* deletion in read */
                    short_len = dy + li_;
                    long_len = dx + li_;
                } else {
                    short_len = dx + li_;
                    long_len = dy + li_;
                }
                tmp = short_len * match;
                if (long_len > short_len)
                    tmp += b_gap_open
                        + (long_len - short_len) * b_gap_extend;
                if (tmp > ms) {
                    ms = tmp;
                    mi = j;
                }
            }
        }

        {
            int64_t base = (R < w_len ? R : w_len) * match;
            int64_t thr = threshold >= 0.0
                ? (int64_t)((double)base * (threshold / 100.0))
                : (int64_t)(-threshold);
            int emit;
            if (gapless || match_mode == 1)
                emit = 1;
            else {
                emit = ms >= thr;
                if (match_mode == 3 && heavy && heavy[i])
                    emit = 1;
            }
            if (!emit)
                continue;

            {
                int64_t x_len = (x[i] - x[mi]) + ln[i];
                int64_t half = fdiv2(wcfg - x_len);
                int64_t goff = half < x[mi] - coff
                    ? (x[mi] - coff) - half : 0;
                int64_t xi, yi, li_, xj, yj, lj;
                int64_t ax, ay, alen, awid;
                int has_pair = mi < i;
                if (goff + w_len > clen)
                    goff = clen - w_len;
                xi = x[i] - coff - goff; yi = y[i]; li_ = ln[i];
                xj = x[mi] - coff - goff; yj = y[mi]; lj = ln[mi];
                if (has_pair) {
                    int64_t nw, sw, ne, se;
                    int64_t a1 = xi + yi, a2 = xj + yj;
                    int64_t d1 = xi - yi, d2 = xj - yj;
                    int64_t e1 = a1 + 2 * (li_ - 1), e2 = a2 + 2 * (lj - 1);
                    nw = a1 < a2 ? a1 : a2;
                    sw = d1 < d2 ? d1 : d2;
                    ne = d1 > d2 ? d1 : d2;
                    se = e1 > e2 ? e1 : e2;
                    if ((nw + sw) & 1)
                        nw -= 1;
                    ax = (nw + sw) / 2;
                    ay = nw - ax;
                    if ((ne - sw) & 1)
                        ne += 1;
                    awid = (ne - sw) / 2 + 1;
                    if ((se - nw) & 1)
                        se += 1;
                    alen = (se - nw) / 2 + 1;
                } else {
                    ax = xi; ay = yi; alen = li_; awid = 1;
                }
                o_rid[n_out] = rid[i];
                o_st[n_out] = st[i];
                o_cn[n_out] = cn[i];
                o_goff[n_out] = goff;
                o_wlen[n_out] = (int32_t)w_len;
                o_swg[n_out] = (int32_t)ms;
                o_matches[n_out] = has_pair ? wt[i] + wt[mi] : wt[i];
                o_smax[n_out] = (int32_t)base;
                o_ax[n_out] = ax;
                o_ay[n_out] = ay;
                o_alen[n_out] = (int32_t)alen;
                o_awid[n_out] = (int32_t)awid;
                n_out++;
            }
        }
    }
    return n_out;
}

/* ------------------------------------------------------------------ *
 * Read-major fused L3 (anchors_from_csr_rm): the same expansion +
 * has-2 region pruning + stable sort + collapse, but processed one
 * READ at a time.  Lists arrive grouped by read (any seed order inside
 * a read, matching the global expansion's per-read tie order), so each
 * read's ~10^4-10^6 postings are expanded, sorted (8-bit LSD radix on
 * the 32-bit genome position — in L2, no DRAM scatter), pruned,
 * collapsed, and appended to the output in one cache-resident pass.
 * Byte-identical to anchors_from_csr: a global stable (rid, x) sort of
 * rid-grouped input == concatenated per-read stable x sorts.
 * Requires total genome length < 2^32 (caller guards). */

typedef struct {
    uint32_t x;
    int32_t y;
    int32_t ln;
} rm_rec;

static __thread rm_rec *rm_a = 0, *rm_b = 0;
static __thread long long rm_cap = 0;


static int rm_ensure(long long n)
{
    if (rm_cap >= n)
        return 0;
    free(rm_a);
    free(rm_b);
    rm_cap = n + n / 4 + 64;
    rm_a = (rm_rec *)malloc((size_t)rm_cap * sizeof(rm_rec));
    /* rm_b doubles as the radix tmp (rm_rec) AND the per-read region
     * group table (reg_group, 16B > 12B) — size it for the larger */
    rm_b = (rm_rec *)malloc((size_t)rm_cap * sizeof(reg_group));
    if (!rm_a || !rm_b) {
        free(rm_a); free(rm_b);
        rm_a = rm_b = 0; rm_cap = 0;
        return -1;
    }
    return 0;
}

/* 11-bit LSD radix: 3 passes cover any 32-bit genome position (the
 * 8-bit form needed 4); the 2048-entry count table is still L1-sized. */
#define RM_DIG_BITS 11
#define RM_DIG ((1 << RM_DIG_BITS))

static void rm_sort(long long m, uint32_t max_x)
{
    int64_t counts[RM_DIG];
    /* small reads: 8-bit digits keep the count-table memset cheap */
    int bits = m >= 4096 ? RM_DIG_BITS : 8;
    int ndig = 1 << bits, max_p = bits == 8 ? 4 : 3;
    int passes = 1, p;
    long long i;
    rm_rec *src = rm_a, *dst = rm_b, *tmp;
    while (passes < max_p && (max_x >> (bits * passes)) != 0)
        passes++;
    for (p = 0; p < passes; p++) {
        int sh = bits * p;
        memset(counts, 0, (size_t)ndig * sizeof(int64_t));
        for (i = 0; i < m; i++)
            counts[(src[i].x >> sh) & (ndig - 1)]++;
        {
            int64_t acc = 0, c;
            int d;
            for (d = 0; d < ndig; d++) {
                c = counts[d];
                counts[d] = acc;
                acc += c;
            }
        }
        for (i = 0; i < m; i++)
            dst[counts[(src[i].x >> sh) & (ndig - 1)]++] = src[i];
        tmp = src; src = dst; dst = tmp;
    }
    if (src != rm_a)
        memcpy(rm_a, src, (size_t)m * sizeof(rm_rec));
}

long long anchors_from_csr_rm(
    const int64_t *fl, const int64_t *base, const int32_t *rows,
    const int32_t *kcols, const int32_t *spans, const int32_t *seedno,
    long long n_lists, long long max_read_total,
    const int64_t *minpos,
    const uint32_t **positions,
    int use_region, int region_bits, int region_overlap,
    const int64_t *rlen, long long max_rlen,
    const int64_t *contig_offsets, long long n_contigs,
    int collapse,
    int32_t *out_rid, int64_t *out_x, int32_t *out_y,
    int32_t *out_ln, int32_t *out_wt, int32_t *out_cn)
{
    long long li = 0, n_out = 0;
    uint32_t rmask = ((uint32_t)1 << region_bits) - 1;

    if (n_lists == 0)
        return 0;
    if (rm_ensure(max_read_total) < 0 || ensure_slot_cap(max_rlen) < 0)
        return -1;

    while (li < n_lists) {
        int32_t r = rows[li];
        long long m = 0, i;
        uint32_t max_x = 0;
        int64_t R = rlen[r];
        int64_t cp = 0;

        /* expand this read's lists */
        for (; li < n_lists && rows[li] == r; li++) {
            int64_t j, L = fl[li], b = base[li];
            const uint32_t *pos = positions[seedno[li]];
            int32_t y = (int32_t)(kcols[li] + minpos[r]);
            int32_t ln = spans[li];
            for (j = 0; j < L; j++) {
                uint32_t xx = pos[b + j];
                rm_a[m].x = xx;
                rm_a[m].y = y;
                rm_a[m].ln = ln;
                if (xx > max_x)
                    max_x = xx;
                m++;
            }
        }
        if (m == 0)
            continue;
        rm_sort(m, max_x);

        if (use_region) {
            /* per-read (region) group scan over sorted x; rm_b is free
             * after the sort and holds the group table.  (A
             * count-before-expand epoch-table variant was measured no
             * faster here: two random accesses per posting into a
             * multi-MB region table cost what the smaller sort saved.) */
            reg_group *grp = (reg_group *)rm_b;
            long long ng = 0, w = 0, g = 0;
            for (i = 0; i < m; i++) {
                uint64_t gkey = rm_a[i].x >> region_bits;
                if (ng == 0 || grp[ng - 1].gkey != gkey) {
                    grp[ng].gkey = gkey;
                    grp[ng].n = 0;
                    grp[ng].p = 0;
                    ng++;
                }
                grp[ng - 1].n++;
                if ((rm_a[i].x & rmask) < (uint32_t)region_overlap
                    && grp[ng - 1].p == grp[ng - 1].n - 1)
                    grp[ng - 1].p++;
            }
            for (i = 0; i < m; i++) {
                uint64_t gkey = rm_a[i].x >> region_bits;
                uint32_t off = rm_a[i].x & rmask;
                int64_t cnt, keepit;
                while (grp[g].gkey != gkey)
                    g++;
                cnt = grp[g].n;
                if (g + 1 < ng && grp[g + 1].gkey == gkey + 1)
                    cnt += grp[g + 1].p;
                keepit = cnt >= 2;
                if (!keepit && off < (uint32_t)region_overlap
                    && gkey > 0) {
                    int64_t pcnt = grp[g].p;
                    if (g > 0 && grp[g - 1].gkey == gkey - 1)
                        pcnt += grp[g - 1].n;
                    keepit = pcnt >= 2;
                }
                if (keepit)
                    rm_a[w++] = rm_a[i];
            }
            m = w;
            if (m == 0)
                continue;
        }

        /* per-read slot-cache collapse + contig resolve (the
         * collapse_walk semantics with a fixed rid) */
        if (R < 1)
            R = 1;
        tls_epoch++;
        for (i = 0; i < m; i++) {
            int64_t xi = (int64_t)rm_a[i].x;
            int32_t yi = rm_a[i].y, li_ = rm_a[i].ln;
            int64_t diag, slot, ext;
            int32_t cn;
            while (cp + 1 < n_contigs && xi >= contig_offsets[cp + 1])
                cp++;
            cn = (int32_t)cp;
            ext = xi + li_;
            if (!collapse) {
                out_rid[n_out] = r; out_x[n_out] = xi;
                out_y[n_out] = yi; out_ln[n_out] = li_;
                out_wt[n_out] = 1; out_cn[n_out] = cn;
                n_out++;
                continue;
            }
            diag = xi - yi;
            slot = (xi + R - yi) % R;
            if (tls_slot_epoch[slot] == tls_epoch
                && tls_slot_diag[slot] == diag
                && tls_slot_cn[slot] == cn) {
                int64_t oi = tls_slot_out[slot];
                out_wt[oi]++;
                if (ext > out_x[oi] + out_ln[oi])
                    out_ln[oi] = (int32_t)(ext - out_x[oi]);
            } else {
                out_rid[n_out] = r; out_x[n_out] = xi;
                out_y[n_out] = yi; out_ln[n_out] = li_;
                out_wt[n_out] = 1; out_cn[n_out] = cn;
                tls_slot_epoch[slot] = tls_epoch;
                tls_slot_diag[slot] = diag;
                tls_slot_cn[slot] = cn;
                tls_slot_out[slot] = n_out;
                n_out++;
            }
        }
    }
    return n_out;
}

/* ------------------------------------------------------------------ *
 * Per-read top-k heap selection (read_get_vector_hits,
 * gmapper/mapping.c:1394-1432; DEF_EXTHEAP insert/replace_min,
 * common/heap.h:226-300).  Exact move-for-move replica of the explicit
 * binary min-heap: the final heap ARRAY order (not just the selected
 * set) feeds pass-2 and breaks all downstream ties, so it must match.
 *
 *   rows:   int64[n] live row indices grouped by read, stream order
 *           within each group;
 *   bounds: int64[n_groups+1] group prefix offsets into rows;
 *   keys:   int64 selection key, indexed by row id;
 *   out:    same layout as rows (group g writes out_n[g] <= K entries
 *           at out + bounds[g]).
 */
static void extheap_insert64(int64_t *a, long long *load, int64_t item,
                             const int64_t *keys)
{
    long long node;
    a[*load] = item;
    (*load)++;
    node = *load;
    while (node > 1 && keys[a[node - 1]] < keys[a[node / 2 - 1]]) {
        int64_t t = a[node - 1];
        a[node - 1] = a[node / 2 - 1];
        a[node / 2 - 1] = t;
        node /= 2;
    }
}

static void extheap_replace_min64(int64_t *a, long long load, int64_t item,
                                  const int64_t *keys)
{
    long long node = 1;
    a[0] = item;
    for (;;) {
        long long left = node * 2, right = left + 1, mn = node;
        if (left <= load && keys[a[left - 1]] < keys[a[mn - 1]])
            mn = left;
        if (right <= load && keys[a[right - 1]] < keys[a[mn - 1]])
            mn = right;
        if (mn == node)
            break;
        {
            int64_t t = a[mn - 1];
            a[mn - 1] = a[node - 1];
            a[node - 1] = t;
        }
        node = mn;
    }
}

long long topk_select_batch(const int64_t *rows, const int64_t *bounds,
                            long long n_groups, const int64_t *keys,
                            long long K, int64_t *out, int64_t *out_n)
{
    long long g;
    int64_t *heap = (int64_t *)malloc((size_t)(K > 0 ? K : 1)
                                      * sizeof(int64_t));
    if (!heap)
        return -1;
    for (g = 0; g < n_groups; g++) {
        long long load = 0, i;
        for (i = bounds[g]; i < bounds[g + 1]; i++) {
            int64_t row = rows[i];
            if (load < K)
                extheap_insert64(heap, &load, row, keys);
            else if (keys[row] > keys[heap[0]])
                extheap_replace_min64(heap, load, row, keys);
        }
        for (i = 0; i < load; i++)
            out[bounds[g] + i] = heap[i];
        out_n[g] = load;
    }
    free(heap);
    return 0;
}
