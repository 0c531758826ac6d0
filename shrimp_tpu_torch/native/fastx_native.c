/*
 * fastx_native — bulk FASTQ/FASTA record indexer (native IO layer).
 *
 * The reference's reader is C with a hand-rolled 8MB buffer
 * (common/fasta.c:60-120); this is its counterpart for the TPU build:
 * one pass over an in-memory file image produces per-record field spans
 * that Python slices lazily, so the hot read-intake path does no per-line
 * Python work.
 *
 * Exposed C ABI (ctypes):
 *   fastx_count_records(buf, len, is_fastq)            -> record count
 *   fastx_index_fastq(buf, len, spans, cap)            -> records written
 *       spans: int64[cap][6] = (name_s, name_e, seq_s, seq_e, qual_s, qual_e)
 *   fastx_index_fasta(buf, len, spans, cap)            -> records written
 *       spans: int64[cap][4] = (name_s, name_e, seq_s, seq_e); sequences may
 *       span lines — seq_e marks the record end and Python strips newlines.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const char *find_nl(const char *p, const char *end)
{
    const char *nl = memchr(p, '\n', (size_t)(end - p));
    return nl ? nl : end;
}

long long fastx_count_records(const char *buf, long long len, int is_fastq)
{
    const char *p = buf, *end = buf + len;
    long long n = 0;
    char mark = is_fastq ? '@' : '>';
    while (p < end) {
        if (*p == mark) {
            n++;
            if (is_fastq) {
                /* skip 4 lines */
                int i;
                for (i = 0; i < 4 && p < end; i++)
                    p = find_nl(p, end) + 1;
                continue;
            }
        }
        p = find_nl(p, end) + 1;
    }
    return n;
}

long long fastx_index_fastq(const char *buf, long long len,
                            long long *spans, long long cap)
{
    const char *p = buf, *end = buf + len;
    long long n = 0;
    while (p < end && n < cap) {
        while (p < end && (*p == '\n' || *p == '\r'))
            p++;
        if (p >= end)
            break;
        if (*p != '@')
            return -1;              /* malformed; caller falls back */
        const char *name_s = p + 1;
        const char *nl = find_nl(p, end);
        const char *name_e = nl;
        const char *sp = memchr(name_s, ' ', (size_t)(name_e - name_s));
        const char *tb = memchr(name_s, '\t', (size_t)(name_e - name_s));
        if (sp && (!tb || sp < tb))
            name_e = sp;
        else if (tb)
            name_e = tb;
        if (name_e > name_s && name_e[-1] == '\r')
            name_e--;

        const char *seq_s = nl + 1;
        if (seq_s >= end)
            break;                  /* record truncated at buffer end */
        nl = find_nl(seq_s, end);
        const char *seq_e = nl;
        if (seq_e > seq_s && seq_e[-1] == '\r')
            seq_e--;

        const char *plus = nl + 1;
        if (plus >= end)
            break;                  /* record truncated at buffer end */
        if (*plus != '+')
            return -1;              /* multi-line fastq: fall back */
        nl = find_nl(plus, end);

        const char *qual_s = nl + 1;
        if (qual_s > end)
            qual_s = end;
        nl = find_nl(qual_s, end);
        const char *qual_e = nl;
        if (qual_e > qual_s && qual_e[-1] == '\r')
            qual_e--;

        spans[n * 6 + 0] = name_s - buf;
        spans[n * 6 + 1] = name_e - buf;
        spans[n * 6 + 2] = seq_s - buf;
        spans[n * 6 + 3] = seq_e - buf;
        spans[n * 6 + 4] = qual_s - buf;
        spans[n * 6 + 5] = qual_e - buf;
        n++;
        p = nl + 1;
    }
    return n;
}

long long fastx_index_fasta(const char *buf, long long len,
                            long long *spans, long long cap)
{
    const char *p = buf, *end = buf + len;
    long long n = 0;
    const char *seq_s = NULL;
    while (p <= end && n <= cap) {
        if (p == end || *p == '>') {
            if (seq_s != NULL) {
                spans[(n - 1) * 4 + 3] = p - buf;
                seq_s = NULL;
            }
            if (p == end)
                break;
            if (n == cap)
                break;
            const char *name_s = p + 1;
            const char *nl = find_nl(p, end);
            const char *name_e = nl;
            const char *sp = memchr(name_s, ' ', (size_t)(name_e - name_s));
            const char *tb = memchr(name_s, '\t', (size_t)(name_e - name_s));
            if (sp && (!tb || sp < tb))
                name_e = sp;
            else if (tb)
                name_e = tb;
            if (name_e > name_s && name_e[-1] == '\r')
                name_e--;
            spans[n * 4 + 0] = name_s - buf;
            spans[n * 4 + 1] = name_e - buf;
            seq_s = nl + 1;
            spans[n * 4 + 2] = seq_s - buf;
            spans[n * 4 + 3] = seq_s - buf;
            n++;
            p = nl + 1;
        } else {
            p = find_nl(p, end) + 1;
        }
        if (p > end)
            p = end;                /* no trailing newline: close record */
    }
    return n;
}

/*
 * Bulk base-code translation: ASCII -> 4-bit codes with newline/whitespace
 * squeeze (fasta_sequence_to_bitfield's translate table, fasta.c:28-58).
 * Returns number of codes written, or -1 on an invalid character.
 */
long long fastx_translate(const char *buf, long long len,
                          const signed char *table, signed char *out)
{
    long long n = 0, i;
    for (i = 0; i < len; i++) {
        unsigned char c = (unsigned char)buf[i];
        if (c == '\n' || c == '\r' || c == ' ' || c == '\t')
            continue;
        signed char v = table[c];
        if (v < 0)
            return -1;
        out[n++] = v;
    }
    return n;
}
