/* Native host-IO fast path: record framing and 2-bit packing.
 *
 * The batched counterpart of the reference's C input layer (mmap_file /
 * read_line / per-record parsing, normalise_kmers_multi_large.c:394-473).
 * Python drives mmap'd buffers through these batch functions; the numpy
 * implementations in reader.py/pack.py remain as the portable fallback and
 * as the differential-testing oracle.
 *
 * Unlike the reference (one pthread owns one contiguous byte range and walks
 * it line by line, nk.c:394-409,1568), framing here is a two-pass newline
 * index — parallel memchr count, then parallel position fill, then a serial
 * arithmetic pass builds record columns — and packing is a branch-free
 * vectorizable loop split row-wise across threads. Host ingest must sustain
 * multiple GB/s to keep an accelerator fed; per-byte LUT walks cannot.
 *
 * Built as a plain shared object (no pybind11); bound via ctypes.
 */
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#define MAX_IO_THREADS 16

/* ================= 2-bit packing ================= */

/* Branch-free base codec, auto-vectorizable (no table gather):
 *   t = (c >> 1) & 3   maps A->0 C->1 T->2 G->3
 *   t ^= t >> 1        swaps 2<->3: A=0 C=1 G=2 T=3 (the reference's
 *                      base_map order, nk.c:150-153)
 *   N folds to A (replacestr N->A before validation, nk.c:1406).
 * Validity = byte in {A,C,G,T,N}; anything else (incl. lowercase — the
 * reference's LUT is uppercase-only) is the fatal "does not appear to be a
 * DNA sequence" path (nk.c:1418-1419). */
/* Encode len bytes of src into row; returns nonzero if any byte was not
 * A/C/G/T/N. */
static inline int encode_span(const uint8_t *restrict src,
                              uint8_t *restrict row, long long len) {
    long long i = 0;
    int any_bad = 0;
#if defined(__AVX512BW__) && defined(__AVX512VL__)
    /* masked tail: a 150 bp read is 2 full 64-byte lanes + one masked op,
     * no scalar remainder (masked lanes neither load nor fault) */
    __m512i three = _mm512_set1_epi8(3);
    __m512i one = _mm512_set1_epi8(1);
    __m512i vA = _mm512_set1_epi8('A'), vC = _mm512_set1_epi8('C');
    __m512i vG = _mm512_set1_epi8('G'), vT = _mm512_set1_epi8('T');
    __m512i vN = _mm512_set1_epi8('N');
    uint64_t badm = 0;
    for (; i < len; i += 64) {
        long long rem = len - i;
        __mmask64 k = (rem >= 64) ? ~(__mmask64)0
                                  : (((__mmask64)1 << rem) - 1);
        __m512i c = _mm512_maskz_loadu_epi8(k, src + i);
        __m512i t = _mm512_and_si512(_mm512_srli_epi16(c, 1), three);
        t = _mm512_xor_si512(t, _mm512_and_si512(_mm512_srli_epi16(t, 1), one));
        __mmask64 isn = _mm512_cmpeq_epi8_mask(c, vN);
        t = _mm512_maskz_mov_epi8(~isn, t); /* N -> 0 (A) */
        _mm512_mask_storeu_epi8(row + i, k, t);
        __mmask64 ok = _mm512_cmpeq_epi8_mask(c, vA) |
                       _mm512_cmpeq_epi8_mask(c, vC) |
                       _mm512_cmpeq_epi8_mask(c, vG) |
                       _mm512_cmpeq_epi8_mask(c, vT) | isn;
        badm |= (uint64_t)(~ok) & (uint64_t)k;
    }
    return badm != 0;
#elif defined(__AVX2__)
    __m256i three = _mm256_set1_epi8(3);
    __m256i one = _mm256_set1_epi8(1);
    __m256i vA = _mm256_set1_epi8('A'), vC = _mm256_set1_epi8('C');
    __m256i vG = _mm256_set1_epi8('G'), vT = _mm256_set1_epi8('T');
    __m256i vN = _mm256_set1_epi8('N');
    __m256i bad = _mm256_setzero_si256();
    for (; i + 32 <= len; i += 32) {
        __m256i c = _mm256_loadu_si256((const __m256i *)(src + i));
        /* (c>>1)&3 per byte (srli_epi16 leaks the neighbor's bit into bit 7,
         * masked off by &3) -> A0 C1 T2 G3; then t ^= t>>1 swaps 2<->3 */
        __m256i t = _mm256_and_si256(_mm256_srli_epi16(c, 1), three);
        t = _mm256_xor_si256(
            t, _mm256_and_si256(_mm256_srli_epi16(t, 1), one));
        __m256i is_n = _mm256_cmpeq_epi8(c, vN);
        t = _mm256_andnot_si256(is_n, t); /* N -> 0 (A) */
        _mm256_storeu_si256((__m256i *)(row + i), t);
        __m256i ok = _mm256_or_si256(
            _mm256_or_si256(_mm256_cmpeq_epi8(c, vA), _mm256_cmpeq_epi8(c, vC)),
            _mm256_or_si256(_mm256_cmpeq_epi8(c, vG),
                            _mm256_or_si256(_mm256_cmpeq_epi8(c, vT), is_n)));
        bad = _mm256_or_si256(bad, _mm256_andnot_si256(ok, _mm256_set1_epi8(-1)));
    }
    any_bad = !_mm256_testz_si256(bad, bad);
#endif
    uint8_t sbad = 0;
    for (; i < len; i++) {
        uint8_t c = src[i];
        uint8_t t = (uint8_t)((c >> 1) & 3);
        t ^= (uint8_t)(t >> 1);
        uint8_t is_n = (uint8_t)(c == 'N');
        row[i] = (uint8_t)(t & (uint8_t)(is_n - 1)); /* N -> 0 (A) */
        uint8_t ok = (uint8_t)((c == 'A') | (c == 'C') | (c == 'G') |
                               (c == 'T') | is_n);
        sbad |= (uint8_t)(1 - ok);
    }
    return any_bad | sbad;
}

static long long pack_rows(const uint8_t *data, long long data_size,
                           const long long *starts, const long long *lens,
                           long long r0, long long r1, long long pad,
                           long long min_len, uint8_t *bases, int *lengths) {
    for (long long r = r0; r < r1; r++) {
        long long len = lens[r];
        if (len > pad) len = pad;
        long long s = starts[r];
        if (s < 0 || s + len > data_size) len = 0;
        uint8_t *row = bases + r * pad;
        if (encode_span(data + s, row, len)) return -(r + 1);
        memset(row + len, 0, (size_t)(pad - len));
        lengths[r] = (len >= min_len) ? (int)len : 0;
    }
    return 0;
}

typedef struct {
    const uint8_t *data;
    long long data_size;
    const long long *starts, *lens;
    long long r0, r1, pad, min_len;
    uint8_t *bases;
    int *lengths;
    long long rc;
} pack_job_t;

static void *pack_worker(void *arg) {
    pack_job_t *j = (pack_job_t *)arg;
    j->rc = pack_rows(j->data, j->data_size, j->starts, j->lens, j->r0, j->r1,
                      j->pad, j->min_len, j->bases, j->lengths);
    return NULL;
}

/* Pack n sequences into a fixed-width base-code matrix, split row-wise over
 * nthreads. bases: [n, pad] uint8 out (padding zeroed); lengths: [n] int32
 * out (0 when shorter than min_len — the silent-drop rule, nk.c:1408).
 * Returns 0, or -(row+1) for the FIRST invalid row (reference fatal). */
long long fastx_pack_mt(const uint8_t *data, long long data_size,
                        const long long *starts, const long long *lens,
                        long long n, long long pad, long long min_len,
                        uint8_t *bases, int *lengths, int nthreads) {
    if (nthreads > MAX_IO_THREADS) nthreads = MAX_IO_THREADS;
    if (nthreads < 1) nthreads = 1;
    if (n < 4096) nthreads = 1; /* not worth thread spawn */
    if (nthreads == 1)
        return pack_rows(data, data_size, starts, lens, 0, n, pad, min_len,
                         bases, lengths);
    pack_job_t jobs[MAX_IO_THREADS];
    pthread_t tids[MAX_IO_THREADS];
    long long per = (n + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        long long r0 = t * per, r1 = r0 + per;
        if (r0 >= n) break;
        if (r1 > n) r1 = n;
        jobs[t] = (pack_job_t){data, data_size, starts, lens, r0, r1,
                               pad, min_len, bases, lengths, 0};
        nt = t + 1;
    }
    for (int t = 1; t < nt; t++) pthread_create(&tids[t], NULL, pack_worker, &jobs[t]);
    pack_worker(&jobs[0]);
    for (int t = 1; t < nt; t++) pthread_join(tids[t], NULL);
    long long rc = 0;
    for (int t = 0; t < nt; t++)  /* first (lowest-row) failure wins */
        if (jobs[t].rc < 0 && (rc == 0 || jobs[t].rc > rc)) rc = jobs[t].rc;
    return rc;
}

/* Single-thread entry kept for the original binding surface. */
long long fastx_pack(const uint8_t *data, long long data_size,
                     const long long *starts, const long long *lens,
                     long long n, long long pad, long long min_len,
                     uint8_t *bases, int *lengths) {
    return fastx_pack_mt(data, data_size, starts, lens, n, pad, min_len,
                         bases, lengths, 1);
}

/* ================= record framing ================= */

typedef struct {
    const uint8_t *data;
    long long lo, hi;     /* byte range scanned by this thread */
    long long count;      /* phase A result: newlines in [lo, hi) */
    long long *pos;       /* phase C: shared absolute-offset array */
    long long base;       /* global index of this range's first newline */
    long long cap;        /* write only global indices < cap */
} frame_job_t;

/* FASTQ/FASTA lines are short (quality-separator lines are 1-2 bytes), so a
 * per-line memchr pays call overhead every few dozen bytes. This scanner
 * runs one branch-light SIMD sweep: 32-byte compare -> movemask -> iterate
 * set bits. Count mode (out == NULL) is popcount-only. */
static long long scan_newlines(const uint8_t *restrict data, long long lo,
                               long long hi, long long *restrict out,
                               long long out_base, long long cap) {
    long long cnt = 0, i = lo;
#ifdef __AVX2__
    __m256i nlv = _mm256_set1_epi8('\n');
    if (out == NULL) {
        for (; i + 32 <= hi; i += 32) {
            __m256i c = _mm256_loadu_si256((const __m256i *)(data + i));
            cnt += __builtin_popcount(
                (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(c, nlv)));
        }
    } else {
        for (; i + 32 <= hi; i += 32) {
            __m256i c = _mm256_loadu_si256((const __m256i *)(data + i));
            uint32_t m = (uint32_t)_mm256_movemask_epi8(
                _mm256_cmpeq_epi8(c, nlv));
            while (m) {
                long long gi = out_base + cnt;
                if (gi >= cap) return cnt;
                out[gi] = i + __builtin_ctz(m);
                cnt++;
                m &= m - 1;
            }
        }
    }
#endif
    for (; i < hi; i++) {
        if (data[i] == '\n') {
            if (out) {
                long long gi = out_base + cnt;
                if (gi >= cap) return cnt;
                out[gi] = i;
            }
            cnt++;
        }
    }
    return cnt;
}

static void *count_worker(void *arg) {
    frame_job_t *j = (frame_job_t *)arg;
    j->count = scan_newlines(j->data, j->lo, j->hi, NULL, 0, 0);
    return NULL;
}

static void *fill_worker(void *arg) {
    frame_job_t *j = (frame_job_t *)arg;
    scan_newlines(j->data, j->lo, j->hi, j->pos, j->base, j->cap);
    return NULL;
}

/* Frame up to max_records complete records starting at byte `start`,
 * scanning no further than scan_end (a streaming window; records crossing
 * it are left for the next call — pass scan_end == size for the whole
 * file). cols layout per record: rec_start, rec_end, hdr_start, hdr_len,
 * seq_start, seq_len (absolute file offsets; matches
 * io.reader.RecordColumns). Returns the number of records framed (or -1 on
 * alloc failure); *next_start is the offset of the first unframed byte. A
 * final line without trailing newline counts as a line (mmap zero-fill past
 * EOF, read_line NUL stop, nk.c:394-409). */
long long fastx_frame_win(const uint8_t *data, long long size,
                          long long start, long long scan_end,
                          int lines_per_record, long long max_records,
                          long long *cols, long long *next_start,
                          int nthreads) {
    *next_start = start;
    if (scan_end > size) scan_end = size;
    if (start >= scan_end || max_records <= 0) return 0;
    if (nthreads > MAX_IO_THREADS) nthreads = MAX_IO_THREADS;
    if (nthreads < 1) nthreads = 1;
    if (scan_end - start < (4 << 20)) nthreads = 1;

    frame_job_t jobs[MAX_IO_THREADS];
    pthread_t tids[MAX_IO_THREADS];
    long long span = scan_end - start;
    long long per = (span + nthreads - 1) / nthreads;
    int nt = 0;
    for (int t = 0; t < nthreads; t++) {
        long long lo = start + t * per, hi = lo + per;
        if (lo >= scan_end) break;
        if (hi > scan_end) hi = scan_end;
        jobs[t] = (frame_job_t){data, lo, hi, 0, NULL, 0, 0};
        nt = t + 1;
    }
    /* phase A: count newlines per range */
    for (int t = 1; t < nt; t++) pthread_create(&tids[t], NULL, count_worker, &jobs[t]);
    count_worker(&jobs[0]);
    for (int t = 1; t < nt; t++) pthread_join(tids[t], NULL);

    long long total = 0;
    for (int t = 0; t < nt; t++) {
        jobs[t].base = total;
        total += jobs[t].count;
    }
    int implicit_eof =
        (scan_end == size && size > 0 && data[size - 1] != '\n');
    long long avail = total + (implicit_eof ? 1 : 0);
    long long n = avail / lines_per_record;
    if (n > max_records) n = max_records;
    if (n == 0) return 0;
    long long need = n * (long long)lines_per_record;

    long long *pos = (long long *)malloc((size_t)need * sizeof(long long));
    if (!pos) return -1;
    /* phase C: fill absolute newline offsets below the cap */
    for (int t = 0; t < nt; t++) {
        jobs[t].pos = pos;
        jobs[t].cap = need;
    }
    for (int t = 1; t < nt; t++) pthread_create(&tids[t], NULL, fill_worker, &jobs[t]);
    fill_worker(&jobs[0]);
    for (int t = 1; t < nt; t++) pthread_join(tids[t], NULL);
    if (implicit_eof && need == avail) pos[need - 1] = size;

    /* phase D: arithmetic column build */
    long long prev_end = start;
    for (long long r = 0; r < n; r++) {
        const long long *m = pos + r * lines_per_record;
        long long last = m[lines_per_record - 1];
        long long *c = cols + r * 6;
        c[0] = prev_end;                              /* rec_start */
        c[1] = (last < size) ? last + 1 : size;       /* rec_end */
        c[2] = prev_end;                              /* hdr_start */
        c[3] = m[0] - prev_end;                       /* hdr_len */
        c[4] = m[0] + 1;                              /* seq_start */
        c[5] = m[1] - m[0] - 1;                       /* seq_len */
        if (c[5] < 0) c[5] = 0;
        prev_end = c[1];
    }
    free(pos);
    *next_start = prev_end;
    return n;
}

long long fastx_frame_mt(const uint8_t *data, long long size, long long start,
                         int lines_per_record, long long max_records,
                         long long *cols, long long *next_start,
                         int nthreads) {
    return fastx_frame_win(data, size, start, size, lines_per_record,
                           max_records, cols, next_start, nthreads);
}

/* Single-thread entry kept for the original binding surface. */
long long fastx_frame(const uint8_t *data, long long size, long long start,
                      int lines_per_record, long long max_records,
                      long long *cols, long long *next_start) {
    return fastx_frame_win(data, size, start, size, lines_per_record,
                           max_records, cols, next_start, 1);
}

/* ================= output assembly ================= */

/* Copy kept records into a contiguous buffer, rewriting N->A in the
 * sequence line (the reference's in-buffer replacestr shows up in its
 * output, nk.c:1406). One memcpy per record + a memchr-driven fixup (N is
 * rare in real data, so this runs at memcpy speed). Returns bytes written,
 * or -1 if out_cap too small. fq->fa conversion stays in Python (cold
 * path). */
long long fastx_emit(const uint8_t *data, const long long *cols,
                     const unsigned char *keep, long long nrec,
                     uint8_t *out, long long out_cap) {
    long long w = 0;
    for (long long r = 0; r < nrec; r++) {
        if (!keep[r]) continue;
        const long long *c = cols + r * 6;
        long long rec_start = c[0], rec_end = c[1];
        long long total = rec_end - rec_start;
        if (w + total > out_cap) return -1;
        memcpy(out + w, data + rec_start, (size_t)total);
        uint8_t *sq = out + w + (c[4] - rec_start);
        size_t sl = (size_t)c[5];
        for (uint8_t *p = memchr(sq, 'N', sl); p;) {
            *p = 'A';
            size_t off = (size_t)(p - sq) + 1;
            p = (off < sl) ? memchr(sq + off, 'N', sl - off) : NULL;
        }
        w += total;
    }
    return w;
}
