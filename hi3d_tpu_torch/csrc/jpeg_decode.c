/* Entropy decoding of one Huffman-coded 8-bit JPEG scan into quantised DCT
 * coefficients, sequential (baseline or extended) or progressive, for
 * hi3d_tpu_torch/utils/jpeg.py, which parses the markers and does the rest
 * of the decode (dequantisation, the ISLOW inverse DCT, upsampling and
 * colour conversion) in numpy/torch.
 *
 * Built at first use with the host C compiler (`cc -O3 -shared -fPIC`) into
 * build/host/ and loaded with ctypes; plain C, no library.
 *
 * hi3d_jpeg_decode_scan(data, size, &end, &last, ncomp, desc, coef, bits, vals,
 *                       mcus_x, mcus_y, restart)
 *   data, size   the entropy-coded segment and what follows it (from the
 *                byte after the SOS header to the end of the file)
 *   end          out: offset of the marker that ended the scan (its 0xFF), or
 *                of the first byte not read
 *   last         out: the last MCU decoded from data (-1 if none; an MCU
 *                after the data ran short stays as it was), for the block
 *                smoothing of a progressive file
 *   ncomp        components in the scan (1 for a non-interleaved scan)
 *   desc         ncomp × 6 ints: h, v (blocks of the component in an MCU;
 *                1, 1 for a non-interleaved scan), DC table, AC table
 *                (0..3), blocks per row and rows of blocks of the
 *                component's coefficient array
 *   coef         ncomp pointers to int16 arrays of (rows × blocks per row ×
 *                64) coefficients in natural (row-major) order
 *   bits, vals   Huffman tables: 8 × 17 code-length counts (index 0 unused)
 *                and 8 × 256 symbols; tables 0..3 DC, 4..7 AC
 *   mcus_x/_y    MCUs of the scan across and down
 *   restart      MCUs between restart markers (0: none)
 * Returns 0, or a negative error code (see jpeg.py's _SCAN_ERRORS).
 * jpeg.py checks the file's headers; the arguments are checked here again
 * (ERR_ARGS) so that no table index or block lies outside its array.
 *
 * Damaged data decodes as libjpeg-turbo (jdhuff.c, jdphuff.c, jdmarker.c)
 * decodes it: a code that no table holds reads as symbol 0 after 17 bits,
 * a run past the 64th coefficient lands on coefficient 63, a read that
 * needs bits past the marker ending the data (the end of the data counts as
 * one) gets zeros and leaves the rest of the restart interval's MCUs as they
 * were, and restart markers out of sequence resynchronise as
 * jpeg_resync_to_restart does.
 *
 * hi3d_jpeg_decode_progressive(..., restart, ss, se, ah, al) decodes one
 * scan of a progressive JPEG (SOF2) with the same arguments and the scan
 * header's spectral selection (ss..se) and successive approximation (ah,
 * al), adding what it carries to the coefficients the earlier scans left,
 * as the JPEG standard's Annex G and libjpeg-turbo's jdphuff.c decode it:
 * DC first (Huffman-coded differences, scaled by 1 << al), DC refinement
 * (one bit a block), AC first (one component; runs of empty blocks in
 * EOBRUN) and AC refinement (correction bits for the coefficients already
 * nonzero, new ones of magnitude 1 << al). A non-interleaved scan runs over
 * the component's own grid of blocks: mcus_x × mcus_y with h = v = 1.
 */
#include <stdint.h>
#include <string.h>

#define ERR_TABLE -4     /* an empty or malformed Huffman table */
#define ERR_ARGS -5      /* a component count, table or block outside its array */

/* zigzag → natural order; 16 extra entries, as libjpeg's, so that a run
 * past the band of a corrupt scan lands on coefficient 63 */
static const int natural_order[80] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    int32_t maxcode[18];  /* largest code of each length, -1 if none */
    int32_t valptr[17];   /* index in vals of the first code of each length */
    int32_t mincode[17];
    const uint8_t *vals;
    int ok;
} huff_t;

typedef struct {
    const uint8_t *p, *end;
    uint32_t buf;
    int nbits;
    int fake;              /* zero bits fed past the marker, the last of buf's */
    int unread;            /* the marker the reader stopped at, 0 if none */
    const uint8_t *mark;   /* where that marker starts */
    int insufficient;      /* a read needed bits past it: skip to the next restart */
} bits_t;

/* jpeg_make_d_derived_tbl's checks: 1..256 codes, none all ones, DC
 * symbols within 0..15. */
static int build_table(huff_t *t, const uint8_t *counts, const uint8_t *vals, int dc) {
    int code = 0, k = 0, total = 0;
    for (int l = 1; l <= 16; l++) total += counts[l];
    t->ok = total > 0 && total <= 256;
    for (int i = 0; t->ok && dc && i < total; i++) t->ok = vals[i] <= 15;
    if (!t->ok) return 0;
    for (int l = 1; l <= 16; l++) {
        t->valptr[l] = k;
        t->mincode[l] = code;
        code += counts[l];
        k += counts[l];
        t->maxcode[l] = counts[l] ? code - 1 : -1;
        if (code >= (1 << l)) { t->ok = 0; return 0; }
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    t->vals = vals;
    return 1;
}

/* next_marker: skip to the next marker (past any other bytes and stuffed
 * 0xFF00 pairs) and read its code; the end of the data reads as EOI. */
static void next_marker(bits_t *b) {
    for (;;) {
        while (b->p < b->end && *b->p != 0xFF) b->p++;
        const uint8_t *start = b->p;
        while (b->p < b->end && *b->p == 0xFF) b->p++;
        if (b->p >= b->end) {
            b->unread = 0xD9;
            b->mark = b->end;
            return;
        }
        if (*b->p != 0x00) {
            b->unread = *b->p++;
            b->mark = start;
            return;
        }
        b->p++;
    }
}

static void fill(bits_t *b) {
    while (b->nbits <= 24) {
        uint32_t byte = 0;
        if (!b->unread) {
            if (b->p < b->end && *b->p != 0xFF) {
                byte = *b->p++;
            } else {
                const uint8_t *q = b->p;
                while (q < b->end && *q == 0xFF) q++;  /* fill bytes */
                if (q > b->p && q < b->end && *q == 0x00) {
                    byte = 0xFF;
                    b->p = q + 1;
                } else {
                    next_marker(b);  /* the data end here */
                }
            }
        }
        if (b->unread) b->fake += 8;
        b->buf |= byte << (24 - b->nbits);
        b->nbits += 8;
    }
}

/* Drop n bits; a read of more than the real bits left is libjpeg's
 * JWRN_HIT_MARKER. */
static inline void consume(bits_t *b, int n) {
    if (n > b->nbits - b->fake) b->insufficient = 1;
    b->buf <<= n;
    b->nbits -= n;
    if (b->fake > b->nbits) b->fake = b->nbits;
}

static inline int get_bits(bits_t *b, int n) {
    if (n == 0) return 0;
    if (b->nbits < n) fill(b);
    int v = (int)(b->buf >> (32 - n));
    consume(b, n);
    return v;
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* A symbol; a code that no table holds reads as 0 after 17 bits, as
 * libjpeg's jpeg_huff_decode gives it. */
static int decode(bits_t *b, const huff_t *t) {
    if (b->nbits < 17) fill(b);
    int code = 0;
    for (int l = 1; l <= 16; l++) {
        code = (code << 1) | (int)(b->buf >> 31);
        consume(b, 1);
        if (t->maxcode[l] >= 0 && code <= t->maxcode[l] && code >= t->mincode[l])
            return t->vals[t->valptr[l] + code - t->mincode[l]];
    }
    consume(b, 1);
    return 0;
}

/* The end of a restart interval (process_restart, read_restart_marker,
 * jpeg_resync_to_restart): drop the buffered bits, read the next marker
 * unless one stopped the reader, and take RSTn of the expected number;
 * another marker is skipped if it is one of the two restarts before the
 * expected one, and left (its interval reads as empty) if it is one of the
 * two after it or no restart; any other restart is taken as the expected
 * one. */
static void restart(bits_t *b, int *next_rst) {
    int desired = *next_rst;
    b->buf = 0;
    b->nbits = 0;
    b->fake = 0;
    if (!b->unread) next_marker(b);
    for (;;) {
        int m = b->unread, action;
        if (m == 0xD0 + desired) action = 1;
        else if (m < 0xC0) action = 2;
        else if (m < 0xD0 || m > 0xD7) action = 3;
        else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) action = 3;
        else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) b->unread = 0;
        if (action != 2) break;
        next_marker(b);
    }
    *next_rst = (desired + 1) & 7;
    if (!b->unread) b->insufficient = 0;
}

static int check_args(long size, int ncomp, const int *desc, int mcus_x, int mcus_y,
                      int restart_every) {
    if (ncomp < 1 || ncomp > 4 || mcus_x < 0 || mcus_y < 0 || restart_every < 0 || size < 0)
        return ERR_ARGS;
    for (int c = 0; c < ncomp; c++) {
        const int *d = desc + 6 * c;
        if (d[0] < 1 || d[0] > 4 || d[1] < 1 || d[1] > 4 || d[2] < 0 || d[2] > 3 ||
            d[3] < 0 || d[3] > 3 || (long)mcus_x * d[0] > d[4] || (long)mcus_y * d[1] > d[5])
            return ERR_ARGS;
    }
    return 0;
}

/* Build the DC (use_dc) and AC (use_ac) tables the scan's components name. */
static int build_tables(huff_t *tables, int ncomp, const int *desc, const uint8_t *bits,
                        const uint8_t *vals, int use_dc, int use_ac) {
    for (int i = 0; i < 8; i++) tables[i].ok = 0;
    for (int c = 0; c < ncomp; c++) {
        int dc = desc[6 * c + 2], ac = 4 + desc[6 * c + 3];
        if (use_dc && !tables[dc].ok &&
            !build_table(&tables[dc], bits + 17 * dc, vals + 256 * dc, 1))
            return ERR_TABLE;
        if (use_ac && !tables[ac].ok &&
            !build_table(&tables[ac], bits + 17 * ac, vals + 256 * ac, 0))
            return ERR_TABLE;
    }
    return 0;
}

/* Where the marker reader takes over after the scan: at the marker that
 * stopped the entropy decoder, or at the first byte it did not read. */
static long scan_end(const bits_t *b, const uint8_t *data) {
    return (long)((b->unread ? b->mark : b->p) - data);
}

int hi3d_jpeg_decode_scan(const uint8_t *data, long size, long *end, long *last, int ncomp,
                          const int *desc, int16_t *const *coef, const uint8_t *bits,
                          const uint8_t *vals, int mcus_x, int mcus_y, int restart_every) {
    int err = check_args(size, ncomp, desc, mcus_x, mcus_y, restart_every);
    if (err) return err;
    huff_t tables[8];
    err = build_tables(tables, ncomp, desc, bits, vals, 1, 1);
    if (err) return err;
    bits_t b = {data, data + size, 0, 0, 0, 0, NULL, 0};
    int pred[4] = {0, 0, 0, 0};
    *last = -1;
    long mcus = (long)mcus_x * mcus_y;
    int next_rst = 0;
    for (long m = 0; m < mcus; m++) {
        if (restart_every && m && m % restart_every == 0) {
            restart(&b, &next_rst);
            memset(pred, 0, sizeof pred);
        }
        if (b.insufficient) continue;  /* out of data: the MCU stays zero */
        *last = m;
        long mx = m % mcus_x, my = m / mcus_x;
        for (int c = 0; c < ncomp; c++) {
            const int *d = desc + 6 * c;
            const huff_t *dct = &tables[d[2]], *act = &tables[4 + d[3]];
            for (int by = 0; by < d[1]; by++) {
                for (int bx = 0; bx < d[0]; bx++) {
                    long row = my * d[1] + by, col = mx * d[0] + bx;
                    int16_t *blk = coef[c] + (row * d[4] + col) * 64;
                    int s = decode(&b, dct);  /* 0..15: build_table checks DC symbols */
                    pred[c] = (int)((unsigned)pred[c] + (unsigned)(s ? extend(get_bits(&b, s), s) : 0));
                    blk[0] = (int16_t)pred[c];
                    for (int k = 1; k < 64;) {
                        int rs = decode(&b, act);
                        int r = rs >> 4;
                        s = rs & 15;
                        if (s) {
                            k += r;
                            blk[natural_order[k]] = (int16_t)extend(get_bits(&b, s), s);
                            k++;
                        } else if (r == 15) {
                            k += 16;
                        } else {
                            break;
                        }
                    }
                }
            }
        }
    }
    *end = scan_end(&b, data);
    return 0;
}

/* One block of a progressive scan; `eobrun` carries the run of blocks that
 * end their band early from block to block. */
static void progressive_block(bits_t *b, int16_t *blk, const huff_t *dct, const huff_t *act,
                              int *pred, int *eobrun, int ss, int se, int ah, int al) {
    if (ss == 0) {
        if (ah == 0) {  /* DC first */
            int s = decode(b, dct);
            *pred = (int)((unsigned)*pred + (unsigned)(s ? extend(get_bits(b, s), s) : 0));
            blk[0] = (int16_t)(int)((unsigned)*pred << al);
        } else if (get_bits(b, 1)) {  /* DC refinement */
            blk[0] = (int16_t)(blk[0] | (1 << al));
        }
        return;
    }
    if (ah == 0) {  /* AC first */
        if (*eobrun > 0) {
            (*eobrun)--;
            return;
        }
        for (int k = ss; k <= se; k++) {
            int rs = decode(b, act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[natural_order[k]] = (int16_t)(int)((unsigned)extend(get_bits(b, s), s) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                *eobrun = (1 << r) + (r ? get_bits(b, r) : 0) - 1;
                break;
            }
        }
        return;
    }
    /* AC refinement */
    int p1 = 1 << al, m1 = -(1 << al), k = ss;
    if (*eobrun == 0) {
        for (; k <= se; k++) {
            int rs = decode(b, act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                s = get_bits(b, 1) ? p1 : m1;  /* a new coefficient's size is 1 */
            } else if (r != 15) {
                *eobrun = (1 << r) + (r ? get_bits(b, r) : 0);
                break;
            }
            /* step over r zero coefficients, refining the nonzero ones met */
            do {
                int16_t *c = blk + natural_order[k];
                if (*c != 0) {
                    if (get_bits(b, 1) && (*c & p1) == 0)
                        *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= se);
            if (s) blk[natural_order[k]] = (int16_t)s;
        }
    }
    if (*eobrun > 0) {
        for (; k <= se; k++) {
            int16_t *c = blk + natural_order[k];
            if (*c != 0 && get_bits(b, 1) && (*c & p1) == 0)
                *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
        }
        (*eobrun)--;
    }
}

int hi3d_jpeg_decode_progressive(const uint8_t *data, long size, long *end, long *last, int ncomp,
                                 const int *desc, int16_t *const *coef, const uint8_t *bits,
                                 const uint8_t *vals, int mcus_x, int mcus_y, int restart_every,
                                 int ss, int se, int ah, int al) {
    int err = check_args(size, ncomp, desc, mcus_x, mcus_y, restart_every);
    if (err) return err;
    /* jdphuff.c's checks: a DC band is 0..0, an AC band one component's
     * ss..se within 1..63, a refinement lowers al by one, al at most 13 */
    if (ss < 0 || se < ss || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ncomp != 1) ||
        ah < 0 || al < 0 || al > 13 || (ah != 0 && al != ah - 1))
        return ERR_ARGS;
    huff_t tables[8];
    err = build_tables(tables, ncomp, desc, bits, vals, ss == 0 && ah == 0, ss > 0);
    if (err) return err;
    bits_t b = {data, data + size, 0, 0, 0, 0, NULL, 0};
    int pred[4] = {0, 0, 0, 0}, eobrun = 0, next_rst = 0;
    *last = -1;
    long mcus = (long)mcus_x * mcus_y;
    for (long m = 0; m < mcus; m++) {
        if (restart_every && m && m % restart_every == 0) {
            restart(&b, &next_rst);
            memset(pred, 0, sizeof pred);
            eobrun = 0;
        }
        if (b.insufficient) continue;  /* out of data: the MCU stays as it was */
        *last = m;
        long mx = m % mcus_x, my = m / mcus_x;
        for (int c = 0; c < ncomp; c++) {
            const int *d = desc + 6 * c;
            for (int by = 0; by < d[1]; by++) {
                for (int bx = 0; bx < d[0]; bx++) {
                    long row = my * d[1] + by, col = mx * d[0] + bx;
                    progressive_block(&b, coef[c] + (row * d[4] + col) * 64, &tables[d[2]],
                                      &tables[4 + d[3]], &pred[c], &eobrun, ss, se, ah, al);
                }
            }
        }
    }
    *end = scan_end(&b, data);
    return 0;
}

/* One estimate of decompress_smooth_data: num / (q << 8), rounded half away
 * from zero, its magnitude clamped below 1 << al when al > 0. */
static int16_t smooth_pred(long num, long q, int al) {
    long mag = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
    if (al > 0 && mag >= (1L << al)) mag = (1L << al) - 1;
    return (int16_t)(num >= 0 ? mag : -mag);
}

/* hi3d_jpeg_smooth(coef, out, blocks_x, width_blocks, height_blocks, v,
 *                  imcu_rows, qt, bits, prev_bits, last_good)
 * libjpeg-turbo's block smoothing of one component of a progressive JPEG
 * (jdcoefct.c decompress_smooth_data, 2.1 and later), which its
 * decompressor applies in place of decompress_data when smoothing_ok:
 * each block's unrefined coefficients among the first 10 in zigzag order,
 * where still zero, are estimated from the DC values of the 5 x 5 blocks
 * around it (rows and columns past the edge repeat the edge's), into `out`
 * (a copy of `coef`, whose DC values the estimates read).
 *   coef, out      int16 (imcu_rows * v) x blocks_x x 64, natural order
 *   width_blocks,  the component's blocks across and down
 *   height_blocks
 *   v              its vertical sampling factor (block rows an iMCU row)
 *   qt             its quantisation table, 64 ints in natural order
 *   bits           coef_bits latched at the end of input: zigzag
 *                  coefficients 0..9, the Al they were last sent with, -1
 *                  if never
 *   prev_bits      the same before the component's last scan
 *   last_good      the last iMCU row that the last scan's data reached;
 *                  the rows after it take prev_bits
 * Row and column windows are those of the library, which for the last iMCU
 * row counts block rows as if every iMCU row held as many as it does. Every
 * index is checked against the array; returns 0 or ERR_ARGS. */
int hi3d_jpeg_smooth(const int16_t *coef, int16_t *out, int blocks_x, int width_blocks,
                     int height_blocks, int v, int imcu_rows, const int *qt, const int *bits,
                     const int *prev_bits, long last_good) {
    if (v < 1 || v > 4 || imcu_rows < 1 || width_blocks < 1 || width_blocks > blocks_x ||
        height_blocks < 1 || height_blocks > (long)imcu_rows * v ||
        height_blocks <= (long)(imcu_rows - 1) * v)
        return ERR_ARGS;
    for (int k = 0; k < 10; k++)
        if (qt[natural_order[k]] == 0) return ERR_ARGS;
    long q00 = qt[0], q01 = qt[1], q10 = qt[8], q20 = qt[16], q11 = qt[9], q02 = qt[2],
         q03 = qt[3], q12 = qt[10], q21 = qt[17], q30 = qt[24];
    int last_imcu = imcu_rows - 1, last_col = width_blocks - 1;
    for (int imcu = 0; imcu < imcu_rows; imcu++) {
        int block_rows = v;
        if (imcu == last_imcu) {
            block_rows = height_blocks % v;
            if (block_rows == 0) block_rows = v;
        }
        const int *cb = imcu > last_good ? prev_bits : bits;
        int change_dc = 1;
        for (int k = 1; k < 10; k++) change_dc &= cb[k] == -1;
        long image_block_rows = (long)block_rows * imcu_rows;
        for (int br = 0; br < block_rows; br++) {
            long row = (long)imcu * v + br, ibr = (long)imcu * block_rows + br;
            long r[5];  /* the rows of the window, top to bottom */
            r[2] = row;
            r[1] = ibr > 0 ? row - 1 : row;
            r[0] = ibr > 1 ? row - 2 : r[1];
            r[3] = ibr < image_block_rows - 1 ? row + 1 : row;
            r[4] = ibr < image_block_rows - 2 ? row + 2 : r[3];
            for (int i = 0; i < 5; i++)
                if (r[i] < 0 || r[i] >= (long)imcu_rows * v) return ERR_ARGS;
            for (int col = 0; col <= last_col; col++) {
                int dc[5][5];  /* DC01..DC25 of the library, row by row */
                for (int i = 0; i < 5; i++) {
                    for (int j = 0; j < 5; j++) {
                        int x = col + j - 2;
                        x = x < 0 ? 0 : x > last_col ? last_col : x;
                        dc[i][j] = coef[(r[i] * blocks_x + x) * 64];
                    }
                }
#define DC(n) ((long)dc[((n) - 1) / 5][((n) - 1) % 5])
                int16_t *w = out + (row * blocks_x + col) * 64;
                long num;
                if (cb[1] != 0 && w[1] == 0) {
                    num = q00 * (change_dc ?
                        (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) - 13 * DC(9) +
                         3 * DC(10) - 3 * DC(11) + 38 * DC(12) - 38 * DC(14) + 3 * DC(15) -
                         3 * DC(16) + 13 * DC(17) - 13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) +
                         DC(24) + DC(25)) :
                        (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
                    w[1] = smooth_pred(num, q01, cb[1]);
                }
                if (cb[2] != 0 && w[8] == 0) {
                    num = q00 * (change_dc ?
                        (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) + 13 * DC(7) +
                         38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) - 13 * DC(17) - 38 * DC(18) -
                         13 * DC(19) + DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) +
                         DC(25)) :
                        (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
                    w[8] = smooth_pred(num, q10, cb[2]);
                }
                if (cb[3] != 0 && w[16] == 0) {
                    num = q00 * (change_dc ?
                        (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) - 14 * DC(13) -
                         5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23)) :
                        (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
                    w[16] = smooth_pred(num, q20, cb[3]);
                }
                if (cb[4] != 0 && w[9] == 0) {
                    num = q00 * (change_dc ?
                        (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) +
                         DC(21) - DC(25)) :
                        (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) + DC(22) -
                         DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9)));
                    w[9] = smooth_pred(num, q11, cb[4]);
                }
                if (cb[5] != 0 && w[2] == 0) {
                    num = q00 * (change_dc ?
                        (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) - 14 * DC(13) +
                         7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) + 2 * DC(19)) :
                        (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
                    w[2] = smooth_pred(num, q02, cb[5]);
                }
                if (change_dc) {
                    if (cb[6] != 0 && w[3] == 0) {
                        num = q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19));
                        w[3] = smooth_pred(num, q03, cb[6]);
                    }
                    if (cb[7] != 0 && w[10] == 0) {
                        num = q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19));
                        w[10] = smooth_pred(num, q12, cb[7]);
                    }
                    if (cb[8] != 0 && w[17] == 0) {
                        num = q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19));
                        w[17] = smooth_pred(num, q21, cb[8]);
                    }
                    if (cb[9] != 0 && w[24] == 0) {
                        num = q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19));
                        w[24] = smooth_pred(num, q30, cb[9]);
                    }
                    num = q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) -
                                 6 * DC(6) + 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) -
                                 8 * DC(11) + 42 * DC(12) + 152 * DC(13) + 42 * DC(14) -
                                 8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) +
                                 6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) -
                                 8 * DC(23) - 6 * DC(24) - 2 * DC(25));
                    w[0] = smooth_pred(num, q00, 0);
                }
#undef DC
            }
        }
    }
    return 0;
}
