/* Entropy decoding of one baseline (sequential Huffman, 8-bit) JPEG scan
 * into quantised DCT coefficients, for hi3d_tpu_torch/utils/jpeg.py, which
 * parses the markers and does the rest of the decode (dequantisation, the
 * ISLOW inverse DCT, upsampling and colour conversion) in numpy/torch.
 *
 * Built at first use with the host C compiler (`cc -O3 -shared -fPIC`) into
 * build/host/ and loaded with ctypes; plain C, no library.
 *
 * hi3d_jpeg_decode_scan(data, size, &end, ncomp, desc, coef, bits, vals,
 *                       mcus_x, mcus_y, restart)
 *   data, size   the entropy-coded segment and what follows it (from the
 *                byte after the SOS header to the end of the file)
 *   end          out: offset of the marker that ended the scan (its 0xFF)
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
 */
#include <stdint.h>
#include <string.h>

#define ERR_HUFFMAN -1   /* a code that no table entry has */
#define ERR_OVERRUN -2   /* run-length past the 64th coefficient */
#define ERR_RESTART -3   /* a restart marker missing or out of sequence */
#define ERR_TABLE -4     /* an empty or malformed Huffman table */
#define ERR_ARGS -5      /* a component count, table or block outside its array */

static const int natural_order[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

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
    int marker;  /* a marker was met: zeros are fed from here on */
} bits_t;

static int build_table(huff_t *t, const uint8_t *counts, const uint8_t *vals) {
    int code = 0, k = 0, total = 0;
    for (int l = 1; l <= 16; l++) total += counts[l];
    t->ok = total > 0 && total <= 256;
    if (!t->ok) return 0;
    for (int l = 1; l <= 16; l++) {
        t->valptr[l] = k;
        t->mincode[l] = code;
        code += counts[l];
        k += counts[l];
        t->maxcode[l] = counts[l] ? code - 1 : -1;
        if (code > (1 << l)) { t->ok = 0; return 0; }
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    t->vals = vals;
    return 1;
}

static void fill(bits_t *b) {
    while (b->nbits <= 24) {
        uint32_t byte = 0;
        if (!b->marker && b->p < b->end) {
            byte = *b->p;
            if (byte == 0xFF) {
                const uint8_t *q = b->p + 1;
                while (q < b->end && *q == 0xFF) q++;  /* fill bytes */
                if (q < b->end && *q == 0x00) {
                    b->p = q + 1;
                } else {  /* a marker: leave it, feed zeros */
                    b->marker = 1;
                    byte = 0;
                }
            } else {
                b->p++;
            }
        }
        b->buf |= byte << (24 - b->nbits);
        b->nbits += 8;
    }
}

static inline int get_bits(bits_t *b, int n) {
    if (n == 0) return 0;
    if (b->nbits < n) fill(b);
    int v = (int)(b->buf >> (32 - n));
    b->buf <<= n;
    b->nbits -= n;
    return v;
}

static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static int decode(bits_t *b, const huff_t *t) {
    if (b->nbits < 16) fill(b);
    int code = 0;
    for (int l = 1; l <= 16; l++) {
        code = (code << 1) | (int)(b->buf >> 31);
        b->buf <<= 1;
        b->nbits--;
        if (t->maxcode[l] >= 0 && code <= t->maxcode[l] && code >= t->mincode[l])
            return t->vals[t->valptr[l] + code - t->mincode[l]];
    }
    return ERR_HUFFMAN;
}

/* The end of a restart interval: the encoder pads the interval's last byte
 * with 1 bits, so what the buffer holds is padding, or zeros fed after the
 * marker, and the reader stands at the marker's 0xFF. Read RSTn there. */
static int restart(bits_t *b, int expect) {
    b->buf = 0;
    b->nbits = 0;
    b->marker = 0;
    const uint8_t *q = b->p;
    if (q >= b->end || *q != 0xFF) return ERR_RESTART;
    while (q < b->end && *q == 0xFF) q++;
    if (q >= b->end || *q != 0xD0 + expect) return ERR_RESTART;
    b->p = q + 1;
    return 0;
}

int hi3d_jpeg_decode_scan(const uint8_t *data, long size, long *end, int ncomp,
                          const int *desc, int16_t *const *coef, const uint8_t *bits,
                          const uint8_t *vals, int mcus_x, int mcus_y, int restart_every) {
    if (ncomp < 1 || ncomp > 4 || mcus_x < 0 || mcus_y < 0 || restart_every < 0 || size < 0)
        return ERR_ARGS;
    for (int c = 0; c < ncomp; c++) {
        const int *d = desc + 6 * c;
        if (d[0] < 1 || d[0] > 4 || d[1] < 1 || d[1] > 4 || d[2] < 0 || d[2] > 3 ||
            d[3] < 0 || d[3] > 3 || (long)mcus_x * d[0] > d[4] || (long)mcus_y * d[1] > d[5])
            return ERR_ARGS;
    }
    huff_t tables[8];
    for (int i = 0; i < 8; i++) tables[i].ok = 0;
    for (int c = 0; c < ncomp; c++) {
        int dc = desc[6 * c + 2], ac = 4 + desc[6 * c + 3];
        if (!tables[dc].ok && !build_table(&tables[dc], bits + 17 * dc, vals + 256 * dc))
            return ERR_TABLE;
        if (!tables[ac].ok && !build_table(&tables[ac], bits + 17 * ac, vals + 256 * ac))
            return ERR_TABLE;
    }
    bits_t b = {data, data + size, 0, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    long mcus = (long)mcus_x * mcus_y;
    int next_rst = 0;
    for (long m = 0; m < mcus; m++) {
        if (restart_every && m && m % restart_every == 0) {
            int err = restart(&b, next_rst);
            if (err) return err;
            next_rst = (next_rst + 1) & 7;
            memset(pred, 0, sizeof pred);
        }
        long mx = m % mcus_x, my = m / mcus_x;
        for (int c = 0; c < ncomp; c++) {
            const int *d = desc + 6 * c;
            const huff_t *dct = &tables[d[2]], *act = &tables[4 + d[3]];
            for (int by = 0; by < d[1]; by++) {
                for (int bx = 0; bx < d[0]; bx++) {
                    long row = my * d[1] + by, col = mx * d[0] + bx;
                    int16_t *blk = coef[c] + (row * d[4] + col) * 64;
                    int s = decode(&b, dct);
                    if (s < 0 || s > 16) return ERR_HUFFMAN;
                    pred[c] += s ? extend(get_bits(&b, s), s) : 0;
                    blk[0] = (int16_t)pred[c];
                    for (int k = 1; k < 64;) {
                        int rs = decode(&b, act);
                        if (rs < 0) return ERR_HUFFMAN;
                        int r = rs >> 4;
                        s = rs & 15;
                        if (s) {
                            k += r;
                            if (k > 63) return ERR_OVERRUN;
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
    /* the marker that ends the scan */
    const uint8_t *q = b.p;
    while (q < b.end) {
        if (q[0] == 0xFF && q + 1 < b.end && q[1] != 0x00 && q[1] != 0xFF &&
            !(q[1] >= 0xD0 && q[1] <= 0xD7))
            break;
        q++;
    }
    *end = (long)(q - data);
    return 0;
}
