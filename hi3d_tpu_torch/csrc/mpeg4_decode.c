/* MPEG-4 Part 2 (Visual) Simple Profile: the macroblock layer of one VOP,
 * as libavcodec's `mpeg4` encoder writes it under cv2's VideoWriter
 * (fourcc mp4v). utils/mpeg4.py parses the VOL and VOP headers and calls
 * hi3d_mpeg4_decode_vop with the bit position where the macroblocks start.
 *
 * The subset: I- and P-VOPs in one video packet (no resync markers, no data
 * partitioning), rectangular shape, progressive, 4:2:0, 8 bits, H.263
 * quantisation; intra macroblocks with DC VLCs (or the DC as the first
 * TCOEF under intra_dc_vlc_thr), DC and AC prediction, dquant; inter
 * macroblocks with one half-pel vector or four (median prediction by 8x8
 * block, unrestricted vectors over the edge-extended reference,
 * vop_rounding_type), not_coded macroblocks.
 *
 * Arithmetic follows libavcodec (mpeg4videodec.c, h263.c, mpegvideo):
 * ff_mpeg4_pred_dc / ff_mpeg4_pred_ac, the TCOEF escapes and their level
 * clip, dct_unquantize_h263_intra, the chroma vectors of h263's
 * mpeg_motion and chroma_4mv_motion, hpel_motion's clip of four-vector
 * blocks to the VOP, and the 8-bit integer simple IDCT of simple_idct_template.c
 * (rows with the DC-only shortcut, then columns). The VLC tables are those
 * of ISO/IEC 14496-2 Annex B.
 *
 * Every value read from the stream that indexes an array is checked; a
 * damaged stream returns -1 with a message naming the macroblock.
 */

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ tables */

/* TCOEF (Table B-16 intra, B-17 inter): code, length; the last entry is
 * the escape; runs and levels of entries 0..101, last = 1 from INTRA_LAST
 * and INTER_LAST on. */
static const uint16_t intra_vlc[103][2] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6}, {0x13, 6}, {0x12, 6},
    {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8}, {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9},
    {0x21, 10}, {0x20, 10}, {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7}, {0x1c, 8}, {0x20, 9},
    {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12}, {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9},
    {0xc, 10}, {0x56, 12}, {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9}, {0x54, 12}, {0x14, 7},
    {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10}, {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9},
    {0x18, 9}, {0x7, 10}, {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10}, {0xe, 6}, {0x4, 10},
    {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11}, {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12},
    {0x14, 8}, {0x13, 8}, {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
static const uint8_t intra_run[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11,
    12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2,
    3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20,
};
static const uint8_t intra_level[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5,
    6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1,
    1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
static const uint16_t inter_vlc[103][2] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9}, {0x24, 9}, {0x21, 10},
    {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10},
    {0x21, 11}, {0x50, 12}, {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10}, {0x53, 12}, {0x13, 6},
    {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10}, {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10},
    {0x16, 7}, {0x55, 12}, {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9}, {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9}, {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6},
    {0xd, 6}, {0xc, 6}, {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8}, {0x18, 9}, {0x17, 9},
    {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10},
    {0x5, 10}, {0x4, 10}, {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7},
};
static const uint8_t inter_run[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6,
    6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2,
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40,
};
static const uint8_t inter_level[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4,
    5, 6, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1,
    2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
#define INTRA_LAST 67
#define INTER_LAST 58
#define TCOEF_ESCAPE 102

/* motion_code magnitudes 0..32 (Table B-12; a sign bit follows a nonzero) */
static const uint8_t mv_vlc[33][2] = {
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
    {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10},
    {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10}, {6, 10}, {5, 10},
    {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11}, {3, 11}, {2, 11}, {3, 12},
    {2, 12},
};
/* cbpy of intra macroblocks (Table B-8; inter ones take its complement) */
static const uint8_t cbpy_vlc[16][2] = {
    {3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
    {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2},
};
/* mcbpc of I-VOPs (Table B-6): bit 2 dquant, 8 stuffing */
static const uint8_t intra_mcbpc_code[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
static const uint8_t intra_mcbpc_bits[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
/* mcbpc of P-VOPs (Table B-7): bit 2 intra, bit 3 dquant, bit 4 four
 * vectors, 20 stuffing, 24..27 H.263's inter4v+q */
static const uint8_t inter_mcbpc_code[28] = {
    1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4, 3, 2,
    2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15,
};
static const uint8_t inter_mcbpc_bits[28] = {
    1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9, 9, 9,
    3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13,
};
/* dct_dc_size (Tables B-13, B-14) */
static const uint8_t dc_lum_vlc[13][2] = {
    {3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
    {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11},
};
static const uint8_t dc_chrom_vlc[13][2] = {
    {3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6}, {1, 7},
    {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12},
};
static const uint8_t zigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};
static const uint8_t alt_h[64] = {
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63,
};
static const uint8_t alt_v[64] = {
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63,
};
static const uint8_t y_dc_scale[32] = {
    0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46,
};
static const uint8_t c_dc_scale[32] = {
    0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
    14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25,
};

/* ------------------------------------------------------- lookup tables */

typedef struct {
    int16_t sym; /* -1: no code starts with these bits */
    uint8_t len;
} vlc_t;

#define TCOEF_BITS 12
#define MCBPC_BITS 9
#define CBPY_BITS 6
#define MV_BITS 12
#define DC_BITS 12

static vlc_t tcoef_tab[2][1 << TCOEF_BITS]; /* 0 intra, 1 inter */
static vlc_t mcbpc_tab[2][1 << MCBPC_BITS]; /* 0 I-VOP, 1 P-VOP */
static vlc_t cbpy_tab[1 << CBPY_BITS];
static vlc_t mv_tab[1 << MV_BITS];
static vlc_t dc_tab[2][1 << DC_BITS]; /* 0 luma, 1 chroma */
static uint8_t max_level[2][2][64];   /* [inter][last][run] */
static uint8_t max_run[2][2][64];     /* [inter][last][level] */

static void fill(vlc_t *t, int bits, unsigned code, int len, int sym) {
    unsigned first = code << (bits - len), n = 1u << (bits - len);
    for (unsigned i = 0; i < n; i++) {
        t[first + i].sym = (int16_t)sym;
        t[first + i].len = (uint8_t)len;
    }
}

static void clear(vlc_t *t, int bits) {
    for (int i = 0; i < (1 << bits); i++) {
        t[i].sym = -1;
        t[i].len = 0;
    }
}

__attribute__((constructor)) static void build_tables(void) {
    for (int inter = 0; inter < 2; inter++) {
        const uint16_t(*vlc)[2] = inter ? inter_vlc : intra_vlc;
        const uint8_t *run = inter ? inter_run : intra_run, *level = inter ? inter_level : intra_level;
        int last_from = inter ? INTER_LAST : INTRA_LAST;
        clear(tcoef_tab[inter], TCOEF_BITS);
        for (int s = 0; s < 103; s++) fill(tcoef_tab[inter], TCOEF_BITS, vlc[s][0], vlc[s][1], s);
        for (int s = 0; s < 102; s++) {
            int last = s >= last_from;
            if (level[s] > max_level[inter][last][run[s]]) max_level[inter][last][run[s]] = level[s];
            if (run[s] > max_run[inter][last][level[s]]) max_run[inter][last][level[s]] = run[s];
        }
    }
    clear(mcbpc_tab[0], MCBPC_BITS);
    for (int s = 0; s < 9; s++) fill(mcbpc_tab[0], MCBPC_BITS, intra_mcbpc_code[s], intra_mcbpc_bits[s], s);
    clear(mcbpc_tab[1], MCBPC_BITS);
    for (int s = 0; s < 21; s++)
        if (inter_mcbpc_bits[s]) fill(mcbpc_tab[1], MCBPC_BITS, inter_mcbpc_code[s], inter_mcbpc_bits[s], s);
    clear(cbpy_tab, CBPY_BITS);
    for (int s = 0; s < 16; s++) fill(cbpy_tab, CBPY_BITS, cbpy_vlc[s][0], cbpy_vlc[s][1], s);
    clear(mv_tab, MV_BITS);
    for (int s = 0; s < 33; s++) fill(mv_tab, MV_BITS, mv_vlc[s][0], mv_vlc[s][1], s);
    for (int c = 0; c < 2; c++) {
        const uint8_t(*vlc)[2] = c ? dc_chrom_vlc : dc_lum_vlc;
        clear(dc_tab[c], DC_BITS);
        for (int s = 0; s < 13; s++) fill(dc_tab[c], DC_BITS, vlc[s][0], vlc[s][1], s);
    }
}

/* ----------------------------------------------------------------- bits */

typedef struct {
    const uint8_t *buf; /* nbytes of data, then at least 8 zero bytes */
    long nbits, pos;
} bits_t;

static inline uint32_t show32(const bits_t *b) {
    long byte = b->pos >> 3;
    uint64_t v = 0;
    if (b->pos > b->nbits) return 0; /* past the end reads zeros */
    for (int i = 0; i < 8; i++) v = (v << 8) | b->buf[byte + i];
    return (uint32_t)((v << (b->pos & 7)) >> 32);
}

static inline unsigned get(bits_t *b, int n) {
    unsigned v = n ? show32(b) >> (32 - n) : 0;
    b->pos += n;
    return v;
}

static inline int vlc(bits_t *b, const vlc_t *t, int bits) {
    const vlc_t *e = &t[show32(b) >> (32 - bits)];
    if (e->sym < 0) return -1;
    b->pos += e->len;
    return e->sym;
}

/* ------------------------------------------------------------------ IDCT */

#define W1 22725
#define W2 21407
#define W3 19266
#define W4 16383
#define W5 12873
#define W6 8867
#define W7 4520
#define ROW_SHIFT 11
#define COL_SHIFT 20
#define DC_SHIFT 3

static inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

static void idct_row(int16_t *row) {
    unsigned a0, a1, a2, a3, b0, b1, b2, b3;
    if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
        int16_t dc = (int16_t)(uint16_t)((unsigned)row[0] << DC_SHIFT);
        for (int i = 0; i < 8; i++) row[i] = dc;
        return;
    }
    a0 = (unsigned)(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
    a1 = a0;
    a2 = a0;
    a3 = a0;
    a0 += (unsigned)(W2 * row[2]);
    a1 += (unsigned)(W6 * row[2]);
    a2 -= (unsigned)(W6 * row[2]);
    a3 -= (unsigned)(W2 * row[2]);
    b0 = (unsigned)(W1 * row[1]) + (unsigned)(W3 * row[3]);
    b1 = (unsigned)(W3 * row[1]) + (unsigned)(-W7 * row[3]);
    b2 = (unsigned)(W5 * row[1]) + (unsigned)(-W1 * row[3]);
    b3 = (unsigned)(W7 * row[1]) + (unsigned)(-W5 * row[3]);
    if (row[4] | row[5] | row[6] | row[7]) {
        a0 += (unsigned)(W4 * row[4] + W6 * row[6]);
        a1 += (unsigned)(-W4 * row[4] - W2 * row[6]);
        a2 += (unsigned)(-W4 * row[4] + W2 * row[6]);
        a3 += (unsigned)(W4 * row[4] - W6 * row[6]);
        b0 += (unsigned)(W5 * row[5]) + (unsigned)(W7 * row[7]);
        b1 += (unsigned)(-W1 * row[5]) + (unsigned)(-W5 * row[7]);
        b2 += (unsigned)(W7 * row[5]) + (unsigned)(W3 * row[7]);
        b3 += (unsigned)(W3 * row[5]) + (unsigned)(-W1 * row[7]);
    }
    row[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
    row[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
    row[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
    row[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
    row[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
    row[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
    row[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
    row[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
}

/* column i of the row-transformed block into out[0..7] (before clipping) */
static void idct_col(const int16_t *col, int out[8]) {
    unsigned a0, a1, a2, a3, b0, b1, b2, b3;
    a0 = (unsigned)(W4 * (col[8 * 0] + ((1 << (COL_SHIFT - 1)) / W4)));
    a1 = a0;
    a2 = a0;
    a3 = a0;
    a0 += (unsigned)(W2 * col[8 * 2]);
    a1 += (unsigned)(W6 * col[8 * 2]);
    a2 += (unsigned)(-W6 * col[8 * 2]);
    a3 += (unsigned)(-W2 * col[8 * 2]);
    b0 = (unsigned)(W1 * col[8 * 1]) + (unsigned)(W3 * col[8 * 3]);
    b1 = (unsigned)(W3 * col[8 * 1]) + (unsigned)(-W7 * col[8 * 3]);
    b2 = (unsigned)(W5 * col[8 * 1]) + (unsigned)(-W1 * col[8 * 3]);
    b3 = (unsigned)(W7 * col[8 * 1]) + (unsigned)(-W5 * col[8 * 3]);
    a0 += (unsigned)(W4 * col[8 * 4]);
    a1 += (unsigned)(-W4 * col[8 * 4]);
    a2 += (unsigned)(-W4 * col[8 * 4]);
    a3 += (unsigned)(W4 * col[8 * 4]);
    b0 += (unsigned)(W5 * col[8 * 5]);
    b1 += (unsigned)(-W1 * col[8 * 5]);
    b2 += (unsigned)(W7 * col[8 * 5]);
    b3 += (unsigned)(W3 * col[8 * 5]);
    a0 += (unsigned)(W6 * col[8 * 6]);
    a1 += (unsigned)(-W2 * col[8 * 6]);
    a2 += (unsigned)(W2 * col[8 * 6]);
    a3 += (unsigned)(-W6 * col[8 * 6]);
    b0 += (unsigned)(W7 * col[8 * 7]);
    b1 += (unsigned)(-W5 * col[8 * 7]);
    b2 += (unsigned)(W3 * col[8 * 7]);
    b3 += (unsigned)(-W1 * col[8 * 7]);
    out[0] = (int)(a0 + b0) >> COL_SHIFT;
    out[1] = (int)(a1 + b1) >> COL_SHIFT;
    out[2] = (int)(a2 + b2) >> COL_SHIFT;
    out[3] = (int)(a3 + b3) >> COL_SHIFT;
    out[4] = (int)(a3 - b3) >> COL_SHIFT;
    out[5] = (int)(a2 - b2) >> COL_SHIFT;
    out[6] = (int)(a1 - b1) >> COL_SHIFT;
    out[7] = (int)(a0 - b0) >> COL_SHIFT;
}

/* the block's IDCT written (add = 0) or added (add = 1) to dst, clipped */
static void idct(int16_t *blk, uint8_t *dst, long stride, int add) {
    int out[8];
    for (int r = 0; r < 8; r++) idct_row(blk + 8 * r);
    for (int c = 0; c < 8; c++) {
        idct_col(blk + c, out);
        for (int r = 0; r < 8; r++) {
            uint8_t *p = dst + r * stride + c;
            *p = clip8(add ? *p + out[r] : out[r]);
        }
    }
}

/* ------------------------------------------------------- motion compensation */

/* a saturating decrement (psubusb by 1) */
static inline int dec(int x) { return x ? x - 1 : 0; }

/* n x n block (n 16 or 8) at integer (x, y) plus half-sample flags dxy
 * (bit 0 x, bit 1 y) of a reference plane of ew x eh samples (whole
 * macroblocks, libavcodec's h_edge_pos) whose samples past its edge repeat
 * it; rnd 1 rounds half-way averages up, 0 down (vop_rounding_type 1).
 * libavcodec's x86 hpeldsp (unless a caller asks for bit-exactness, which
 * cv2 does not) averages 8-wide blocks that round down with pavgb after
 * decrementing one operand: the result rounds up where that operand is 0
 * and the other odd. Its 16-wide and two-dimensional averages are exact.
 * Returns 1 when the block reaches past the edge. */
static int mc(uint8_t *dst, long ds, const uint8_t *ref, long rs, int ew, int eh, int x, int y,
              int dxy, int n, int rnd) {
    uint8_t tmp[17 * 17];
    const uint8_t *src;
    long ss;
    int hx = dxy & 1, hy = dxy >> 1, outside = !(x >= 0 && y >= 0 && x + n + hx <= ew &&
                                                  y + n + hy <= eh);
    if (!outside) {
        src = ref + y * rs + x;
        ss = rs;
    } else {
        for (int r = 0; r <= n; r++) {
            int yy = y + r < 0 ? 0 : y + r >= eh ? eh - 1 : y + r;
            for (int c = 0; c <= n; c++) {
                int xx = x + c < 0 ? 0 : x + c >= ew ? ew - 1 : x + c;
                tmp[r * 17 + c] = ref[yy * rs + xx];
            }
        }
        src = tmp;
        ss = 17;
    }
    for (int r = 0; r < n; r++) {
        const uint8_t *a = src + r * ss, *b = a + ss;
        uint8_t *d = dst + r * ds;
        switch (dxy) {
        case 0:
            memcpy(d, a, (size_t)n);
            break;
        case 1:
            if (n == 8 && !rnd) { /* x86's put_no_rnd_pixels8_x2: pavgb(left - 1, right) */
                for (int c = 0; c < n; c++) d[c] = (uint8_t)((dec(a[c]) + a[c + 1] + 1) >> 1);
                break;
            }
            for (int c = 0; c < n; c++) d[c] = (uint8_t)((a[c] + a[c + 1] + rnd) >> 1);
            break;
        case 2:
            if (n == 8 && !rnd) { /* put_no_rnd_pixels8_y2: the odd row of each pair less 1 */
                for (int c = 0; c < n; c++)
                    d[c] = (uint8_t)((((r & 1) ? dec(a[c]) + b[c] : a[c] + dec(b[c])) + 1) >> 1);
                break;
            }
            for (int c = 0; c < n; c++) d[c] = (uint8_t)((a[c] + b[c] + rnd) >> 1);
            break;
        default:
            for (int c = 0; c < n; c++)
                d[c] = (uint8_t)((a[c] + a[c + 1] + b[c] + b[c + 1] + 1 + rnd) >> 2);
        }
    }
    return outside;
}

/* ------------------------------------------------------------ the VOP */

typedef struct {
    int16_t dc;     /* reconstructed DC (level x dc_scale, clipped to 0..2047) */
    int16_t ac[16]; /* quantised coefficients: [1..7] first column, [9..15] first row */
} pred_t;

typedef struct {
    bits_t b;
    int mb_w, mb_h, mb_x, mb_y, qscale, ac_pred;
    pred_t *pred[3];   /* luma (2 mb_w + 1) x (2 mb_h + 1), chroma (mb_w + 1) x (mb_h + 1) */
    uint8_t *qtab;     /* each macroblock's qscale */
    int16_t (*mv)[2];  /* each 8x8 luma block's vector (0 for intra and not coded):
                          (2 mb_w + 2) x (2 mb_h + 1), a zero border left, right and
                          on top that is never written */
    int width, height; /* the VOP's, for hpel_motion's clip of 8x8 vectors */
    long *stats;       /* STAT_* counters, or NULL */
    char *msg;
    int msglen;
} vop_t;

/* what `stats` counts */
enum {
    STAT_INTRA_IN_P,  /* intra macroblocks in P-VOPs */
    STAT_NOT_CODED,   /* not_coded macroblocks */
    STAT_AC_PRED,     /* intra macroblocks with ac_pred_flag */
    STAT_DC_AS_AC,    /* intra macroblocks whose DC is a TCOEF (intra_dc_vlc_thr) */
    STAT_DQUANT,      /* macroblocks with a dquant */
    STAT_ESCAPE1,     /* TCOEF escapes of each mode */
    STAT_ESCAPE2,
    STAT_ESCAPE3,
    STAT_PAST_EDGE,   /* luma predictions that reach past the reference's edge */
    STAT_ROUND_DOWN,  /* half-sample predictions under vop_rounding_type 1 */
    STAT_FOUR_MV,     /* macroblocks with four vectors */
    STAT_COUNT
};

static inline void count(vop_t *v, int what) {
    if (v->stats) v->stats[what]++;
}

static int fail(vop_t *v, int rc, const char *fmt, ...) {
    va_list ap;
    int n;
    if (v->msglen <= 0) return rc;
    n = snprintf(v->msg, (size_t)v->msglen, "macroblock (%d, %d): ", v->mb_x, v->mb_y);
    if (n < 0 || n >= v->msglen) return rc;
    va_start(ap, fmt);
    vsnprintf(v->msg + n, (size_t)(v->msglen - n), fmt, ap);
    va_end(ap);
    return rc;
}

static pred_t *block_pred(vop_t *v, int n, long *wrap) {
    if (n < 4) {
        long w = 2 * v->mb_w + 1;
        *wrap = w;
        return &v->pred[0][(2 * v->mb_y + (n >> 1) + 1) * w + 2 * v->mb_x + (n & 1) + 1];
    }
    *wrap = v->mb_w + 1;
    return &v->pred[n - 3][(v->mb_y + 1) * (v->mb_w + 1) + v->mb_x + 1];
}

/* Whether a dequantised coefficient lies in the range an 8-bit stream
 * gives: -2048..2047 (the standard's saturation), plus `margin` for an
 * intra DC (level x dc_scale rounds up to half a step past 2040). Outside
 * it the stream is damaged: libavcodec, which neither saturates nor
 * checks, feeds it to a SIMD IDCT that saturates where this one wraps. */
static inline int in_range(int c, int margin) { return c >= -2048 && c <= 2047 + margin; }

/* ff_mpeg4_pred_dc: adds the predicted DC to `level`, stores the
 * reconstruction for later blocks, returns the quantised DC */
static int pred_dc(vop_t *v, int n, int level, int *dir) {
    long wrap;
    pred_t *p = block_pred(v, n, &wrap);
    int scale = n < 4 ? y_dc_scale[v->qscale] : c_dc_scale[v->qscale];
    int a = p[-1].dc, b = p[-1 - wrap].dc, c = p[-wrap].dc, pred, out;
    if (abs(a - b) < abs(b - c)) {
        pred = c;
        *dir = 1;
    } else {
        pred = a;
        *dir = 0;
    }
    level += (pred + (scale >> 1)) / scale;
    out = level;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    p->dc = (int16_t)level;
    return out;
}

static inline int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

/* ff_mpeg4_pred_ac: adds the neighbour's first column (dir 0) or row
 * (dir 1) when ac_pred is set, then stores this block's */
static void pred_ac(vop_t *v, int16_t *blk, int n, int dir) {
    long wrap;
    pred_t *p = block_pred(v, n, &wrap);
    if (v->ac_pred) {
        if (dir == 0) {
            const pred_t *s = p - 1;
            int q = v->mb_x > 0 ? v->qtab[v->mb_y * v->mb_w + v->mb_x - 1] : v->qscale;
            if (v->mb_x == 0 || q == v->qscale || n == 1 || n == 3)
                for (int i = 1; i < 8; i++) blk[i << 3] = (int16_t)(blk[i << 3] + s->ac[i]);
            else
                for (int i = 1; i < 8; i++)
                    blk[i << 3] = (int16_t)(blk[i << 3] + rounded_div(s->ac[i] * q, v->qscale));
        } else {
            const pred_t *s = p - wrap;
            int q = v->mb_y > 0 ? v->qtab[(v->mb_y - 1) * v->mb_w + v->mb_x] : v->qscale;
            if (v->mb_y == 0 || q == v->qscale || n == 2 || n == 3)
                for (int i = 1; i < 8; i++) blk[i] = (int16_t)(blk[i] + s->ac[i + 8]);
            else
                for (int i = 1; i < 8; i++)
                    blk[i] = (int16_t)(blk[i] + rounded_div(s->ac[i + 8] * q, v->qscale));
        }
    }
    for (int i = 1; i < 8; i++) {
        p->ac[i] = blk[i << 3];
        p->ac[8 + i] = blk[i];
    }
}

/* the coefficients of block n (mpeg4_decode_block): intra ones quantised,
 * with the DC predicted and AC prediction applied; inter ones dequantised */
static int decode_block(vop_t *v, int16_t *blk, int n, int coded, int intra, int dc_vlc) {
    bits_t *b = &v->b;
    const uint8_t *scan = zigzag;
    const uint8_t *run_tab = intra ? intra_run : inter_run, *level_tab = intra ? intra_level : inter_level;
    int last_from = intra ? INTRA_LAST : INTER_LAST;
    int i, qmul = 1, qadd = 0, dir = 0;
    if (intra) {
        if (dc_vlc) {
            int size = vlc(b, dc_tab[n >= 4], DC_BITS), level = 0;
            if (size < 0 || size > 9) return fail(v, -1, "block %d: an invalid dct_dc_size", n);
            if (size) {
                unsigned bits = get(b, size);
                level = (bits >> (size - 1)) ? (int)bits : (int)bits - (1 << size) + 1;
                if (size > 8) get(b, 1); /* marker */
            }
            level = pred_dc(v, n, level, &dir);
            if (level < 0) /* libavcodec reads it as an error code */
                return fail(v, -1, "block %d: a negative intra DC", n);
            blk[0] = (int16_t)level;
            i = 0;
        } else {
            i = -1;
            pred_dc(v, n, 0, &dir);
        }
        if (v->ac_pred) scan = dir == 0 ? alt_v : alt_h;
    } else {
        i = -1;
        qmul = v->qscale << 1;
        qadd = (v->qscale - 1) | 1;
    }
    if (coded) {
        const vlc_t *tab = tcoef_tab[!intra];
        for (;;) {
            int s = vlc(b, tab, TCOEF_BITS), level, run, last;
            if (s < 0) return fail(v, -1, "block %d: an invalid TCOEF code", n);
            if (s != TCOEF_ESCAPE) {
                level = level_tab[s] * qmul + qadd;
                run = run_tab[s];
                last = s >= last_from;
                if (get(b, 1)) level = -level;
            } else {
                unsigned head = show32(b);
                if (!(head & 0x80000000u)) { /* escape 1: the level plus LMAX */
                    count(v, STAT_ESCAPE1);
                    get(b, 1);
                    s = vlc(b, tab, TCOEF_BITS);
                    if (s < 0 || s == TCOEF_ESCAPE) return fail(v, -1, "block %d: a bad first escape", n);
                    run = run_tab[s];
                    last = s >= last_from;
                    level = (level_tab[s] + max_level[!intra][last][run]) * qmul + qadd;
                    if (get(b, 1)) level = -level;
                } else if (!(head & 0x40000000u)) { /* escape 2: the run plus RMAX + 1 */
                    count(v, STAT_ESCAPE2);
                    get(b, 2);
                    s = vlc(b, tab, TCOEF_BITS);
                    if (s < 0 || s == TCOEF_ESCAPE) return fail(v, -1, "block %d: a bad second escape", n);
                    last = s >= last_from;
                    run = run_tab[s] + max_run[!intra][last][level_tab[s]] + 1;
                    level = level_tab[s] * qmul + qadd;
                    if (get(b, 1)) level = -level;
                } else { /* escape 3: last, run and a 12-bit level */
                    int raw;
                    count(v, STAT_ESCAPE3);
                    get(b, 2);
                    last = (int)get(b, 1);
                    run = (int)get(b, 6);
                    if (!get(b, 1)) return fail(v, -1, "block %d: a marker bit missing in the third escape", n);
                    raw = (int)get(b, 12);
                    if (raw & 0x800) raw -= 0x1000;
                    if (!get(b, 1)) return fail(v, -1, "block %d: a marker bit missing in the third escape", n);
                    level = raw > 0 ? raw * qmul + qadd : raw * qmul - qadd;
                    if (level < -2048) level = -2048;
                    if (level > 2047) level = 2047;
                }
            }
            if (!intra && !in_range(level, 0))
                return fail(v, -1, "block %d: a coefficient of %d", n, level);
            i += run + 1;
            if (i > 63 || (i == 63 && !last) || i < 0)
                return fail(v, -1, "block %d: coefficients run past the block", n);
            blk[scan[i]] = (int16_t)level;
            if (last) break;
        }
    }
    if (intra) {
        if (!dc_vlc) blk[0] = (int16_t)pred_dc(v, n, blk[0], &dir);
        pred_ac(v, blk, n, dir);
    }
    return 0;
}

/* libavcodec's mpeg4_is_resync, which runs after every macroblock: it
 * consumes stuffing codes, then returns 1 when the rest of the VOP is its
 * last byte's stuffing (a 0, then 1s), 2 when what follows reads as a
 * resync marker (stuffing to the byte, then 16 zeros (I) or 15 + fcode
 * (P)), else 0. Past a 2, or after the last macroblock without a 1,
 * libavcodec ends the slice or conceals, so the caller reports damage. */
static int after_mb(vop_t *v, int inter, int fcode) {
    static const uint16_t resync_prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                              0x7000, 0x6000, 0x4000, 0x0000};
    bits_t *b = &v->b;
    int ptype = inter ? 2 : 1; /* libavcodec's AV_PICTURE_TYPE_I, _P */
    unsigned x = show32(b) >> 16;
    while (x <= 0xFF && (x >> (8 - ptype)) == 1) {
        b->pos += 8 + ptype;
        x = show32(b) >> 16;
    }
    if (b->pos + 8 >= b->nbits) {
        x = (x >> 8) | (0x7Fu >> (7 - (b->pos & 7)));
        return x == 0x7F;
    }
    if (x == resync_prefix[b->pos & 7]) {
        bits_t t = *b;
        int len = 0;
        t.pos = (t.pos + 8) & ~7L;
        while (len < 32 && !get(&t, 1)) len++;
        if (len >= (inter ? fcode + 15 : 16)) return 2;
    }
    return 0;
}

static int decode_motion(vop_t *v, int pred, int fcode, int *out) {
    bits_t *b = &v->b;
    int code = vlc(b, mv_tab, MV_BITS), val, shift = fcode - 1, n = 5 + fcode;
    if (code < 0) return fail(v, -1, "an invalid motion_code");
    if (code == 0) {
        *out = pred;
        return 0;
    }
    int sign = (int)get(b, 1);
    val = code;
    if (shift) val = (((val - 1) << shift) | (int)get(b, shift)) + 1;
    if (sign) val = -val;
    val += pred;
    val = (int)((unsigned)val << (32 - n)) >> (32 - n); /* modulo the vector range */
    *out = val;
    return 0;
}

static int mid3(int a, int b, int c) {
    if (a > b) { int t = a; a = b; b = t; }
    return c < a ? a : c > b ? b : c;
}

static long mv_index(const vop_t *v, int n) {
    return (2L * v->mb_y + (n >> 1) + 1) * (2L * v->mb_w + 2) + 2L * v->mb_x + (n & 1) + 1;
}

/* ff_h263_pred_motion, the video packet starting at (0, 0): the median of
 * the left, above and above-right candidates of 8x8 block n (0 outside the
 * VOP); in the first row blocks 0 and 1 take the left one alone */
static void pred_mv(const vop_t *v, int n, int *px, int *py) {
    static const int off[4] = {2, 1, 1, -1};
    long w = 2L * v->mb_w + 2, i = mv_index(v, n);
    const int16_t *a = v->mv[i - 1], *b = v->mv[i - w], *c = v->mv[i + off[n] - w];
    if (v->mb_y == 0 && n < 2) {
        *px = a[0];
        *py = a[1];
        return;
    }
    *px = mid3(a[0], b[0], c[0]);
    *py = mid3(a[1], b[1], c[1]);
}

static void set_mb_mv(vop_t *v, int mx, int my) {
    for (int n = 0; n < 4; n++) {
        v->mv[mv_index(v, n)][0] = (int16_t)mx;
        v->mv[mv_index(v, n)][1] = (int16_t)my;
    }
}

static inline int clip(int x, int lo, int hi) { return x < lo ? lo : x > hi ? hi : x; }

/* ff_h263_round_chroma: the chroma vector of four luma vectors' sum */
static int round_chroma(int x) {
    static const uint8_t roundtab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return roundtab[x & 15] + ((x >> 3) & ~1);
}

static void clean_preds(vop_t *v) {
    for (int n = 0; n < 6; n++) {
        long wrap;
        pred_t *p = block_pred(v, n, &wrap);
        p->dc = 1024;
        memset(p->ac, 0, sizeof p->ac);
    }
}

/* Decodes the macroblocks of one VOP of width x height starting at bit
 * `bitpos` of data. Planes are macroblock-aligned: luma 16 mb_w x 16 mb_h,
 * chroma half; a P-VOP (vop_type 1) predicts from ref_*, which repeat past
 * their edges.
 * `stats` (STAT_COUNT counters, or NULL) counts the tools the VOP used.
 * Returns 0, -1 for a damaged stream (the message names the macroblock),
 * -2 out of memory, -5 bad arguments. */
int hi3d_mpeg4_decode_vop(const uint8_t *data, long nbytes, long bitpos, int mb_w, int mb_h,
                          int width, int height, int vop_type, int qscale, int rounding, int fcode, int dc_thr,
                          const uint8_t *ref_y, const uint8_t *ref_u, const uint8_t *ref_v,
                          uint8_t *y, uint8_t *u, uint8_t *v_, long *stats, char *msg,
                          int msglen) {
    vop_t v;
    uint8_t *buf;
    int rc = 0, inter = vop_type == 1;
    int ew = 16 * mb_w, eh = 16 * mb_h;
    long ys = 16L * mb_w, cs = 8L * mb_w;
    int16_t blk[6][64];
    memset(&v, 0, sizeof v);
    v.msg = msg;
    v.msglen = msglen;
    if (msglen > 0) msg[0] = 0;
    if (!data || nbytes < 0 || bitpos < 0 || bitpos > nbytes * 8 || mb_w < 1 || mb_h < 1 ||
        mb_w > 512 || mb_h > 512 || width <= 16 * (mb_w - 1) || width > 16 * mb_w ||
        height <= 16 * (mb_h - 1) || height > 16 * mb_h || vop_type < 0 || vop_type > 1 ||
        qscale < 1 || qscale > 31 ||
        fcode < 1 || fcode > 7 || !y || !u || !v_ ||
        (inter && (!ref_y || !ref_u || !ref_v)))
        return -5;
    buf = calloc((size_t)nbytes + 16, 1);
    v.pred[0] = malloc(sizeof(pred_t) * (size_t)(2 * mb_w + 1) * (size_t)(2 * mb_h + 1));
    v.pred[1] = malloc(sizeof(pred_t) * (size_t)(mb_w + 1) * (size_t)(mb_h + 1));
    v.pred[2] = malloc(sizeof(pred_t) * (size_t)(mb_w + 1) * (size_t)(mb_h + 1));
    v.qtab = calloc((size_t)mb_w * (size_t)mb_h, 1);
    v.mv = calloc((size_t)(2 * mb_w + 2) * (size_t)(2 * mb_h + 1), sizeof *v.mv);
    if (!buf || !v.pred[0] || !v.pred[1] || !v.pred[2] || !v.qtab || !v.mv) {
        rc = -2;
        goto out;
    }
    memcpy(buf, data, (size_t)nbytes);
    for (long k = 0; k < (long)(2 * mb_w + 1) * (2 * mb_h + 1); k++) {
        v.pred[0][k].dc = 1024;
        memset(v.pred[0][k].ac, 0, sizeof v.pred[0][k].ac);
    }
    for (int c = 1; c < 3; c++)
        for (long k = 0; k < (long)(mb_w + 1) * (mb_h + 1); k++) {
            v.pred[c][k].dc = 1024;
            memset(v.pred[c][k].ac, 0, sizeof v.pred[c][k].ac);
        }
    v.stats = stats;
    v.b.buf = buf;
    v.b.nbits = nbytes * 8;
    v.b.pos = bitpos;
    v.mb_w = mb_w;
    v.mb_h = mb_h;
    v.width = width;
    v.height = height;
    v.qscale = qscale;
    for (v.mb_y = 0; v.mb_y < mb_h; v.mb_y++) {
        for (v.mb_x = 0; v.mb_x < mb_w; v.mb_x++) {
            int mb_xy = v.mb_y * mb_w + v.mb_x, cbpc, cbpy, cbp, intra, dquant, dc_vlc;
            uint8_t *dy = y + 16L * v.mb_y * ys + 16L * v.mb_x;
            uint8_t *du = u + 8L * v.mb_y * cs + 8L * v.mb_x, *dv = v_ + 8L * v.mb_y * cs + 8L * v.mb_x;
            if (v.b.pos > v.b.nbits) {
                rc = fail(&v, -1, "the VOP's data ends here");
                goto out;
            }
            if (inter) {
                int skipped = 0;
                for (;;) {
                    if (get(&v.b, 1)) { /* not_coded */
                        skipped = 1;
                        break;
                    }
                    cbpc = vlc(&v.b, mcbpc_tab[1], MCBPC_BITS);
                    if (cbpc < 0) {
                        rc = fail(&v, -1, "an invalid mcbpc code");
                        goto out;
                    }
                    if (cbpc != 20) break;
                    if (v.b.pos > v.b.nbits) {
                        rc = fail(&v, -1, "the VOP's data ends in stuffing");
                        goto out;
                    }
                }
                if (skipped) {
                    mc(dy, ys, ref_y, ys, ew, eh, 16 * v.mb_x, 16 * v.mb_y, 0, 16, 1);
                    mc(du, cs, ref_u, cs, ew >> 1, eh >> 1, 8 * v.mb_x, 8 * v.mb_y, 0, 8, 1);
                    mc(dv, cs, ref_v, cs, ew >> 1, eh >> 1, 8 * v.mb_x, 8 * v.mb_y, 0, 8, 1);
                    count(&v, STAT_NOT_CODED);
                    set_mb_mv(&v, 0, 0);
                    v.qtab[mb_xy] = (uint8_t)v.qscale;
                    clean_preds(&v);
                    goto next;
                }
                intra = (cbpc & 4) != 0;
                dquant = cbpc & 8;
            } else {
                do {
                    cbpc = vlc(&v.b, mcbpc_tab[0], MCBPC_BITS);
                    if (cbpc < 0) {
                        rc = fail(&v, -1, "an invalid mcbpc code");
                        goto out;
                    }
                    if (cbpc == 8 && v.b.pos > v.b.nbits) {
                        rc = fail(&v, -1, "the VOP's data ends in stuffing");
                        goto out;
                    }
                } while (cbpc == 8);
                intra = 1;
                dquant = cbpc & 4;
            }
            if (intra) {
                static const int dq[4] = {-1, -2, 1, 2};
                v.ac_pred = (int)get(&v.b, 1);
                if (inter) count(&v, STAT_INTRA_IN_P);
                if (v.ac_pred) count(&v, STAT_AC_PRED);
                cbpy = vlc(&v.b, cbpy_tab, CBPY_BITS);
                if (cbpy < 0) {
                    rc = fail(&v, -1, "an invalid cbpy code");
                    goto out;
                }
                cbp = (cbpc & 3) | (cbpy << 2);
                dc_vlc = v.qscale < dc_thr;
                if (!dc_vlc) count(&v, STAT_DC_AS_AC);
                if (dquant) {
                    count(&v, STAT_DQUANT);
                    v.qscale += dq[get(&v.b, 2)];
                    v.qscale = v.qscale < 1 ? 1 : v.qscale > 31 ? 31 : v.qscale;
                }
                memset(blk, 0, sizeof blk);
                for (int n = 0; n < 6; n++) {
                    rc = decode_block(&v, blk[n], n, (cbp >> (5 - n)) & 1, 1, dc_vlc);
                    if (rc) goto out;
                }
                v.qtab[mb_xy] = (uint8_t)v.qscale;
                set_mb_mv(&v, 0, 0);
                { /* dct_unquantize_h263_intra */
                    int qmul = v.qscale << 1, qadd = (v.qscale - 1) | 1;
                    for (int n = 0; n < 6; n++) {
                        int16_t *k = blk[n];
                        int scale = n < 4 ? y_dc_scale[v.qscale] : c_dc_scale[v.qscale];
                        int dc = k[0] * scale;
                        if (!in_range(dc, scale >> 1)) {
                            rc = fail(&v, -1, "block %d: a DC coefficient of %d", n, dc);
                            goto out;
                        }
                        k[0] = (int16_t)dc;
                        for (int i = 1; i < 64; i++) {
                            int c = k[i] < 0 ? k[i] * qmul - qadd : k[i] > 0 ? k[i] * qmul + qadd : 0;
                            if (!in_range(c, 0)) {
                                rc = fail(&v, -1, "block %d: a coefficient of %d", n, c);
                                goto out;
                            }
                            k[i] = (int16_t)c;
                        }
                    }
                }
                idct(blk[0], dy, ys, 0);
                idct(blk[1], dy + 8, ys, 0);
                idct(blk[2], dy + 8 * ys, ys, 0);
                idct(blk[3], dy + 8 * ys + 8, ys, 0);
                idct(blk[4], du, cs, 0);
                idct(blk[5], dv, cs, 0);
            } else {
                static const int dq[4] = {-1, -2, 1, 2};
                int px, py, mx, my, dxy, uvdxy, sx, sy, rnd = !rounding, half = 0;
                cbpy = vlc(&v.b, cbpy_tab, CBPY_BITS);
                if (cbpy < 0) {
                    rc = fail(&v, -1, "an invalid cbpy code");
                    goto out;
                }
                cbp = (cbpc & 3) | ((cbpy ^ 15) << 2);
                if (dquant) {
                    count(&v, STAT_DQUANT);
                    v.qscale += dq[get(&v.b, 2)];
                    v.qscale = v.qscale < 1 ? 1 : v.qscale > 31 ? 31 : v.qscale;
                }
                v.qtab[mb_xy] = (uint8_t)v.qscale;
                if (!(cbpc & 16)) { /* one vector: h263's mpeg_motion */
                    pred_mv(&v, 0, &px, &py);
                    if ((rc = decode_motion(&v, px, fcode, &mx)) ||
                        (rc = decode_motion(&v, py, fcode, &my)))
                        goto out;
                    set_mb_mv(&v, mx, my);
                    dxy = ((my & 1) << 1) | (mx & 1);
                    sx = 16 * v.mb_x + (mx >> 1);
                    sy = 16 * v.mb_y + (my >> 1);
                    uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
                    if (mc(dy, ys, ref_y, ys, ew, eh, sx, sy, dxy, 16, rnd)) count(&v, STAT_PAST_EDGE);
                    half = dxy || uvdxy;
                    sx >>= 1;
                    sy >>= 1;
                } else { /* four vectors: hpel_motion a block, chroma_4mv_motion */
                    int sum_x = 0, sum_y = 0;
                    count(&v, STAT_FOUR_MV);
                    for (int n = 0; n < 4; n++) {
                        pred_mv(&v, n, &px, &py);
                        if ((rc = decode_motion(&v, px, fcode, &mx)) ||
                            (rc = decode_motion(&v, py, fcode, &my)))
                            goto out;
                        v.mv[mv_index(&v, n)][0] = (int16_t)mx;
                        v.mv[mv_index(&v, n)][1] = (int16_t)my;
                        sum_x += mx;
                        sum_y += my;
                    }
                    for (int n = 0; n < 4; n++) {
                        const int16_t *m = v.mv[mv_index(&v, n)];
                        int bx = clip(16 * v.mb_x + 8 * (n & 1) + (m[0] >> 1), -16, width);
                        int by = clip(16 * v.mb_y + 8 * (n >> 1) + (m[1] >> 1), -16, height);
                        dxy = (bx != width ? m[0] & 1 : 0) | (by != height ? (m[1] & 1) << 1 : 0);
                        if (mc(dy + 8 * (n >> 1) * ys + 8 * (n & 1), ys, ref_y, ys, ew, eh, bx, by,
                               dxy, 8, rnd))
                            count(&v, STAT_PAST_EDGE);
                        half |= dxy;
                    }
                    mx = round_chroma(sum_x);
                    my = round_chroma(sum_y);
                    uvdxy = ((my & 1) << 1) | (mx & 1);
                    sx = clip(8 * v.mb_x + (mx >> 1), -8, width >> 1);
                    sy = clip(8 * v.mb_y + (my >> 1), -8, height >> 1);
                    if (sx == width >> 1) uvdxy &= ~1;
                    if (sy == height >> 1) uvdxy &= ~2;
                    half |= uvdxy;
                }
                if (rounding && half) count(&v, STAT_ROUND_DOWN);
                mc(du, cs, ref_u, cs, ew >> 1, eh >> 1, sx, sy, uvdxy, 8, rnd);
                mc(dv, cs, ref_v, cs, ew >> 1, eh >> 1, sx, sy, uvdxy, 8, rnd);
                clean_preds(&v);
                for (int n = 0; n < 6; n++) {
                    uint8_t *d = n < 4 ? dy + (n >> 1) * 8 * ys + (n & 1) * 8 : n == 4 ? du : dv;
                    if (!((cbp >> (5 - n)) & 1)) continue;
                    memset(blk[n], 0, sizeof blk[n]);
                    rc = decode_block(&v, blk[n], n, 1, 0, 0);
                    if (rc) goto out;
                    idct(blk[n], d, n < 4 ? ys : cs, 1);
                }
            }
        next: {
            int last = mb_xy == mb_w * mb_h - 1, end = after_mb(&v, inter, fcode);
            if (end == 2) {
                rc = fail(&v, -1, "a resync marker in a VOP without resync markers");
                goto out;
            }
            if (last && end != 1) {
                rc = fail(&v, -1, v.b.pos > v.b.nbits ? "the VOP's data ends inside the last macroblock"
                                                      : "the VOP does not end after its last macroblock");
                goto out;
            }
        }
        }
    }
out:
    free(buf);
    free(v.pred[0]);
    free(v.pred[1]);
    free(v.pred[2]);
    free(v.qtab);
    free(v.mv);
    return rc;
}
