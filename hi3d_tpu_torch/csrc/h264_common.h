/* What the H.264 encoder (h264_encode.c) and its decoder (h264_decode.c)
 * share: the CAVLC code tables of ITU-T H.264 clause 9.2, the transform,
 * quantisation and scaling tables of clause 8.5, the intra prediction of
 * clause 8.3 for 4x4 and 16x16 luma blocks and 8x8 chroma blocks, the
 * inverse transforms of 8.5.10-8.5.12, the motion vector prediction of
 * 8.4.1, the quarter-sample luma and eighth-sample chroma interpolation of
 * 8.4.2.2, and the deblocking filter of 8.7 with its tables.
 *
 * Sample arrays are 8-bit; a 4x4 block is 16 ints in raster order
 * (row-major: index 4*y + x); coefficients in a block are kept in raster
 * order, `ZIGZAG` maps scan position to raster index. */

#ifndef HI3D_H264_COMMON_H
#define HI3D_H264_COMMON_H

#include <stdint.h>
#include <string.h>

/* frame zig-zag scan of a 4x4 block: scan position -> raster index (8.5.6) */
static const uint8_t ZIGZAG[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

/* luma4x4BlkIdx -> (x, y) of the 4x4 block in 4-sample units (6.4.3) */
static const uint8_t BLK_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
static const uint8_t BLK_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

static inline int blk_index(int x, int y) { return 4 * ((y >> 1) * 2 + (x >> 1)) + (y & 1) * 2 + (x & 1); }

/* coeff_token (Table 9-5): [nC class][4 * TotalCoeff + TrailingOnes] */
static const uint8_t COEFF_TOKEN_LEN[4][4 * 17] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6,
     11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11,
     14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15,
     16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4,
     8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9,
     12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13,
     14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4,
     7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6,
     9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6},
};
static const uint8_t COEFF_TOKEN_BITS[4][4 * 17] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3,
     7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4,
     11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8,
     7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4,
     4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4,
     11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8,
     9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11,
     11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12,
     15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10,
     5, 8, 7, 6, 1, 4, 3, 2},
    {3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 58, 59, 60, 61, 62, 63},
};

/* coeff_token of chroma DC in 4:2:0 (nC = -1): [4 * TotalCoeff + TrailingOnes] */
static const uint8_t CHROMA_DC_TOKEN_LEN[4 * 5] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0,
                                                   6, 7, 7, 6, 6, 8, 8, 7};
static const uint8_t CHROMA_DC_TOKEN_BITS[4 * 5] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0,
                                                    3, 3, 2, 5, 2, 3, 2, 0};

/* total_zeros of 4x4 blocks (Tables 9-7, 9-8): [TotalCoeff - 1][total_zeros] */
static const uint8_t TOTAL_ZEROS_LEN[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},
    {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},
    {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},
    {4, 4, 2, 1, 3},
    {3, 3, 1, 2},
    {2, 2, 1},
    {1, 1},
};
static const uint8_t TOTAL_ZEROS_BITS[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},
    {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},
    {0, 1, 1, 1, 1},
    {0, 1, 1, 1},
    {0, 1, 1},
    {0, 1},
};

/* total_zeros of 4:2:0 chroma DC (Table 9-9a): [TotalCoeff - 1][total_zeros] */
static const uint8_t CHROMA_DC_ZEROS_LEN[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
static const uint8_t CHROMA_DC_ZEROS_BITS[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};

/* run_before (Table 9-10): [min(zerosLeft, 7) - 1][run_before] */
static const uint8_t RUN_LEN[7][15] = {
    {1, 1}, {1, 2, 2}, {2, 2, 2, 2}, {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3},
    {2, 3, 3, 3, 3, 3, 3}, {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
static const uint8_t RUN_BITS[7][15] = {
    {1, 0}, {1, 1, 0}, {3, 2, 1, 0}, {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0},
    {3, 0, 1, 3, 2, 5, 4}, {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};

/* coded_block_pattern of Intra_4x4 macroblocks, 4:2:0 (Table 9-4):
 * codeNum -> luma | chroma << 4 */
static const uint8_t INTRA_CBP[48] = {
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
};

/* the Inter column of the same table */
static const uint8_t INTER_CBP[48] = {
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
};

/* P macroblock types 0-4 (Table 7-13): partitions, width, height. 3 is
 * P_8x8, 4 P_8x8ref0 (every refIdxL0 0, none coded); 5-30 are the I types
 * less 5. */
enum { P_16x16, P_16x8, P_8x16, P_8x8, P_8x8REF0 };
static const uint8_t P_PARTS[5][3] = {{1, 16, 16}, {2, 16, 8}, {2, 8, 16}, {4, 8, 8}, {4, 8, 8}};
/* sub_mb_type of P (Table 7-17): partitions, width, height */
static const uint8_t P_SUB_PARTS[4][3] = {{1, 8, 8}, {2, 8, 4}, {2, 4, 8}, {4, 4, 4}};

/* The sub-partitions of partition i of P mb_type `mbt` (sub_mb_types `sub`
 * for P_8x8 and P_8x8ref0; 1 otherwise) */
static inline int sub_parts(int mbt, const int *sub, int i) { return P_PARTS[mbt][0] == 4 ? P_SUB_PARTS[sub[i]][0] : 1; }

/* The rectangle r = (x, y, w, h) in the macroblock of sub-partition j of
 * partition i, in syntax order */
static inline void part_rect(int mbt, const int *sub, int i, int j, int *r) {
    if (P_PARTS[mbt][0] == 4) {
        r[2] = P_SUB_PARTS[sub[i]][1];
        r[3] = P_SUB_PARTS[sub[i]][2];
        r[0] = (i & 1) * 8 + (j * r[2]) % 8;
        r[1] = (i >> 1) * 8 + (j * r[2]) / 8 * r[3];
    } else {
        r[0] = mbt == P_8x16 ? 8 * i : 0;
        r[1] = mbt == P_16x8 ? 8 * i : 0;
        r[2] = P_PARTS[mbt][1];
        r[3] = P_PARTS[mbt][2];
    }
}

/* QPc from qPI (Table 8-15) */
static const uint8_t CHROMA_QP[52] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39,
    39, 39, 39,
};

/* normAdjust4x4 v (8.5.9): [qP % 6][class]; class 0: both coordinates even,
 * 1: both odd, 2: the rest. With flat scaling lists LevelScale4x4 = 16 v. */
static const uint8_t DEQUANT_V[6][3] = {
    {10, 16, 13}, {11, 18, 14}, {13, 20, 16}, {14, 23, 18}, {16, 25, 20}, {18, 29, 23},
};

static inline int coef_class(int i) { /* raster index -> class of DEQUANT_V */
    int x = i & 3, y = i >> 2;
    if (!(x & 1) && !(y & 1)) return 0;
    if ((x & 1) && (y & 1)) return 1;
    return 2;
}

static inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* Inverse 4x4 transform (8.5.12.2): rows, then columns, then (h + 32) >> 6.
 * d: scaled coefficients, raster; r: residual, raster. */
static inline void idct4x4(const int *d, int *r) {
    int t[16];
    for (int i = 0; i < 4; i++) {
        const int *s = d + 4 * i;
        int e0 = s[0] + s[2], e1 = s[0] - s[2];
        int e2 = (s[1] >> 1) - s[3], e3 = s[1] + (s[3] >> 1);
        t[4 * i + 0] = e0 + e3;
        t[4 * i + 1] = e1 + e2;
        t[4 * i + 2] = e1 - e2;
        t[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; j++) {
        int s0 = t[j], s1 = t[4 + j], s2 = t[8 + j], s3 = t[12 + j];
        int e0 = s0 + s2, e1 = s0 - s2;
        int e2 = (s1 >> 1) - s3, e3 = s1 + (s3 >> 1);
        r[j] = (e0 + e3 + 32) >> 6;
        r[4 + j] = (e1 + e2 + 32) >> 6;
        r[8 + j] = (e1 - e2 + 32) >> 6;
        r[12 + j] = (e0 - e3 + 32) >> 6;
    }
}

/* Scaling of 4x4 residual levels (8.5.12.1, flat lists): d = c * v << qP/6;
 * the DC (index 0) is left for the caller when `skip_dc`. */
static inline void dequant4x4(const int *c, int *d, int qp, int skip_dc) {
    const uint8_t *v = DEQUANT_V[qp % 6];
    int sh = qp / 6;
    for (int i = skip_dc; i < 16; i++) d[i] = (c[i] * v[coef_class(i)]) * (1 << sh);
}

/* Intra16x16 DC: inverse Hadamard of the 4x4 DC levels (raster: row = block
 * y, column = block x) and their scaling (8.5.10). */
static inline void luma_dc_dequant(const int *c, int *dc, int qp) {
    int t[16], f[16];
    for (int i = 0; i < 4; i++) {
        const int *s = c + 4 * i;
        int a = s[0] + s[1], b = s[0] - s[1], e = s[2] + s[3], g = s[2] - s[3];
        t[4 * i + 0] = a + e;
        t[4 * i + 1] = a - e;
        t[4 * i + 2] = b - g;
        t[4 * i + 3] = b + g;
    }
    for (int j = 0; j < 4; j++) {
        int a = t[j] + t[4 + j], b = t[j] - t[4 + j], e = t[8 + j] + t[12 + j], g = t[8 + j] - t[12 + j];
        f[j] = a + e;
        f[4 + j] = a - e;
        f[8 + j] = b - g;
        f[12 + j] = b + g;
    }
    int scale = 16 * DEQUANT_V[qp % 6][0];
    for (int i = 0; i < 16; i++) {
        if (qp >= 36)
            dc[i] = (f[i] * scale) * (1 << (qp / 6 - 6));
        else
            dc[i] = (f[i] * scale + (1 << (5 - qp / 6))) >> (6 - qp / 6);
    }
}

/* 4:2:0 chroma DC: 2x2 inverse transform and scaling (8.5.11) */
static inline void chroma_dc_dequant(const int *c, int *dc, int qpc) {
    int f0 = c[0] + c[1] + c[2] + c[3], f1 = c[0] - c[1] + c[2] - c[3];
    int f2 = c[0] + c[1] - c[2] - c[3], f3 = c[0] - c[1] - c[2] + c[3];
    int scale = 16 * DEQUANT_V[qpc % 6][0];
    int sh = qpc / 6;
    dc[0] = ((f0 * scale) * (1 << sh)) >> 5;
    dc[1] = ((f1 * scale) * (1 << sh)) >> 5;
    dc[2] = ((f2 * scale) * (1 << sh)) >> 5;
    dc[3] = ((f3 * scale) * (1 << sh)) >> 5;
}

/* ---------------------------------------------------------- intra prediction */

/* Intra 4x4 prediction modes */
enum { I4_V, I4_H, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU };
/* Intra 16x16 and chroma modes */
enum { I16_V, I16_H, I16_DC, I16_PLANE };
enum { IC_DC, IC_H, IC_V, IC_PLANE };

/* Which neighbours a mode reads: 1 top, 2 left, 4 top-left. */
static const uint8_t I4_NEEDS[9] = {1, 2, 0, 1, 7, 7, 7, 1, 2};
static const uint8_t I16_NEEDS[4] = {1, 2, 0, 7};
static const uint8_t IC_NEEDS[4] = {0, 2, 1, 7};

/* 4x4 luma prediction (8.3.1.2). top[0..7]: p[x,-1] (top-right already
 * substituted when unavailable), left[0..3]: p[-1,y], tl: p[-1,-1];
 * avail: 1 top, 2 left, 4 top-left. out: 16 samples, raster. */
static void pred4x4(int mode, const uint8_t *top, const uint8_t *left, int tl, int avail, uint8_t *out) {
#define T(x) ((x) < 0 ? tl : top[(x)])
#define L(y) ((y) < 0 ? tl : left[(y)])
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
            int v;
            switch (mode) {
            case I4_V: v = top[x]; break;
            case I4_H: v = left[y]; break;
            case I4_DC:
                if ((avail & 3) == 3)
                    v = (top[0] + top[1] + top[2] + top[3] + left[0] + left[1] + left[2] + left[3] + 4) >> 3;
                else if (avail & 2)
                    v = (left[0] + left[1] + left[2] + left[3] + 2) >> 2;
                else if (avail & 1)
                    v = (top[0] + top[1] + top[2] + top[3] + 2) >> 2;
                else
                    v = 128;
                break;
            case I4_DDL:
                if (x == 3 && y == 3) v = (top[6] + 3 * top[7] + 2) >> 2;
                else v = (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2;
                break;
            case I4_DDR:
                if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
                else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
                else v = (top[0] + 2 * tl + left[0] + 2) >> 2;
                break;
            case I4_VR: {
                int z = 2 * x - y;
                if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
                else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
                else if (z == -1) v = (left[0] + 2 * tl + top[0] + 2) >> 2;
                else v = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2;
                break;
            }
            case I4_HD: {
                int z = 2 * y - x;
                if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
                else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
                else if (z == -1) v = (left[0] + 2 * tl + top[0] + 2) >> 2;
                else v = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2;
                break;
            }
            case I4_VL:
                if (!(y & 1)) v = (top[x + (y >> 1)] + top[x + (y >> 1) + 1] + 1) >> 1;
                else v = (top[x + (y >> 1)] + 2 * top[x + (y >> 1) + 1] + top[x + (y >> 1) + 2] + 2) >> 2;
                break;
            default: { /* I4_HU */
                int z = x + 2 * y;
                if (z > 5) v = left[3];
                else if (z == 5) v = (left[2] + 3 * left[3] + 2) >> 2;
                else if (!(z & 1)) v = (left[y + (x >> 1)] + left[y + (x >> 1) + 1] + 1) >> 1;
                else v = (left[y + (x >> 1)] + 2 * left[y + (x >> 1) + 1] + left[y + (x >> 1) + 2] + 2) >> 2;
                break;
            }
            }
            out[4 * y + x] = (uint8_t)v;
        }
#undef T
#undef L
}

/* 16x16 luma prediction (8.3.3): top[0..15], left[0..15], tl; out 256, raster. */
static void pred16x16(int mode, const uint8_t *top, const uint8_t *left, int tl, int avail, uint8_t *out) {
    if (mode == I16_V) {
        for (int y = 0; y < 16; y++) memcpy(out + 16 * y, top, 16);
    } else if (mode == I16_H) {
        for (int y = 0; y < 16; y++) memset(out + 16 * y, left[y], 16);
    } else if (mode == I16_DC) {
        int s = 0, v;
        if ((avail & 3) == 3) {
            for (int i = 0; i < 16; i++) s += top[i] + left[i];
            v = (s + 16) >> 5;
        } else if (avail & 2) {
            for (int i = 0; i < 16; i++) s += left[i];
            v = (s + 8) >> 4;
        } else if (avail & 1) {
            for (int i = 0; i < 16; i++) s += top[i];
            v = (s + 8) >> 4;
        } else {
            v = 128;
        }
        memset(out, v, 256);
    } else {
        int h = 0, vv = 0;
        for (int i = 0; i < 8; i++) {
            h += (i + 1) * (top[8 + i] - (6 - i >= 0 ? top[6 - i] : tl));
            vv += (i + 1) * (left[8 + i] - (6 - i >= 0 ? left[6 - i] : tl));
        }
        int a = 16 * (left[15] + top[15]), b = (5 * h + 32) >> 6, c = (5 * vv + 32) >> 6;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) out[16 * y + x] = clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
    }
}

/* 8x8 chroma prediction, 4:2:0 (8.3.4): top[0..7], left[0..7], tl; out 64. */
static void pred_chroma(int mode, const uint8_t *top, const uint8_t *left, int tl, int avail, uint8_t *out) {
    if (mode == IC_DC) {
        for (int blk = 0; blk < 4; blk++) {
            int xo = (blk & 1) * 4, yo = (blk >> 1) * 4;
            int st = 0, sl = 0, v;
            for (int i = 0; i < 4; i++) {
                st += top[xo + i];
                sl += left[yo + i];
            }
            int ht = avail & 1, hl = (avail & 2) != 0;
            if (xo == yo) {
                v = ht && hl ? (st + sl + 4) >> 3 : hl ? (sl + 2) >> 2 : ht ? (st + 2) >> 2 : 128;
            } else if (xo > 0) {
                v = ht ? (st + 2) >> 2 : hl ? (sl + 2) >> 2 : 128;
            } else {
                v = hl ? (sl + 2) >> 2 : ht ? (st + 2) >> 2 : 128;
            }
            for (int y = 0; y < 4; y++) memset(out + 8 * (yo + y) + xo, v, 4);
        }
    } else if (mode == IC_H) {
        for (int y = 0; y < 8; y++) memset(out + 8 * y, left[y], 8);
    } else if (mode == IC_V) {
        for (int y = 0; y < 8; y++) memcpy(out + 8 * y, top, 8);
    } else {
        int h = 0, vv = 0;
        for (int i = 0; i < 4; i++) {
            h += (i + 1) * (top[4 + i] - (2 - i >= 0 ? top[2 - i] : tl));
            vv += (i + 1) * (left[4 + i] - (2 - i >= 0 ? left[2 - i] : tl));
        }
        int a = 16 * (left[7] + top[7]), b = (34 * h + 32) >> 6, c = (34 * vv + 32) >> 6;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) out[8 * y + x] = clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
    }
}

/* ------------------------------------------------------- picture neighbours */

/* Per-macroblock state both sides keep for their neighbours' and the loop
 * filter's sake. One array of them covers a picture. */
typedef struct {
    int8_t type;          /* MB_I4, MB_I16, MB_PCM, MB_INTER; MB_NONE before it is coded */
    int8_t qp;            /* QP_Y as the loop filter takes it: 0 for I_PCM */
    int8_t filter_idc;    /* the slice's disable_deblocking_filter_idc */
    int8_t filter_a, filter_b; /* the slice's FilterOffsetA and FilterOffsetB */
    int8_t ref[4];        /* refIdxL0 of each 8x8 quadrant, raster; -1 intra */
    int8_t i4[16];        /* Intra4x4 modes, raster of 4x4 blocks; 2 (DC) otherwise */
    uint8_t nz[16];       /* TotalCoeff of each luma 4x4 block, raster */
    uint8_t nzc[2][4];    /* TotalCoeff of each chroma AC 4x4 block, raster */
    int32_t slice;        /* the slice's number in its picture */
    int32_t refpic[4];    /* the picture each quadrant predicts from; -1 intra */
    int16_t mv[16][2];    /* mvL0 of each 4x4 block, raster, quarter samples */
} MbInfo;

enum { MB_NONE = 0, MB_I4 = 1, MB_I16 = 2, MB_PCM = 3, MB_INTER = 4 };

static inline int is_intra(const MbInfo *m) { return m->type >= MB_I4 && m->type <= MB_PCM; }

/* What both sides count (utils/h264.STATS names them in this order). */
enum {
    ST_SKIP, ST_SKIP_RUN_END, ST_SKIP_RUN_WRAP, ST_P16x16, ST_P16x8, ST_P8x16, ST_P8x8, ST_P8x8REF0,
    ST_SUB8x8, ST_SUB8x4, ST_SUB4x8, ST_SUB4x4, ST_INTRA_IN_P, ST_I4, ST_I16, ST_PCM,
    ST_REF_NONZERO, ST_TE_BIT, ST_TE_UE, ST_MV_OUTSIDE, ST_CHROMA_FRAC,
    ST_BS1, ST_BS2, ST_BS3, ST_BS4, ST_SLICE_EDGE_KEPT,
    ST_QPEL, /* 16 counters: luma partitions by (xFrac, yFrac), 4 * yFrac + xFrac */
    ST_COUNT = ST_QPEL + 16
};

/* Gathers the neighbour samples of a 4x4 luma block at (bx, by) (4-sample
 * units) of the MB at (mx, my) in plane `p` of stride `s`. mb_avail: 1 top
 * MB, 2 left MB, 4 top-left MB, 8 top-right MB. Returns the availability
 * mask of pred4x4 (1 top, 2 left, 4 top-left). */
static int neighbours4x4(const uint8_t *p, int s, int mx, int my, int bx, int by, int mb_avail,
                         uint8_t *top, uint8_t *left, int *tl) {
    int x0 = mx * 16 + bx * 4, y0 = my * 16 + by * 4;
    int ht = by > 0 || (mb_avail & 1);
    int hl = bx > 0 || (mb_avail & 2);
    int htl = by > 0 ? (bx > 0 || (mb_avail & 2)) : (bx > 0 ? (mb_avail & 1) : (mb_avail & 4));
    int htr;
    if (by == 0)
        htr = bx < 3 ? (mb_avail & 1) : (mb_avail & 8);
    else
        htr = bx < 3 && blk_index(bx + 1, by - 1) < blk_index(bx, by);
    if (ht) {
        memcpy(top, p + (y0 - 1) * s + x0, 4);
        if (htr) memcpy(top + 4, p + (y0 - 1) * s + x0 + 4, 4);
        else memset(top + 4, top[3], 4);
    } else {
        memset(top, 128, 8);
    }
    if (hl) {
        for (int i = 0; i < 4; i++) left[i] = p[(y0 + i) * s + x0 - 1];
    } else {
        memset(left, 128, 4);
    }
    *tl = htl ? p[(y0 - 1) * s + x0 - 1] : 128;
    return (ht ? 1 : 0) | (hl ? 2 : 0) | (htl ? 4 : 0);
}

/* Neighbour samples of an n x n block (16 luma, 8 chroma) at sample (x0, y0). */
static int neighbours_mb(const uint8_t *p, int s, int x0, int y0, int n, int mb_avail,
                         uint8_t *top, uint8_t *left, int *tl) {
    if (mb_avail & 1) memcpy(top, p + (y0 - 1) * s + x0, n);
    else memset(top, 128, n);
    if (mb_avail & 2) for (int i = 0; i < n; i++) left[i] = p[(y0 + i) * s + x0 - 1];
    else memset(left, 128, n);
    *tl = (mb_avail & 4) ? p[(y0 - 1) * s + x0 - 1] : 128;
    return (mb_avail & 1) | (mb_avail & 2) | (mb_avail & 4);
}

/* MB availability inside one slice that starts at `first_mb` (6.4.8: an
 * address is available when it lies in the picture, in the current slice
 * and before the current macroblock). */
static int mb_availability(int mx, int my, int mb_w, int first_mb) {
    int addr = my * mb_w + mx, a = 0;
    if (my > 0 && addr - mb_w >= first_mb) a |= 1;
    if (mx > 0 && addr - 1 >= first_mb) a |= 2;
    if (mx > 0 && my > 0 && addr - mb_w - 1 >= first_mb) a |= 4;
    if (mx < mb_w - 1 && my > 0 && addr - mb_w + 1 >= first_mb) a |= 8;
    return a;
}

/* predIntra4x4PredMode (8.3.1.1) of block (bx, by) of the MB at `cur`. */
static int predicted_i4_mode(const MbInfo *cur, const MbInfo *left_mb, const MbInfo *top_mb, int bx, int by) {
    int a, b;
    if (bx > 0) a = cur->i4[4 * by + bx - 1];
    else if (left_mb) a = left_mb->type == MB_I4 ? left_mb->i4[4 * by + 3] : I4_DC;
    else return I4_DC;
    if (by > 0) b = cur->i4[4 * (by - 1) + bx];
    else if (top_mb) b = top_mb->type == MB_I4 ? top_mb->i4[12 + bx] : I4_DC;
    else return I4_DC;
    return a < b ? a : b;
}

/* nC of a luma 4x4 block (9.2.1) */
static int luma_nc(const MbInfo *cur, const MbInfo *left_mb, const MbInfo *top_mb, int bx, int by) {
    int na = -1, nb = -1;
    if (bx > 0) na = cur->nz[4 * by + bx - 1];
    else if (left_mb) na = left_mb->nz[4 * by + 3];
    if (by > 0) nb = cur->nz[4 * (by - 1) + bx];
    else if (top_mb) nb = top_mb->nz[12 + bx];
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    return na >= 0 ? na : nb >= 0 ? nb : 0;
}

/* nC of a chroma AC 4x4 block (9.2.1) of component `c` */
static int chroma_nc(const MbInfo *cur, const MbInfo *left_mb, const MbInfo *top_mb, int c, int bx, int by) {
    int na = -1, nb = -1;
    if (bx > 0) na = cur->nzc[c][2 * by];
    else if (left_mb) na = left_mb->nzc[c][2 * by + 1];
    if (by > 0) nb = cur->nzc[c][bx];
    else if (top_mb) nb = top_mb->nzc[c][2 + bx];
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    return na >= 0 ? na : nb >= 0 ? nb : 0;
}

static inline int nc_class(int nc) { return nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3; }


/* ---------------------------------------------------- motion vector prediction */

/* The macroblocks around the current one: left (A), top (B), top-right (C),
 * top-left (D); NULL where not available (6.4.8). */
typedef struct {
    const MbInfo *a, *b, *c, *d;
} Nbrs;

static inline Nbrs neighbours_of(const MbInfo *mbs, int mb_w, int mx, int my, int avail) {
    const MbInfo *cur = mbs + my * mb_w + mx;
    Nbrs n = {(avail & 2) ? cur - 1 : NULL, (avail & 1) ? cur - mb_w : NULL,
              (avail & 8) ? cur - mb_w + 1 : NULL, (avail & 4) ? cur - mb_w - 1 : NULL};
    return n;
}

typedef struct {
    int avail, ref, mv[2]; /* ref -1 (mv 0) where not available or intra */
} MvNb;

/* The motion data of the 4x4 block that holds luma sample (xn, yn),
 * relative to the current macroblock `cur` (6.4.11.7 with Table 6-4). Blocks
 * of `cur` at or after `cur_blk` (a luma4x4BlkIdx) are not decoded yet and
 * so not available. */
static MvNb mv_neighbour(const MbInfo *cur, const Nbrs *n, int xn, int yn, int cur_blk) {
    MvNb r = {0, -1, {0, 0}};
    const MbInfo *m;
    int bx, by;
    if (yn >= 16 || (xn >= 16 && yn >= 0)) return r;
    if (xn >= 0 && xn < 16 && yn >= 0) {
        bx = xn >> 2;
        by = yn >> 2;
        if (blk_index(bx, by) >= cur_blk) return r;
        m = cur;
    } else if (yn < 0) {
        m = xn < 0 ? n->d : xn < 16 ? n->b : n->c;
        bx = xn < 0 ? 3 : xn < 16 ? xn >> 2 : 0;
        by = 3;
    } else {
        m = n->a;
        bx = 3;
        by = yn >> 2;
    }
    if (!m) return r;
    r.avail = 1;
    if (is_intra(m)) return r;
    r.ref = m->ref[(by >> 1) * 2 + (bx >> 1)];
    r.mv[0] = m->mv[4 * by + bx][0];
    r.mv[1] = m->mv[4 * by + bx][1];
    return r;
}

static inline int median3(int a, int b, int c) {
    int lo = a < b ? a : b, hi = a < b ? b : a;
    return c < lo ? lo : c > hi ? hi : c;
}

/* mvpL0 (8.4.1.3) of the partition at (x, y), w x h luma samples, of the
 * current macroblock with refIdxL0 `ref`; `shape` is P_16x8 or P_8x16 for
 * their directional rules (part: the partition's index), else P_16x16. */
static void predict_mv(const MbInfo *cur, const Nbrs *n, int x, int y, int w, int shape, int part, int ref,
                       int *mvp) {
    int blk = blk_index(x >> 2, y >> 2);
    MvNb a = mv_neighbour(cur, n, x - 1, y, blk), b = mv_neighbour(cur, n, x, y - 1, blk);
    MvNb c = mv_neighbour(cur, n, x + w, y - 1, blk);
    if (!c.avail) c = mv_neighbour(cur, n, x - 1, y - 1, blk);
    const MvNb *pick = NULL;
    if (shape == P_16x8) pick = part == 0 ? (b.ref == ref ? &b : NULL) : (a.ref == ref ? &a : NULL);
    else if (shape == P_8x16) pick = part == 0 ? (a.ref == ref ? &a : NULL) : (c.ref == ref ? &c : NULL);
    if (!pick) {
        if (!b.avail && !c.avail && a.avail) b = c = a;
        int match = (a.ref == ref) + (b.ref == ref) + (c.ref == ref);
        if (match == 1) pick = a.ref == ref ? &a : b.ref == ref ? &b : &c;
    }
    if (pick) {
        mvp[0] = pick->mv[0];
        mvp[1] = pick->mv[1];
    } else {
        mvp[0] = median3(a.mv[0], b.mv[0], c.mv[0]);
        mvp[1] = median3(a.mv[1], b.mv[1], c.mv[1]);
    }
}

/* mvL0 of P_Skip (8.4.1.1): zero where A or B is not available or either
 * has refIdxL0 0 and a zero vector, else the 16x16 prediction for ref 0. */
static void pskip_mv(const MbInfo *cur, const Nbrs *n, int *mv) {
    MvNb a = mv_neighbour(cur, n, -1, 0, 0), b = mv_neighbour(cur, n, 0, -1, 0);
    if (!a.avail || !b.avail || (a.ref == 0 && !a.mv[0] && !a.mv[1]) || (b.ref == 0 && !b.mv[0] && !b.mv[1])) {
        mv[0] = mv[1] = 0;
        return;
    }
    predict_mv(cur, n, 0, 0, 16, P_16x16, 0, 0, mv);
}

/* Stores refIdxL0 `ref` (of picture `refpic`) and `mv` into the w x h
 * partition at (x, y) of `m`. */
static void set_motion(MbInfo *m, int x, int y, int w, int h, int ref, int refpic, const int *mv) {
    for (int by = y >> 2; by < (y + h) >> 2; by++)
        for (int bx = x >> 2; bx < (x + w) >> 2; bx++) {
            m->mv[4 * by + bx][0] = (int16_t)mv[0];
            m->mv[4 * by + bx][1] = (int16_t)mv[1];
            m->ref[(by >> 1) * 2 + (bx >> 1)] = (int8_t)ref;
            m->refpic[(by >> 1) * 2 + (bx >> 1)] = refpic;
        }
}

/* ------------------------------------------------------- inter prediction */

/* A reference picture: planes of whole macroblocks (the coded size, which
 * bounds its samples, 8.4.2.2), luma stride s, chroma stride s / 2. */
typedef struct {
    const uint8_t *y, *u, *v;
    int w, h, s; /* luma width and height */
} RefPic;

static inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

/* Luma prediction (8.4.2.2.1) of the bw x bh block at picture sample
 * (x0, y0) moved by `mv` (quarter samples) into out (stride os): the
 * 6-tap filter (1, -5, 20, 20, -5, 1) for half samples, the centre sample j
 * from the unrounded intermediates, quarter samples the rounded-up mean of
 * the two nearest. Returns 1 when the block reads samples outside the
 * picture (which are clamped to its edge). */
static int mc_luma(const RefPic *r, int x0, int y0, const int *mv, int bw, int bh, uint8_t *out, int os) {
    enum { W = 21 };
    uint8_t win[W * W]; /* (bw + 5) x (bh + 5) samples from (xi - 2, yi - 2) */
    int xi = x0 + (mv[0] >> 2), yi = y0 + (mv[1] >> 2), fx = mv[0] & 3, fy = mv[1] & 3;
    int outside = xi - 2 < 0 || yi - 2 < 0 || xi + bw + 3 > r->w || yi + bh + 3 > r->h;
    for (int y = 0; y < bh + 5; y++) {
        int yy = clampi(yi - 2 + y, 0, r->h - 1);
        const uint8_t *row = r->y + (long)yy * r->s;
        if (!outside) {
            memcpy(win + y * W, row + xi - 2, bw + 5);
        } else {
            for (int x = 0; x < bw + 5; x++) win[y * W + x] = row[clampi(xi - 2 + x, 0, r->w - 1)];
        }
    }
#define G(x, y) win[((y) + 2) * W + (x) + 2]
#define TAP(p, d) ((p)[-2 * (d)] - 5 * (p)[-(d)] + 20 * (p)[0] + 20 * (p)[d] - 5 * (p)[2 * (d)] + (p)[3 * (d)])
    if (!fx && !fy) {
        for (int y = 0; y < bh; y++) memcpy(out + y * os, &G(0, y), bw);
        return outside;
    }
    int b1[W][16], bb[17][16], hh[16][17], jj[16][16];
    /* which of b (and s), h (and m) and j the position averages (Table 8-12) */
    int need_b = fx != 0 && fy != 2, need_h = fy != 0 && fx != 2;
    int need_j = (fx == 2 && fy) || (fy == 2 && fx);
    if (need_b || need_j) /* b1 on the window's rows bh + 5 */
        for (int y = 0; y < bh + 5; y++)
            for (int x = 0; x < bw; x++) b1[y][x] = TAP(&win[y * W + x + 2], 1);
    if (need_b)
        for (int y = 0; y < bh + 1; y++)
            for (int x = 0; x < bw; x++) bb[y][x] = clip1((b1[y + 2][x] + 16) >> 5);
    if (need_h)
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < bw + 1; x++) hh[y][x] = clip1((TAP(&G(x, y), W) + 16) >> 5);
    if (need_j)
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < bw; x++) {
                int j1 = b1[y][x] - 5 * b1[y + 1][x] + 20 * b1[y + 2][x] + 20 * b1[y + 3][x] - 5 * b1[y + 4][x] + b1[y + 5][x];
                jj[y][x] = clip1((j1 + 512) >> 10);
            }
#define AVG(a, b) (((a) + (b) + 1) >> 1)
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            int v;
            switch (4 * fy + fx) {
            case 1: v = AVG(G(x, y), bb[y][x]); break;
            case 2: v = bb[y][x]; break;
            case 3: v = AVG(G(x + 1, y), bb[y][x]); break;
            case 4: v = AVG(G(x, y), hh[y][x]); break;
            case 5: v = AVG(bb[y][x], hh[y][x]); break;
            case 6: v = AVG(bb[y][x], jj[y][x]); break;
            case 7: v = AVG(bb[y][x], hh[y][x + 1]); break;
            case 8: v = hh[y][x]; break;
            case 9: v = AVG(hh[y][x], jj[y][x]); break;
            case 10: v = jj[y][x]; break;
            case 11: v = AVG(jj[y][x], hh[y][x + 1]); break;
            case 12: v = AVG(G(x, y + 1), hh[y][x]); break;
            case 13: v = AVG(hh[y][x], bb[y + 1][x]); break;
            case 14: v = AVG(jj[y][x], bb[y + 1][x]); break;
            default: v = AVG(hh[y][x + 1], bb[y + 1][x]); break; /* 15 */
            }
            out[y * os + x] = (uint8_t)v;
        }
#undef AVG
#undef TAP
#undef G
    return outside;
}

/* Chroma prediction (8.4.2.2.2, 4:2:0 frames: the luma vector in eighth
 * chroma samples) of the bw x bh block at chroma sample (x0, y0) of plane
 * p (pw x ph, stride s). */
static void mc_chroma(const uint8_t *p, int pw, int ph, int s, int x0, int y0, const int *mv, int bw, int bh,
                      uint8_t *out, int os) {
    int xi = x0 + (mv[0] >> 3), yi = y0 + (mv[1] >> 3), fx = mv[0] & 7, fy = mv[1] & 7;
    for (int y = 0; y < bh; y++) {
        const uint8_t *r0 = p + (long)clampi(yi + y, 0, ph - 1) * s, *r1 = p + (long)clampi(yi + y + 1, 0, ph - 1) * s;
        for (int x = 0; x < bw; x++) {
            int xa = clampi(xi + x, 0, pw - 1), xb = clampi(xi + x + 1, 0, pw - 1);
            out[y * os + x] = (uint8_t)(((8 - fx) * (8 - fy) * r0[xa] + fx * (8 - fy) * r0[xb] +
                                         (8 - fx) * fy * r1[xa] + fx * fy * r1[xb] + 32) >> 6);
        }
    }
}

/* The luma and chroma prediction of the w x h partition at (x, y) of the
 * macroblock at (mx, my) into pred (16 x 16) and predc (2 x 8 x 8). */
static void predict_partition(const RefPic *r, int mx, int my, int x, int y, int w, int h, const int *mv,
                              uint8_t *pred, uint8_t (*predc)[64]) {
    mc_luma(r, mx * 16 + x, my * 16 + y, mv, w, h, pred + 16 * y + x, 16);
    int cw = r->w / 2, ch = r->h / 2, cs = r->s / 2;
    mc_chroma(r->u, cw, ch, cs, mx * 8 + x / 2, my * 8 + y / 2, mv, w / 2, h / 2, predc[0] + 8 * (y / 2) + x / 2, 8);
    mc_chroma(r->v, cw, ch, cs, mx * 8 + x / 2, my * 8 + y / 2, mv, w / 2, h / 2, predc[1] + 8 * (y / 2) + x / 2, 8);
}

/* The prediction of a whole inter macroblock from the motion data of `m`,
 * one call a run of equal motion (a 16x16, an 8x8, or a 4x4 block). */
static void predict_mb(const RefPic *refs, int mx, int my, const MbInfo *m, uint8_t *pred, uint8_t (*predc)[64]) {
    int same = m->ref[1] == m->ref[0] && m->ref[2] == m->ref[0] && m->ref[3] == m->ref[0];
    for (int i = 1; i < 16 && same; i++) same = m->mv[i][0] == m->mv[0][0] && m->mv[i][1] == m->mv[0][1];
    if (same) {
        int mv[2] = {m->mv[0][0], m->mv[0][1]};
        predict_partition(&refs[m->ref[0]], mx, my, 0, 0, 16, 16, mv, pred, predc);
        return;
    }
    for (int q = 0; q < 4; q++) {
        int qx = (q & 1) * 2, qy = (q >> 1) * 2, r0 = 4 * qy + qx, eq = 1;
        for (int k = 1; k < 4; k++) {
            int i = 4 * (qy + (k >> 1)) + qx + (k & 1);
            eq &= m->mv[i][0] == m->mv[r0][0] && m->mv[i][1] == m->mv[r0][1];
        }
        for (int k = 0; k < (eq ? 1 : 4); k++) {
            int bx = qx + (k & 1), by = qy + (k >> 1), mv[2] = {m->mv[4 * by + bx][0], m->mv[4 * by + bx][1]};
            predict_partition(&refs[m->ref[q]], mx, my, 4 * bx, 4 * by, eq ? 8 : 4, eq ? 8 : 4, mv, pred, predc);
        }
    }
}

/* Counts one motion partition: its interpolation position, a chroma
 * fraction, and reads past the picture (with the 6-tap's reach). (xa, ya)
 * is its luma position in the picture. */
static void count_partition(int64_t *counts, const RefPic *r, int xa, int ya, int w, int h, const int *mv) {
    int xi = xa + (mv[0] >> 2), yi = ya + (mv[1] >> 2);
    counts[ST_QPEL + 4 * (mv[1] & 3) + (mv[0] & 3)]++;
    counts[ST_CHROMA_FRAC] += ((mv[0] | mv[1]) & 7) != 0;
    counts[ST_MV_OUTSIDE] += xi - 2 < 0 || yi - 2 < 0 || xi + w + 3 > r->w || yi + h + 3 > r->h;
}

/* ------------------------------------------------------- deblocking filter */

/* alpha' and beta' (Table 8-16) and tC0' for bS 1-3 (Table 8-17) by indexA/B */
static const uint8_t ALPHA[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9, 10, 12, 13,
                                  15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127,
                                  144, 162, 182, 203, 226, 255, 255};
static const uint8_t BETA[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
                                 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
                                 17, 17, 18, 18};
static const uint8_t TC0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 1},
    {1, 1, 2}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8}, {4, 6, 9}, {5, 7, 10}, {6, 8, 11},
    {6, 8, 13}, {7, 10, 14}, {8, 11, 16}, {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25},
};

static inline int iabs(int v) { return v < 0 ? -v : v; }

/* bS (8.7.2.1) of the edge between 4x4 luma blocks (pbx, pby) of p and
 * (qbx, qby) of q; `mb_edge` when they lie in two macroblocks. */
static int edge_strength(const MbInfo *p, int pbx, int pby, const MbInfo *q, int qbx, int qby, int mb_edge) {
    if (is_intra(p) || is_intra(q)) return mb_edge ? 4 : 3;
    int pi = 4 * pby + pbx, qi = 4 * qby + qbx;
    if (p->nz[pi] || q->nz[qi]) return 2;
    if (p->refpic[(pby >> 1) * 2 + (pbx >> 1)] != q->refpic[(qby >> 1) * 2 + (qbx >> 1)]) return 1;
    if (iabs(p->mv[pi][0] - q->mv[qi][0]) >= 4 || iabs(p->mv[pi][1] - q->mv[qi][1]) >= 4) return 1;
    return 0;
}

/* Filters `n` sample positions across one edge (8.7.2.3, 8.7.2.4): q0 of
 * the first at `q`, `across` the step from p0 to q0, `along` the step to the
 * next position; bs[i / per] is the strength of position i. */
static void filter_edge(uint8_t *q, int across, int along, int n, int per, const int *bs, int qpav, int fa, int fb,
                        int chroma) {
    int ia = clampi(qpav + fa, 0, 51), ib = clampi(qpav + fb, 0, 51);
    int alpha = ALPHA[ia], beta = BETA[ib];
    if (!alpha || !beta) return;
    for (int i = 0; i < n; i++, q += along) {
        int s = bs[i / per];
        if (!s) continue;
        int p0 = q[-across], p1 = q[-2 * across], q0 = q[0], q1 = q[across];
        if (iabs(p0 - q0) >= alpha || iabs(p1 - p0) >= beta || iabs(q1 - q0) >= beta) continue;
        if (chroma) {
            if (s < 4) {
                int tc = TC0[ia][s - 1] + 1;
                int d = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
                q[-across] = clip1(p0 + d);
                q[0] = clip1(q0 - d);
            } else {
                q[-across] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
                q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
            }
            continue;
        }
        int p2 = q[-3 * across], q2 = q[2 * across];
        int ap = iabs(p2 - p0), aq = iabs(q2 - q0);
        if (s < 4) {
            int tc0 = TC0[ia][s - 1], tc = tc0 + (ap < beta) + (aq < beta);
            int d = clampi((((q0 - p0) * 4) + (p1 - q1) + 4) >> 3, -tc, tc);
            q[-across] = clip1(p0 + d);
            q[0] = clip1(q0 - d);
            if (ap < beta) q[-2 * across] = (uint8_t)(p1 + clampi((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0));
            if (aq < beta) q[across] = (uint8_t)(q1 + clampi((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0));
        } else {
            int p3 = q[-4 * across], q3 = q[3 * across];
            int strong = iabs(p0 - q0) < ((alpha >> 2) + 2);
            if (ap < beta && strong) {
                q[-across] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                q[-2 * across] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
                q[-3 * across] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
            } else {
                q[-across] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
            }
            if (aq < beta && strong) {
                q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
                q[across] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
                q[2 * across] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
            } else {
                q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
            }
        }
    }
}

static inline int chroma_qp_of(int qp, int offset) { return CHROMA_QP[clampi(qp + offset, 0, 51)]; }

/* The deblocking filter (8.7) over a decoded picture of mb_w x mb_h
 * macroblocks, in place: macroblocks in raster order, in each the vertical
 * edges left to right, then the horizontal edges top to bottom, luma, then
 * chroma on its edges 0 and 4 with the bS of luma edges 0 and 8. Each
 * macroblock's slice decides whether and how its edges are filtered. */
static void deblock_picture(uint8_t *py, uint8_t *pu, uint8_t *pv, int mb_w, int mb_h, const MbInfo *mbs,
                            int cqp_offset, int64_t *counts) {
    int s = mb_w * 16, cs = mb_w * 8;
    for (int my = 0; my < mb_h; my++)
        for (int mx = 0; mx < mb_w; mx++) {
            const MbInfo *q = mbs + my * mb_w + mx;
            if (q->filter_idc == 1) continue;
            const MbInfo *left = mx > 0 ? q - 1 : NULL, *top = my > 0 ? q - mb_w : NULL;
            if (q->filter_idc == 2) {
                if (left && left->slice != q->slice) left = NULL;
                if (top && top->slice != q->slice) top = NULL;
            } else if (counts) {
                counts[ST_SLICE_EDGE_KEPT] += (left && left->slice != q->slice) + (top && top->slice != q->slice);
            }
            for (int dir = 0; dir < 2; dir++) { /* 0: vertical edges, 1: horizontal */
                const MbInfo *pm = dir ? top : left;
                int bs[4][4];
                for (int e = 0; e < 4; e++)
                    for (int k = 0; k < 4; k++) {
                        const MbInfo *p = e ? q : pm;
                        bs[e][k] = !p ? 0
                                   : dir ? edge_strength(p, k, e ? e - 1 : 3, q, k, e, !e)
                                         : edge_strength(p, e ? e - 1 : 3, k, q, e, k, !e);
                    }
                for (int e = 0; e < 4; e++) {
                    const MbInfo *p = e ? q : pm;
                    if (!p) continue;
                    if (counts)
                        for (int k = 0; k < 4; k++)
                            if (bs[e][k] && ALPHA[clampi(((p->qp + q->qp + 1) >> 1) + q->filter_a, 0, 51)])
                                counts[ST_BS1 + bs[e][k] - 1]++;
                    uint8_t *o = dir ? py + (long)(my * 16 + 4 * e) * s + mx * 16 : py + (long)my * 16 * s + mx * 16 + 4 * e;
                    filter_edge(o, dir ? s : 1, dir ? 1 : s, 16, 4, bs[e], (p->qp + q->qp + 1) >> 1, q->filter_a,
                                q->filter_b, 0);
                    if (e & 1) continue;
                    int qpc = (chroma_qp_of(p->qp, cqp_offset) + chroma_qp_of(q->qp, cqp_offset) + 1) >> 1;
                    for (int k = 0; k < 2; k++) {
                        uint8_t *c = k ? pv : pu;
                        uint8_t *oc = dir ? c + (long)(my * 8 + 2 * e) * cs + mx * 8 : c + (long)my * 8 * cs + mx * 8 + 2 * e;
                        filter_edge(oc, dir ? cs : 1, dir ? 1 : cs, 8, 2, bs[e], qpc, q->filter_a, q->filter_b, 1);
                    }
                }
            }
        }
}

#endif
