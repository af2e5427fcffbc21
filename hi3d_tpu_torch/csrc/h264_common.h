/* What the H.264 intra encoder (h264_encode.c) and its decoder
 * (h264_decode.c) share: the CAVLC code tables of ITU-T H.264 clause 9.2,
 * the transform, quantisation and scaling tables of clause 8.5, the intra
 * prediction of clause 8.3 for 4x4 and 16x16 luma blocks and 8x8 chroma
 * blocks, and the inverse transforms of 8.5.10-8.5.12.
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

/* Per-macroblock state both sides keep for their neighbours' sake. */
typedef struct {
    int8_t type;          /* MB_I4, MB_I16, MB_PCM; MB_NONE before it is coded */
    int8_t i4[16];        /* Intra4x4 modes, raster of 4x4 blocks; 2 (DC) otherwise */
    uint8_t nz[16];       /* TotalCoeff of each luma 4x4 block, raster */
    uint8_t nzc[2][4];    /* TotalCoeff of each chroma AC 4x4 block, raster */
} MbInfo;

enum { MB_NONE = 0, MB_I4 = 1, MB_I16 = 2, MB_PCM = 3 };

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

#endif
