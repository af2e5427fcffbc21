/* H.264 encoder of one slice at a time (utils/h264.py binds it and cuts
 * each picture into slices of whole macroblock rows, which it encodes in
 * parallel host threads, then runs the deblocking filter over the picture).
 *
 * Slices are Constrained Baseline I or P slices with CAVLC. An I macroblock
 * is Intra16x16 (4 luma modes), Intra4x4 (9 modes a block) or I_PCM, and
 * chroma takes DC, horizontal, vertical or plane. A P macroblock is P_Skip,
 * P_L0_16x16, 16x8, 8x16, P_8x8 (8x8 sub-macroblocks) or one of the intra
 * types; its motion comes from an integer search around the predicted
 * vector and (0, 0), refined to half and then quarter samples, against each
 * picture of RefPicList0. Modes are chosen by SATD against the source plus
 * lambda times their bits; a macroblock whose coded bits exceed those of
 * I_PCM (or whose levels do not fit CAVLC's Baseline escape) is sent as
 * I_PCM. QP is constant. Intra prediction reads the unfiltered
 * reconstruction of the picture; the filtered one is what the decoder
 * outputs and what later pictures predict from.
 *
 * Colour (BT.601, limited range, integer):
 *   Y  = ((66 R + 129 G + 25 B + 128) >> 8) + 16
 *   Cb = ((sum over the 2x2 of (-38 R - 74 G + 112 B)) + 512) >> 10) + 128
 *   Cr = ((sum over the 2x2 of (112 R - 94 G - 18 B)) + 512) >> 10) + 128
 * and the planes are padded to whole macroblocks by repeating the last
 * column and row. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "h264_common.h"

/* forward quantisation multipliers: [qP % 6][class of DEQUANT_V] */
static const uint16_t QUANT_MF[6][3] = {
    {13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
    {9362, 3647, 5825}, {8192, 3355, 5243}, {7282, 2893, 4559},
};

/* ------------------------------------------------------------ bit writer */

typedef struct {
    uint8_t *buf;
    long cap, len; /* bytes */
    uint32_t acc;
    int nbits;     /* bits held in acc, < 8 after every put */
    int full;
} BitW;

static void put_bits(BitW *w, uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) {
        w->acc = (w->acc << 1) | ((v >> i) & 1);
        if (++w->nbits == 8) {
            if (w->len < w->cap) w->buf[w->len++] = (uint8_t)w->acc;
            else w->full = 1;
            w->acc = 0;
            w->nbits = 0;
        }
    }
}

static long bit_count(const BitW *w) { return w->len * 8 + w->nbits; }

static void put_ue(BitW *w, uint32_t v) {
    uint32_t x = v + 1;
    int n = 0;
    while ((x >> n) > 1) n++;
    put_bits(w, 0, n);
    put_bits(w, x, n + 1);
}

static void put_se(BitW *w, int v) { put_ue(w, v > 0 ? 2 * v - 1 : -2 * v); }

static void put_from(BitW *w, const BitW *src) { /* appends src's bits */
    for (long i = 0; i < src->len; i++) put_bits(w, src->buf[i], 8);
    put_bits(w, src->acc, src->nbits);
}

/* ------------------------------------------------------------- transforms */

static void fdct4x4(const int *x, int *w) { /* raster in, raster out */
    int t[16];
    for (int i = 0; i < 4; i++) {
        const int *p = x + 4 * i;
        int s03 = p[0] + p[3], d03 = p[0] - p[3], s12 = p[1] + p[2], d12 = p[1] - p[2];
        t[4 * i + 0] = s03 + s12;
        t[4 * i + 1] = 2 * d03 + d12;
        t[4 * i + 2] = s03 - s12;
        t[4 * i + 3] = d03 - 2 * d12;
    }
    for (int j = 0; j < 4; j++) {
        int p0 = t[j], p1 = t[4 + j], p2 = t[8 + j], p3 = t[12 + j];
        int s03 = p0 + p3, d03 = p0 - p3, s12 = p1 + p2, d12 = p1 - p2;
        w[j] = s03 + s12;
        w[4 + j] = 2 * d03 + d12;
        w[8 + j] = s03 - s12;
        w[12 + j] = d03 - 2 * d12;
    }
}

static int quant(int w, int mf, int qbits, int f) {
    int a = w < 0 ? -w : w;
    int l = (int)(((int64_t)a * mf + f) >> qbits);
    return w < 0 ? -l : l;
}

static int satd4x4(const int *d) {
    int t[16], s = 0;
    for (int i = 0; i < 4; i++) {
        const int *p = d + 4 * i;
        int a = p[0] + p[1], b = p[0] - p[1], c = p[2] + p[3], e = p[2] - p[3];
        t[4 * i + 0] = a + c;
        t[4 * i + 1] = b + e;
        t[4 * i + 2] = a - c;
        t[4 * i + 3] = b - e;
    }
    for (int j = 0; j < 4; j++) {
        int a = t[j] + t[4 + j], b = t[j] - t[4 + j], c = t[8 + j] + t[12 + j], e = t[8 + j] - t[12 + j];
        s += abs(a + c) + abs(b + e) + abs(a - c) + abs(b - e);
    }
    return s >> 1;
}

/* ---------------------------------------------------------------- CAVLC */

/* residual_block_cavlc of `maxnum` coefficients given in scan order; nc = -1
 * for chroma DC. Returns TotalCoeff, or -1 when a level is beyond the
 * Baseline escape (level_prefix 15). */
static int write_block(BitW *w, const int *sc, int maxnum, int nc) {
    int level[16], run[16], total = 0, t1 = 0, last = -1;
    for (int i = maxnum - 1; i >= 0; i--) {
        if (!sc[i]) continue;
        if (last >= 0) run[total - 1] = last - i - 1;
        level[total++] = sc[i];
        last = i;
    }
    if (total) run[total - 1] = last; /* zeros below the lowest coefficient */
    while (t1 < total && t1 < 3 && (level[t1] == 1 || level[t1] == -1)) t1++;
    if (nc < 0) {
        put_bits(w, CHROMA_DC_TOKEN_BITS[4 * total + t1], CHROMA_DC_TOKEN_LEN[4 * total + t1]);
    } else {
        int k = nc_class(nc);
        put_bits(w, COEFF_TOKEN_BITS[k][4 * total + t1], COEFF_TOKEN_LEN[k][4 * total + t1]);
    }
    if (!total) return 0;
    for (int i = 0; i < t1; i++) put_bits(w, level[i] < 0, 1);
    int sl = total > 10 && t1 < 3 ? 1 : 0;
    for (int i = t1; i < total; i++) {
        int lv = level[i];
        int code = lv > 0 ? 2 * lv - 2 : -2 * lv - 1;
        if (i == t1 && t1 < 3) code -= 2;
        if (sl == 0) {
            if (code < 14) {
                put_bits(w, 1, code + 1);
            } else if (code < 30) {
                put_bits(w, 1, 15);
                put_bits(w, code - 14, 4);
            } else {
                if (code - 30 >= 4096) return -1;
                put_bits(w, 1, 16);
                put_bits(w, code - 30, 12);
            }
        } else {
            if (code < (15 << sl)) {
                put_bits(w, 1, (code >> sl) + 1);
                put_bits(w, code & ((1 << sl) - 1), sl);
            } else {
                if (code - (15 << sl) >= 4096) return -1;
                put_bits(w, 1, 16);
                put_bits(w, code - (15 << sl), 12);
            }
        }
        if (sl == 0) sl = 1;
        if ((lv < 0 ? -lv : lv) > (3 << (sl - 1)) && sl < 6) sl++;
    }
    int zeros = 0; /* total_zeros: every run, the one below the lowest coefficient included */
    for (int i = 0; i < total; i++) zeros += run[i];
    if (total < maxnum) {
        if (nc < 0) put_bits(w, CHROMA_DC_ZEROS_BITS[total - 1][zeros], CHROMA_DC_ZEROS_LEN[total - 1][zeros]);
        else put_bits(w, TOTAL_ZEROS_BITS[total - 1][zeros], TOTAL_ZEROS_LEN[total - 1][zeros]);
    }
    int left = zeros;
    for (int i = 0; i < total - 1 && left > 0; i++) {
        int k = left > 7 ? 6 : left - 1;
        put_bits(w, RUN_BITS[k][run[i]], RUN_LEN[k][run[i]]);
        left -= run[i];
    }
    return total;
}

/* ----------------------------------------------------------- the encoder */

/* The forced choices of SliceParams.partition, which make a stream take
 * every path of the decoder: a P mb_type 0-4 (P_8x8 and P_8x8ref0 with 8x8
 * sub-macroblocks), P_8x8 with every sub-macroblock 8x4, 4x8 or 4x4, or
 * with the four sub_mb_types in turn, an intra macroblock, I_PCM; and
 * P_Skip, which utils/h264.encode asks for where a frame repeats the one
 * before it, so that the picture decodes as a copy of the last. */
enum {
    FORCE_NONE = -1, FORCE_SUB8x4 = 5, FORCE_SUB4x8, FORCE_SUB4x4, FORCE_SUB_MIXED, FORCE_INTRA, FORCE_PCM,
    FORCE_SKIP
};

/* What a slice is (mirrored by utils/h264._SliceParams) */
typedef struct {
    int32_t mb_w, mb_h;      /* the picture, in macroblocks */
    int32_t first_row, rows; /* the slice's macroblock rows */
    int32_t slice_num, qp;
    int32_t nal_type;        /* 5 (IDR) or 1 */
    int32_t slice_type;      /* 2 (I) or 0 (P) */
    int32_t idr_pic_id, frame_num, poc_type, poc_lsb;
    int32_t nref;            /* num_ref_idx_l0_active of a P slice */
    int32_t filter_idc, filter_a_div2, filter_b_div2;
    int32_t partition;       /* FORCE_NONE, a P mb_type or a FORCE_* */
    int32_t mv_range_y;      /* the level's vertical vector range: -this <= mvy < this, quarter samples */
} SliceParams;

typedef struct {
    int w16, h16, mb_w, mb_h, qp, qpc, lambda;
    const uint8_t *sy, *su, *sv; /* source planes, padded */
    uint8_t *ry, *ru, *rv;       /* reconstruction, padded; unfiltered while the picture is coded */
    MbInfo *mb;
    const SliceParams *sp;
    RefPic refs[16];
    const int32_t *ref_ids;
    int64_t *counts;
} Enc;

typedef struct {
    int type, m16, cmode, cbp;
    int i4[16];
    int luma[16][16];  /* levels, raster; I16: AC only (index 0 unused) */
    int dc[16];        /* I16 DC levels, raster of blocks */
    int cdc[2][4];
    int cac[2][4][16];
} MbCode;

/* An inter macroblock: its P mb_type, sub_mb_types and refIdxL0 of each
 * partition (quadrant for P_8x8), the mvd of each (sub-)partition in syntax
 * order, its motion in `m`, its luma prediction and its cost. */
typedef struct {
    int mbt, sub[4], ref[4], nmvd, mvd[16][2], cost;
    MbInfo m;
    uint8_t pred[256];
} Inter;

static int ue_bits(uint32_t v) {
    int n = 0;
    for (uint32_t x = v + 1; x > 1; x >>= 1) n++;
    return 2 * n + 1;
}

static int se_bits(int v) { return ue_bits(v > 0 ? 2 * v - 1 : -2 * v); }

static int te_bits(int v, int nref) { return nref <= 1 ? 0 : nref == 2 ? 1 : ue_bits((uint32_t)v); }

/* Transforms and quantises one 4x4 luma residual `res` into levels `lv`
 * (dead zone a third of a step for intra, a sixth for inter); the transform
 * coefficients go to `w_out` when given (Intra16x16 takes their DCs through
 * its Hadamard). */
static void code_block(const Enc *e, const int *res, int *lv, int *w_out, int intra) {
    int qbits = 15 + e->qp / 6, f = (1 << qbits) / (intra ? 3 : 6);
    int w[16];
    fdct4x4(res, w);
    for (int i = 0; i < 16; i++) lv[i] = quant(w[i], QUANT_MF[e->qp % 6][coef_class(i)], qbits, f);
    if (w_out) memcpy(w_out, w, sizeof(w));
}

static void reconstruct4x4(const int *d, const uint8_t *pred, int ps, uint8_t *rec, int rs) {
    int r[16];
    idct4x4(d, r);
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) rec[y * rs + x] = clip1(pred[y * ps + x] + r[4 * y + x]);
}

/* Intra4x4 for the MB at (mx, my), reconstructed in place; returns its cost. */
static int try_i4(Enc *e, int mx, int my, int avail, const MbInfo *lm, const MbInfo *tm, MbInfo *cur,
                  MbCode *c) {
    int s = e->w16, cost = 24 * e->lambda;
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b];
        uint8_t top[8], left[4], pred[16], best_pred[16];
        int tl;
        int av = neighbours4x4(e->ry, s, mx, my, bx, by, avail, top, left, &tl);
        int pm = predicted_i4_mode(cur, lm, tm, bx, by);
        const uint8_t *src = e->sy + (my * 16 + by * 4) * s + mx * 16 + bx * 4;
        int best = -1, best_cost = 0;
        for (int m = 0; m < 9; m++) {
            if ((I4_NEEDS[m] & av) != I4_NEEDS[m]) continue;
            pred4x4(m, top, left, tl, av, pred);
            int d[16];
            for (int i = 0; i < 16; i++) d[i] = src[(i >> 2) * s + (i & 3)] - pred[i];
            int cst = satd4x4(d) + e->lambda * (m == pm ? 1 : 4);
            if (best < 0 || cst < best_cost) {
                best = m;
                best_cost = cst;
                memcpy(best_pred, pred, 16);
            }
        }
        cost += best_cost;
        c->i4[b] = best;
        cur->i4[4 * by + bx] = (int8_t)best;
        int res[16], d[16];
        for (int i = 0; i < 16; i++) res[i] = src[(i >> 2) * s + (i & 3)] - best_pred[i];
        code_block(e, res, c->luma[b], NULL, 1);
        dequant4x4(c->luma[b], d, e->qp, 0);
        reconstruct4x4(d, best_pred, 4, e->ry + (my * 16 + by * 4) * s + mx * 16 + bx * 4, s);
    }
    int cbp = 0;
    for (int b = 0; b < 16; b++)
        for (int i = 0; i < 16; i++)
            if (c->luma[b][i]) cbp |= 1 << (b >> 2);
    c->cbp = cbp;
    return cost;
}

/* Intra16x16: the best mode by SATD; returns its cost, codes it into c. */
static int try_i16(Enc *e, int mx, int my, int avail, MbCode *c, uint8_t *pred_out) {
    int s = e->w16;
    uint8_t top[16], left[16], pred[256];
    int tl;
    neighbours_mb(e->ry, s, mx * 16, my * 16, 16, avail, top, left, &tl);
    const uint8_t *src = e->sy + my * 16 * s + mx * 16;
    int best = -1, best_cost = 0;
    for (int m = 0; m < 4; m++) {
        if ((I16_NEEDS[m] & avail) != I16_NEEDS[m]) continue;
        pred16x16(m, top, left, tl, avail, pred);
        int cst = 0;
        for (int b = 0; b < 16; b++) {
            int d[16], x0 = (b & 3) * 4, y0 = (b >> 2) * 4;
            for (int i = 0; i < 16; i++)
                d[i] = src[(y0 + (i >> 2)) * s + x0 + (i & 3)] - pred[(y0 + (i >> 2)) * 16 + x0 + (i & 3)];
            cst += satd4x4(d);
        }
        if (best < 0 || cst < best_cost) {
            best = m;
            best_cost = cst;
            memcpy(pred_out, pred, 256);
        }
    }
    c->m16 = best;
    /* transform every block; the DCs go through the Hadamard */
    int w[16][16], dcm[16];
    int qbits = 15 + e->qp / 6, f = (1 << qbits) / 3;
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], res[16];
        for (int i = 0; i < 16; i++)
            res[i] = src[(by * 4 + (i >> 2)) * s + bx * 4 + (i & 3)] - pred_out[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)];
        code_block(e, res, c->luma[b], w[b], 1);
        c->luma[b][0] = 0;
        dcm[4 * by + bx] = w[b][0];
    }
    int t[16];
    for (int i = 0; i < 4; i++) {
        const int *p = dcm + 4 * i;
        int a = p[0] + p[1], bb = p[0] - p[1], cc = p[2] + p[3], g = p[2] - p[3];
        t[4 * i + 0] = a + cc;
        t[4 * i + 1] = a - cc;
        t[4 * i + 2] = bb - g;
        t[4 * i + 3] = bb + g;
    }
    for (int j = 0; j < 4; j++) {
        int a = t[j] + t[4 + j], bb = t[j] - t[4 + j], cc = t[8 + j] + t[12 + j], g = t[8 + j] - t[12 + j];
        int col[4] = {a + cc, a - cc, bb - g, bb + g};
        for (int i = 0; i < 4; i++) c->dc[4 * i + j] = quant(col[i] / 2, QUANT_MF[e->qp % 6][0], qbits + 1, 2 * f);
    }
    int ac = 0;
    for (int b = 0; b < 16; b++)
        for (int i = 1; i < 16; i++) ac |= c->luma[b][i] != 0;
    c->cbp = ac ? 15 : 0;
    return best_cost;
}

static void recon_i16(Enc *e, int mx, int my, const MbCode *c, const uint8_t *pred) {
    int s = e->w16, dc[16];
    luma_dc_dequant(c->dc, dc, e->qp);
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], d[16];
        dequant4x4(c->luma[b], d, e->qp, 1);
        d[0] = dc[4 * by + bx];
        reconstruct4x4(d, pred + by * 4 * 16 + bx * 4, 16, e->ry + (my * 16 + by * 4) * s + mx * 16 + bx * 4, s);
    }
}

/* Both chroma residuals against `pred`: transformed, quantised (into c,
 * with its cbp's chroma bits) and reconstructed. */
static void code_chroma_residual(Enc *e, int mx, int my, uint8_t (*pred)[64], MbCode *c, int intra) {
    int s = e->w16 / 2;
    const uint8_t *src[2] = {e->su + my * 8 * s + mx * 8, e->sv + my * 8 * s + mx * 8};
    uint8_t *rec[2] = {e->ru + my * 8 * s + mx * 8, e->rv + my * 8 * s + mx * 8};
    int qpc = e->qpc, qbits = 15 + qpc / 6, f = (1 << qbits) / (intra ? 3 : 6);
    int cbpc = 0;
    for (int k = 0; k < 2; k++) {
        int w[4][16];
        for (int b = 0; b < 4; b++) {
            int x0 = (b & 1) * 4, y0 = (b >> 1) * 4, res[16];
            for (int i = 0; i < 16; i++)
                res[i] = src[k][(y0 + (i >> 2)) * s + x0 + (i & 3)] - pred[k][(y0 + (i >> 2)) * 8 + x0 + (i & 3)];
            fdct4x4(res, w[b]);
            c->cac[k][b][0] = 0;
            for (int i = 1; i < 16; i++) {
                c->cac[k][b][i] = quant(w[b][i], QUANT_MF[qpc % 6][coef_class(i)], qbits, f);
                if (c->cac[k][b][i]) cbpc = 2;
            }
        }
        int f0 = w[0][0] + w[1][0] + w[2][0] + w[3][0], f1 = w[0][0] - w[1][0] + w[2][0] - w[3][0];
        int f2 = w[0][0] + w[1][0] - w[2][0] - w[3][0], f3 = w[0][0] - w[1][0] - w[2][0] + w[3][0];
        int fs[4] = {f0, f1, f2, f3};
        for (int i = 0; i < 4; i++) {
            c->cdc[k][i] = quant(fs[i], QUANT_MF[qpc % 6][0], qbits + 1, 2 * f);
            if (c->cdc[k][i] && !cbpc) cbpc = 1;
        }
    }
    c->cbp = (c->cbp & 15) | (cbpc << 4);
    for (int k = 0; k < 2; k++) {
        int dc[4];
        chroma_dc_dequant(c->cdc[k], dc, qpc);
        for (int b = 0; b < 4; b++) {
            int x0 = (b & 1) * 4, y0 = (b >> 1) * 4, d[16];
            dequant4x4(c->cac[k][b], d, qpc, 1);
            d[0] = dc[b];
            reconstruct4x4(d, pred[k] + y0 * 8 + x0, 8, rec[k] + y0 * s + x0, s);
        }
    }
}

/* intra chroma: the mode by SAD, then its residual */
static void code_chroma(Enc *e, int mx, int my, int avail, MbCode *c) {
    int s = e->w16 / 2;
    uint8_t top[2][8], left[2][8], pred[2][64];
    int tl[2];
    const uint8_t *src[2] = {e->su + my * 8 * s + mx * 8, e->sv + my * 8 * s + mx * 8};
    neighbours_mb(e->ru, s, mx * 8, my * 8, 8, avail, top[0], left[0], &tl[0]);
    neighbours_mb(e->rv, s, mx * 8, my * 8, 8, avail, top[1], left[1], &tl[1]);
    int best = -1, best_cost = 0;
    for (int m = 0; m < 4; m++) {
        if ((IC_NEEDS[m] & avail) != IC_NEEDS[m]) continue;
        int cst = 0;
        for (int k = 0; k < 2; k++) {
            uint8_t p[64];
            pred_chroma(m, top[k], left[k], tl[k], avail, p);
            for (int i = 0; i < 64; i++) cst += abs(src[k][(i >> 3) * s + (i & 7)] - p[i]);
        }
        if (best < 0 || cst < best_cost) {
            best = m;
            best_cost = cst;
        }
    }
    c->cmode = best;
    for (int k = 0; k < 2; k++) pred_chroma(best, top[k], left[k], tl[k], avail, pred[k]);
    code_chroma_residual(e, mx, my, pred, c, 1);
}

/* residual() of a macroblock into w; fills cur->nz/nzc. Returns 0, or -1
 * when a level needs an escape Baseline does not have. */
static int write_residual(BitW *w, const MbCode *c, MbInfo *cur, const MbInfo *lm, const MbInfo *tm, int i16) {
    int cbpl = c->cbp & 15, cbpc = c->cbp >> 4, sc[16];
    memset(cur->nz, 0, sizeof(cur->nz));
    memset(cur->nzc, 0, sizeof(cur->nzc));
    if (i16) {
        for (int i = 0; i < 16; i++) sc[i] = c->dc[ZIGZAG[i]];
        if (write_block(w, sc, 16, luma_nc(cur, lm, tm, 0, 0)) < 0) return -1;
    }
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], n;
        if (!(cbpl & (1 << (b >> 2)))) continue;
        int nc = luma_nc(cur, lm, tm, bx, by);
        if (i16) {
            for (int i = 1; i < 16; i++) sc[i - 1] = c->luma[b][ZIGZAG[i]];
            n = write_block(w, sc, 15, nc);
        } else {
            for (int i = 0; i < 16; i++) sc[i] = c->luma[b][ZIGZAG[i]];
            n = write_block(w, sc, 16, nc);
        }
        if (n < 0) return -1;
        cur->nz[4 * by + bx] = (uint8_t)n;
    }
    if (cbpc) {
        for (int k = 0; k < 2; k++)
            if (write_block(w, c->cdc[k], 4, -1) < 0) return -1;
    }
    if (cbpc == 2) {
        for (int k = 0; k < 2; k++)
            for (int b = 0; b < 4; b++) {
                int bx = b & 1, by = b >> 1;
                for (int i = 1; i < 16; i++) sc[i - 1] = c->cac[k][b][ZIGZAG[i]];
                int n = write_block(w, sc, 15, chroma_nc(cur, lm, tm, k, bx, by));
                if (n < 0) return -1;
                cur->nzc[k][b] = (uint8_t)n;
            }
    }
    return 0;
}

/* macroblock_layer of an I4 or I16 MB into w (mb_type plus `type_offset`:
 * 0 in I slices, 5 in P slices); fills cur->nz/nzc. Returns 0, or -1 when
 * a level needs an escape Baseline does not have. */
static int write_mb(BitW *w, const MbCode *c, MbInfo *cur, const MbInfo *lm, const MbInfo *tm, int type_offset) {
    int cbpl = c->cbp & 15, cbpc = c->cbp >> 4;
    if (c->type == MB_I4) {
        put_ue(w, type_offset);
        for (int b = 0; b < 16; b++) {
            int bx = BLK_X[b], by = BLK_Y[b];
            int pm = predicted_i4_mode(cur, lm, tm, bx, by);
            if (c->i4[b] == pm) {
                put_bits(w, 1, 1);
            } else {
                put_bits(w, 0, 1);
                put_bits(w, c->i4[b] < pm ? c->i4[b] : c->i4[b] - 1, 3);
            }
        }
        put_ue(w, c->cmode);
        int code = 0;
        while (INTRA_CBP[code] != c->cbp) code++;
        put_ue(w, code);
        if (c->cbp) put_se(w, 0);
    } else {
        put_ue(w, type_offset + 1 + c->m16 + 4 * cbpc + (cbpl ? 12 : 0));
        put_ue(w, c->cmode);
        put_se(w, 0);
    }
    return write_residual(w, c, cur, lm, tm, c->type == MB_I16);
}

static void write_pcm(BitW *w, Enc *e, int mx, int my, MbInfo *cur, int type_offset) {
    put_ue(w, 25 + type_offset);
    if (w->nbits) put_bits(w, 0, 8 - w->nbits);
    int s = e->w16, cs = e->w16 / 2;
    for (int y = 0; y < 16; y++)
        for (int x = 0; x < 16; x++) {
            uint8_t v = e->sy[(my * 16 + y) * s + mx * 16 + x];
            put_bits(w, v, 8);
            e->ry[(my * 16 + y) * s + mx * 16 + x] = v;
        }
    for (int k = 0; k < 2; k++) {
        const uint8_t *src = k ? e->sv : e->su;
        uint8_t *rec = k ? e->rv : e->ru;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                put_bits(w, src[(my * 8 + y) * cs + mx * 8 + x], 8);
                rec[(my * 8 + y) * cs + mx * 8 + x] = src[(my * 8 + y) * cs + mx * 8 + x];
            }
    }
    cur->type = MB_PCM;
    cur->qp = 0;
    memset(cur->i4, I4_DC, sizeof(cur->i4));
    memset(cur->nz, 16, sizeof(cur->nz));
    memset(cur->nzc, 16, sizeof(cur->nzc));
    memset(cur->ref, -1, sizeof(cur->ref));
    memset(cur->mv, 0, sizeof(cur->mv));
    for (int i = 0; i < 4; i++) cur->refpic[i] = -1;
    e->counts[ST_PCM]++;
}

static void reset_bits(BitW *w) {
    w->len = 0;
    w->nbits = 0;
    w->acc = 0;
    w->full = 0;
}

/* The bits I_PCM would take after a macroblock header starting at bit `at`
 * (mb_type of `type_bits`, alignment, 384 samples) */
static long pcm_bits(long at, int type_bits) { return type_bits + (8 - (at + type_bits) % 8) % 8 + 384 * 8; }

/* Writes the intra macroblock coded in c, or I_PCM where that takes fewer
 * bits or a level needs an escape Baseline lacks. */
static void put_intra(Enc *e, BitW *w, BitW *tmp, int mx, int my, MbInfo *cur, const Nbrs *nb, const MbCode *c,
                      int type_offset) {
    reset_bits(tmp);
    cur->type = (int8_t)c->type;
    int ok = write_mb(tmp, c, cur, nb->a, nb->b, type_offset) == 0 && !tmp->full;
    if (ok && bit_count(tmp) <= pcm_bits(bit_count(w), ue_bits(25 + type_offset))) {
        put_from(w, tmp);
        e->counts[c->type == MB_I4 ? ST_I4 : ST_I16]++;
    } else {
        write_pcm(w, e, mx, my, cur, type_offset);
    }
}

/* The intra choice of the MB at (mx, my): codes (and reconstructs) the
 * better of Intra16x16 and Intra4x4 into c; returns its cost. */
static int choose_intra(Enc *e, int mx, int my, int avail, const Nbrs *nb, MbInfo *cur, MbCode *c) {
    static const MbCode zero;
    MbCode c16 = zero;
    uint8_t pred16[256];
    *c = zero;
    int cost16 = try_i16(e, mx, my, avail, &c16, pred16);
    int cost4 = try_i4(e, mx, my, avail, nb->a, nb->b, cur, c);
    if (cost16 <= cost4) {
        *c = c16;
        c->type = MB_I16;
        memset(cur->i4, I4_DC, sizeof(cur->i4));
        recon_i16(e, mx, my, c, pred16);
    } else {
        c->type = MB_I4;
    }
    code_chroma(e, mx, my, avail, c);
    return cost16 <= cost4 ? cost16 : cost4;
}

/* ------------------------------------------------------------- P macroblocks */

/* x264's decimation score of a 4x4 block's levels: 9 (keep) when a level
 * passes +-1, else the sum over its levels of a weight of the zeros before
 * each (in scan order). */
static int decimate_score(const int *lv) {
    static const uint8_t WEIGHT[16] = {3, 2, 2, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    int i = 15, score = 0;
    while (i >= 0 && !lv[ZIGZAG[i]]) i--;
    while (i >= 0) {
        if (abs(lv[ZIGZAG[i]]) > 1) return 9;
        int run = 0;
        for (i--; i >= 0 && !lv[ZIGZAG[i]]; i--) run++;
        score += WEIGHT[run];
    }
    return score;
}

/* The inter luma residual src - pred as levels in c (and its cbp's luma
 * bits), quadrants of a few +-1 levels (score < 4) and macroblocks of a few
 * (score < 6) dropped as x264 drops them. */
static void quant_inter_luma(const Enc *e, int mx, int my, const uint8_t *pred, MbCode *c) {
    int s = e->w16, score[4] = {0, 0, 0, 0};
    const uint8_t *src = e->sy + (long)my * 16 * s + mx * 16;
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], res[16];
        for (int i = 0; i < 16; i++)
            res[i] = src[(by * 4 + (i >> 2)) * s + bx * 4 + (i & 3)] - pred[(by * 4 + (i >> 2)) * 16 + bx * 4 + (i & 3)];
        code_block(e, res, c->luma[b], NULL, 0);
        score[b >> 2] += decimate_score(c->luma[b]);
    }
    int total = score[0] + score[1] + score[2] + score[3];
    c->cbp = 0;
    for (int q = 0; q < 4; q++) {
        if (score[q] < 4 || total < 6) memset(c->luma[4 * q], 0, 4 * sizeof(c->luma[0]));
        for (int b = 4 * q; b < 4 * q + 4; b++)
            for (int i = 0; i < 16; i++)
                if (c->luma[b][i]) c->cbp |= 1 << q;
    }
}

static void recon_inter_luma(Enc *e, int mx, int my, const uint8_t *pred, const MbCode *c) {
    int s = e->w16;
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], d[16];
        dequant4x4(c->luma[b], d, e->qp, 0);
        reconstruct4x4(d, pred + by * 4 * 16 + bx * 4, 16, e->ry + (long)(my * 16 + by * 4) * s + mx * 16 + bx * 4, s);
    }
}

/* SAD of the bw x bh source block at luma (xa, ya) against the reference
 * block at integer offset (ix, iy), clamped to the picture */
static int sad_int(const Enc *e, const RefPic *r, int xa, int ya, int ix, int iy, int bw, int bh) {
    int s = e->w16, xi = xa + ix, yi = ya + iy, sad = 0;
    const uint8_t *src = e->sy + (long)ya * s + xa;
    if (xi >= 0 && yi >= 0 && xi + bw <= r->w && yi + bh <= r->h) {
        const uint8_t *p = r->y + (long)yi * r->s + xi;
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < bw; x++) sad += abs(src[y * s + x] - p[y * r->s + x]);
        return sad;
    }
    for (int y = 0; y < bh; y++) {
        const uint8_t *p = r->y + (long)clampi(yi + y, 0, r->h - 1) * r->s;
        for (int x = 0; x < bw; x++) sad += abs(src[y * s + x] - p[clampi(xi + x, 0, r->w - 1)]);
    }
    return sad;
}

/* SATD of the bw x bh source block at (xa, ya) against pred (stride 16) */
static int satd_block(const Enc *e, int xa, int ya, const uint8_t *pred, int bw, int bh) {
    int s = e->w16, cost = 0;
    const uint8_t *src = e->sy + (long)ya * s + xa;
    for (int y = 0; y < bh; y += 4)
        for (int x = 0; x < bw; x += 4) {
            int d[16];
            for (int i = 0; i < 16; i++) d[i] = src[(y + (i >> 2)) * s + x + (i & 3)] - pred[(y + (i >> 2)) * 16 + x + (i & 3)];
            cost += satd4x4(d);
        }
    return cost;
}

/* The vector range of the search for a bw x bh block at (xa, ya): at most
 * a few samples past the picture (beyond which the clamped prediction no
 * longer changes), within the level's vertical range (Table A-1). lo/hi in
 * quarter samples. */
static void mv_bounds(const Enc *e, int xa, int ya, int bw, int bh, int *lo, int *hi) {
    lo[0] = 4 * (-xa - bw - 4);
    hi[0] = 4 * (e->w16 - xa + 4);
    lo[1] = 4 * (-ya - bh - 4);
    hi[1] = 4 * (e->h16 - ya + 4);
    if (lo[1] < -e->sp->mv_range_y) lo[1] = -e->sp->mv_range_y;
    if (hi[1] > e->sp->mv_range_y - 1) hi[1] = e->sp->mv_range_y - 1;
    if (lo[0] < -8192) lo[0] = -8192;
    if (hi[0] > 8191) hi[0] = 8191;
}

/* Motion search of the bw x bh block at (x, y) of the MB at (mx, my) in
 * reference r against predicted vector mvp: integer candidates mvp and
 * (0, 0), a square pattern of steps 8, 4, 2, 1 by SAD, then the 8 half and
 * the 8 quarter positions around the best by SATD, each plus lambda times
 * the mvd's bits. Writes the vector and its prediction (into pred, stride
 * 16, at the block's place); returns its cost. */
static int search(const Enc *e, const RefPic *r, int mx, int my, int x, int y, int bw, int bh, const int *mvp,
                  int *mv, uint8_t *pred) {
    int xa = mx * 16 + x, ya = my * 16 + y, lo[2], hi[2], lam = e->lambda;
    mv_bounds(e, xa, ya, bw, bh, lo, hi);
    int ilo[2] = {(lo[0] + 3) >> 2, (lo[1] + 3) >> 2}, ihi[2] = {hi[0] >> 2, hi[1] >> 2};
    int cand[2][2] = {{(mvp[0] + 2) >> 2, (mvp[1] + 2) >> 2}, {0, 0}}, best[2] = {0, 0}, best_cost = -1;
    for (int k = 0; k < 2; k++) {
        int ix = clampi(cand[k][0], ilo[0], ihi[0]), iy = clampi(cand[k][1], ilo[1], ihi[1]);
        int c = sad_int(e, r, xa, ya, ix, iy, bw, bh) + lam * (se_bits(4 * ix - mvp[0]) + se_bits(4 * iy - mvp[1]));
        if (best_cost < 0 || c < best_cost) {
            best_cost = c;
            best[0] = ix;
            best[1] = iy;
        }
    }
    for (int step = 8; step >= 1; step >>= 1)
        for (int iter = 0; iter < 8; iter++) {
            int moved = 0, bx = best[0], by = best[1];
            for (int dy = -step; dy <= step; dy += step)
                for (int dx = -step; dx <= step; dx += step) {
                    int ix = bx + dx, iy = by + dy;
                    if ((!dx && !dy) || ix < ilo[0] || ix > ihi[0] || iy < ilo[1] || iy > ihi[1]) continue;
                    int c = sad_int(e, r, xa, ya, ix, iy, bw, bh) + lam * (se_bits(4 * ix - mvp[0]) + se_bits(4 * iy - mvp[1]));
                    if (c < best_cost) {
                        best_cost = c;
                        best[0] = ix;
                        best[1] = iy;
                        moved = 1;
                    }
                }
            if (!moved) break;
        }
    int q[2] = {4 * best[0], 4 * best[1]}, qbest[2] = {q[0], q[1]};
    uint8_t buf[256];
    mc_luma(r, xa, ya, q, bw, bh, buf, 16);
    best_cost = satd_block(e, xa, ya, buf, bw, bh) + lam * (se_bits(q[0] - mvp[0]) + se_bits(q[1] - mvp[1]));
    for (int step = 2; step >= 1; step--) {
        q[0] = qbest[0];
        q[1] = qbest[1];
        for (int dy = -step; dy <= step; dy += step)
            for (int dx = -step; dx <= step; dx += step) {
                int c2[2] = {q[0] + dx, q[1] + dy};
                if ((!dx && !dy) || c2[0] < lo[0] || c2[0] > hi[0] || c2[1] < lo[1] || c2[1] > hi[1]) continue;
                mc_luma(r, xa, ya, c2, bw, bh, buf, 16);
                int c = satd_block(e, xa, ya, buf, bw, bh) + lam * (se_bits(c2[0] - mvp[0]) + se_bits(c2[1] - mvp[1]));
                if (c < best_cost) {
                    best_cost = c;
                    qbest[0] = c2[0];
                    qbest[1] = c2[1];
                }
            }
    }
    mv[0] = qbest[0];
    mv[1] = qbest[1];
    uint8_t *o = pred + 16 * y + x;
    mc_luma(r, xa, ya, mv, bw, bh, o, 16);
    return best_cost;
}

/* Searches P mb_type `mbt` (with sub_mb_types `sub` for P_8x8) for the
 * macroblock `cur` at (mx, my): each partition, in syntax order, against
 * every reference it may use (refIdxL0 shared by a quadrant's
 * sub-partitions), its vector predicted from the choices before it. Fills
 * `in`, its cost included; in->m is cur with the motion. */
static void search_inter(const Enc *e, int mx, int my, const MbInfo *cur, const Nbrs *nb, int mbt, const int *sub,
                         Inter *in) {
    static const int NONE[4] = {0, 0, 0, 0};
    int nparts = P_PARTS[mbt][0], nref = e->sp->nref;
    sub = sub ? sub : NONE;
    memset(in, 0, sizeof(*in));
    in->mbt = mbt;
    in->m = *cur;
    in->cost = e->lambda * ue_bits((uint32_t)mbt);
    for (int i = 0; i < nparts; i++) {
        int g[4]; /* the partition, or the quadrant of its sub-partitions */
        part_rect(mbt, sub, i, 0, g);
        if (nparts == 4) {
            g[2] = g[3] = 8;
            in->sub[i] = sub[i];
            in->cost += e->lambda * ue_bits((uint32_t)sub[i]);
        }
        int nr = mbt == P_8x8REF0 ? 1 : nref, best_cost = -1, best_mvd[4][2];
        MbInfo best_m = in->m;
        uint8_t best_pred[256];
        for (int rf = 0; rf < nr; rf++) {
            MbInfo m = in->m;
            uint8_t pr[256];
            int cost = mbt == P_8x8REF0 ? 0 : e->lambda * te_bits(rf, nref), mvd[4][2];
            for (int j = 0; j < sub_parts(mbt, sub, i); j++) {
                int r[4], mvp[2], mv[2];
                part_rect(mbt, sub, i, j, r);
                predict_mv(&m, nb, r[0], r[1], r[2], nparts == 2 ? mbt : P_16x16, i, rf, mvp);
                cost += search(e, &e->refs[rf], mx, my, r[0], r[1], r[2], r[3], mvp, mv, pr);
                set_motion(&m, r[0], r[1], r[2], r[3], rf, e->ref_ids[rf], mv);
                mvd[j][0] = mv[0] - mvp[0];
                mvd[j][1] = mv[1] - mvp[1];
            }
            if (best_cost < 0 || cost < best_cost) {
                best_cost = cost;
                best_m = m;
                memcpy(best_mvd, mvd, sizeof(mvd));
                for (int y = g[1]; y < g[1] + g[3]; y++) memcpy(best_pred + 16 * y + g[0], pr + 16 * y + g[0], g[2]);
            }
        }
        in->m = best_m;
        in->ref[i] = best_m.ref[(g[1] >> 3) * 2 + (g[0] >> 3)];
        for (int j = 0; j < sub_parts(mbt, sub, i); j++, in->nmvd++) {
            in->mvd[in->nmvd][0] = best_mvd[j][0];
            in->mvd[in->nmvd][1] = best_mvd[j][1];
        }
        for (int y = g[1]; y < g[1] + g[3]; y++) memcpy(in->pred + 16 * y + g[0], best_pred + 16 * y + g[0], g[2]);
        in->cost += best_cost;
    }
}

/* mb_type, then mb_pred or sub_mb_pred of the inter macroblock `in` */
static void write_inter_header(const Enc *e, BitW *w, const Inter *in) {
    int nparts = P_PARTS[in->mbt][0], nref = e->sp->nref;
    put_ue(w, (uint32_t)in->mbt);
    if (nparts == 4)
        for (int i = 0; i < 4; i++) put_ue(w, (uint32_t)in->sub[i]);
    if (nref > 1 && in->mbt != P_8x8REF0)
        for (int i = 0; i < nparts; i++) {
            if (nref == 2) put_bits(w, !in->ref[i], 1); /* te(v) with cMax 1 */
            else put_ue(w, (uint32_t)in->ref[i]);
        }
    for (int i = 0; i < in->nmvd; i++) {
        put_se(w, in->mvd[i][0]);
        put_se(w, in->mvd[i][1]);
    }
}

/* Counts the coded inter macroblock `in` as the decoder does */
static void count_inter(const Enc *e, int mx, int my, const Inter *in) {
    int nparts = P_PARTS[in->mbt][0], nref = e->sp->nref;
    e->counts[ST_P16x16 + in->mbt]++;
    for (int i = 0; i < 4 && nparts == 4; i++) e->counts[ST_SUB8x8 + in->sub[i]]++;
    for (int i = 0; i < nparts && nref > 1 && in->mbt != P_8x8REF0; i++) {
        e->counts[nref == 2 ? ST_TE_BIT : ST_TE_UE]++;
        e->counts[ST_REF_NONZERO] += in->ref[i] > 0;
    }
    for (int i = 0; i < nparts; i++)
        for (int j = 0; j < sub_parts(in->mbt, in->sub, i); j++) {
            int r[4];
            part_rect(in->mbt, in->sub, i, j, r);
            int mv[2] = {in->m.mv[4 * (r[1] >> 2) + (r[0] >> 2)][0], in->m.mv[4 * (r[1] >> 2) + (r[0] >> 2)][1]};
            count_partition(e->counts, &e->refs[0], mx * 16 + r[0], my * 16 + r[1], r[2], r[3], mv);
        }
}

/* Copies the slice's fields into a macroblock about to be coded */
static void begin_mb(const Enc *e, MbInfo *cur) {
    memset(cur, 0, sizeof(*cur));
    memset(cur->i4, I4_DC, sizeof(cur->i4));
    memset(cur->ref, -1, sizeof(cur->ref));
    for (int i = 0; i < 4; i++) cur->refpic[i] = -1;
    cur->qp = (int8_t)e->qp;
    cur->slice = e->sp->slice_num;
    cur->filter_idc = (int8_t)e->sp->filter_idc;
    cur->filter_a = (int8_t)(2 * e->sp->filter_a_div2);
    cur->filter_b = (int8_t)(2 * e->sp->filter_b_div2);
}

/* Puts the pending mb_skip_run of `*run` macroblocks ending before `addr` */
static void flush_skips(const Enc *e, BitW *w, int *run, int addr) {
    put_ue(w, (uint32_t)*run);
    if (*run && (addr - *run) % e->mb_w + *run > e->mb_w) e->counts[ST_SKIP_RUN_WRAP]++;
    *run = 0;
}

/* P_Skip of the MB at (mx, my) whose motion `m` holds: the prediction is
 * the reconstruction. */
static void put_skip(Enc *e, int mx, int my, MbInfo *cur, const MbInfo *m, const uint8_t *pred,
                     uint8_t (*predc)[64], int *run) {
    int s = e->w16, cs = e->w16 / 2;
    *cur = *m;
    for (int y = 0; y < 16; y++) memcpy(e->ry + (long)(my * 16 + y) * s + mx * 16, pred + 16 * y, 16);
    for (int y = 0; y < 8; y++) {
        memcpy(e->ru + (long)(my * 8 + y) * cs + mx * 8, predc[0] + 8 * y, 8);
        memcpy(e->rv + (long)(my * 8 + y) * cs + mx * 8, predc[1] + 8 * y, 8);
    }
    (*run)++;
    e->counts[ST_SKIP]++;
    int mv[2] = {m->mv[0][0], m->mv[0][1]};
    count_partition(e->counts, &e->refs[0], mx * 16, my * 16, 16, 16, mv);
}

/* One macroblock of a P slice: P_Skip where its prediction leaves nothing
 * to code, else the cheapest of the inter and intra choices. */
static void encode_mb_p(Enc *e, BitW *w, BitW *tmp, int mx, int my, int first_mb, int *run) {
    int addr = my * e->mb_w + mx, avail = mb_availability(mx, my, e->mb_w, first_mb), force = e->sp->partition;
    if (force == P_8x8REF0 && e->sp->nref < 2) force = P_8x8; /* the same, with one reference */
    MbInfo *cur = &e->mb[addr];
    Nbrs nb = neighbours_of(e->mb, e->mb_w, mx, my, avail);
    static const MbCode zero;
    MbCode c = zero;
    uint8_t predc[2][64];
    Inter best, in;
    begin_mb(e, cur);
    cur->type = MB_INTER;
    if (force == FORCE_NONE || force == FORCE_SKIP) { /* P_Skip, when it codes no residual */
        int smv[2];
        pskip_mv(cur, &nb, smv);
        MbInfo m = *cur;
        set_motion(&m, 0, 0, 16, 16, 0, e->ref_ids[0], smv);
        predict_mb(e->refs, mx, my, &m, best.pred, predc);
        if (force == FORCE_SKIP) {
            put_skip(e, mx, my, cur, &m, best.pred, predc, run);
            return;
        }
        quant_inter_luma(e, mx, my, best.pred, &c);
        code_chroma_residual(e, mx, my, predc, &c, 0); /* reconstructs chroma; a coded MB overwrites it */
        if (!c.cbp) {
            put_skip(e, mx, my, cur, &m, best.pred, predc, run);
            return;
        }
    }
    int have_inter = force != FORCE_INTRA && force != FORCE_PCM;
    if (have_inter) {
        static const int SUBS[4][4] = {{0, 0, 0, 0}, {1, 1, 1, 1}, {2, 2, 2, 2}, {3, 3, 3, 3}};
        static const int MIXED[4] = {0, 1, 2, 3};
        if (force == FORCE_NONE) {
            search_inter(e, mx, my, cur, &nb, P_16x16, NULL, &best);
            search_inter(e, mx, my, cur, &nb, P_8x8, NULL, &in);
            if (in.cost < best.cost) { /* the halves only where quarters beat the whole */
                Inter half;
                best = in;
                search_inter(e, mx, my, cur, &nb, P_16x8, NULL, &half);
                if (half.cost < best.cost) best = half;
                search_inter(e, mx, my, cur, &nb, P_8x16, NULL, &half);
                if (half.cost < best.cost) best = half;
            }
        } else if (force <= P_8x8REF0) {
            search_inter(e, mx, my, cur, &nb, force, NULL, &best);
        } else {
            search_inter(e, mx, my, cur, &nb, P_8x8, force == FORCE_SUB_MIXED ? MIXED : SUBS[force - P_8x8REF0], &best);
        }
    }
    if (force == FORCE_PCM) {
        flush_skips(e, w, run, addr);
        write_pcm(w, e, mx, my, cur, 5);
        e->counts[ST_INTRA_IN_P]++;
        return;
    }
    if (force == FORCE_NONE || force == FORCE_INTRA) {
        int intra_cost = choose_intra(e, mx, my, avail, &nb, cur, &c) + 8 * e->lambda;
        if (!have_inter || intra_cost < best.cost) {
            flush_skips(e, w, run, addr);
            put_intra(e, w, tmp, mx, my, cur, &nb, &c, 5);
            e->counts[ST_INTRA_IN_P]++;
            return;
        }
    }
    /* inter */
    c = zero;
    predict_mb(e->refs, mx, my, &best.m, best.pred, predc);
    quant_inter_luma(e, mx, my, best.pred, &c);
    code_chroma_residual(e, mx, my, predc, &c, 0);
    recon_inter_luma(e, mx, my, best.pred, &c);
    *cur = best.m; /* undoes what choose_intra left in it */
    int smv[2];
    pskip_mv(cur, &nb, smv);
    if (force == FORCE_NONE && best.mbt == P_16x16 && best.ref[0] == 0 && !c.cbp && best.m.mv[0][0] == smv[0] &&
        best.m.mv[0][1] == smv[1]) { /* what it codes is P_Skip's */
        (*run)++;
        e->counts[ST_SKIP]++;
        count_partition(e->counts, &e->refs[0], mx * 16, my * 16, 16, 16, smv);
        return;
    }
    reset_bits(tmp);
    write_inter_header(e, tmp, &best);
    int code = 0;
    while (INTER_CBP[code] != c.cbp) code++;
    put_ue(tmp, (uint32_t)code);
    if (c.cbp) put_se(tmp, 0);
    int ok = write_residual(tmp, &c, cur, nb.a, nb.b, 0) == 0 && !tmp->full;
    flush_skips(e, w, run, addr);
    if (ok && bit_count(tmp) <= pcm_bits(bit_count(w), ue_bits(30))) {
        put_from(w, tmp);
        count_inter(e, mx, my, &best);
        return;
    }
    write_pcm(w, e, mx, my, cur, 5);
    e->counts[ST_INTRA_IN_P]++;
}

/* One macroblock of an I slice */
static void encode_mb_i(Enc *e, BitW *w, BitW *tmp, int mx, int my, int first_mb) {
    int avail = mb_availability(mx, my, e->mb_w, first_mb);
    MbInfo *cur = &e->mb[my * e->mb_w + mx];
    Nbrs nb = neighbours_of(e->mb, e->mb_w, mx, my, avail);
    MbCode c;
    begin_mb(e, cur);
    if (e->sp->partition == FORCE_PCM) {
        write_pcm(w, e, mx, my, cur, 0);
        return;
    }
    choose_intra(e, mx, my, avail, &nb, cur, &c);
    put_intra(e, w, tmp, mx, my, cur, &nb, &c, 0);
}

/* RBSP -> NAL payload with emulation prevention; returns bytes written or -1 */
static long escape_nal(const uint8_t *rbsp, long n, uint8_t *out, long cap) {
    long o = 0;
    int zeros = 0;
    for (long i = 0; i < n; i++) {
        if (zeros >= 2 && rbsp[i] <= 3) {
            if (o >= cap) return -1;
            out[o++] = 3;
            zeros = 0;
        }
        if (o >= cap) return -1;
        out[o++] = rbsp[i];
        zeros = rbsp[i] == 0 ? zeros + 1 : 0;
    }
    return o;
}

/* RGB (height x width x 3) -> Y (stride s), Cb, Cr (stride s / 2) by the
 * formula at the top of this file, for the width x height area. */
static void rgb_to_yuv(const uint8_t *rgb, int width, int height, uint8_t *py, uint8_t *pu, uint8_t *pv, int s) {
    int cs = s / 2;
    for (int y = 0; y < height; y++) {
        const uint8_t *p = rgb + (long)y * width * 3;
        for (int x = 0; x < width; x++, p += 3)
            py[(long)y * s + x] = (uint8_t)(((66 * p[0] + 129 * p[1] + 25 * p[2] + 128) >> 8) + 16);
    }
    for (int y = 0; y < height / 2; y++)
        for (int x = 0; x < width / 2; x++) {
            int u = 0, v = 0;
            for (int k = 0; k < 4; k++) {
                const uint8_t *p = rgb + ((long)(2 * y + (k >> 1)) * width + 2 * x + (k & 1)) * 3;
                u += -38 * p[0] - 74 * p[1] + 112 * p[2];
                v += 112 * p[0] - 94 * p[1] - 18 * p[2];
            }
            pu[(long)y * cs + x] = (uint8_t)((u + 512 + (128 << 10)) >> 10);
            pv[(long)y * cs + x] = (uint8_t)((v + 512 + (128 << 10)) >> 10);
        }
}

/* RGB (height x width x 3, contiguous, both even) -> the encoder's source
 * planes y (stride w16 = whole macroblocks), u and v (stride w16 / 2), of
 * h16 rows (h16 / 2): converted, then padded by repeating the last column,
 * then the last row. Returns 0, -5 for a bad argument. */
int hi3d_h264_source_planes(const uint8_t *rgb, int width, int height, uint8_t *sy, uint8_t *su, uint8_t *sv) {
    if (!rgb || !sy || !su || !sv || width < 2 || height < 2 || (width & 1) || (height & 1) || width > 16384 ||
        height > 16384)
        return -5;
    int w16 = (width + 15) / 16 * 16, h16 = (height + 15) / 16 * 16, cs = w16 / 2;
    rgb_to_yuv(rgb, width, height, sy, su, sv, w16);
    uint8_t *planes[3] = {sy, su, sv};
    int ws[3] = {width, width / 2, width / 2}, hs[3] = {height, height / 2, height / 2};
    int ss[3] = {w16, cs, cs}, ph[3] = {h16, h16 / 2, h16 / 2};
    for (int k = 0; k < 3; k++) {
        uint8_t *p = planes[k];
        for (int y = 0; y < hs[k]; y++) memset(p + (long)y * ss[k] + ws[k], p[(long)y * ss[k] + ws[k] - 1], ss[k] - ws[k]);
        for (int y = hs[k]; y < ph[k]; y++) memcpy(p + (long)y * ss[k], p + (long)(hs[k] - 1) * ss[k], ss[k]);
    }
    return 0;
}

/* The encoder's colour conversion alone: RGB (height x width x 3, both
 * even) -> y (height x width), u and v (height/2 x width/2). Returns 0, -5
 * for a bad argument. */
int hi3d_h264_rgb_to_yuv420(const uint8_t *rgb, int width, int height, uint8_t *y, uint8_t *u, uint8_t *v) {
    if (!rgb || !y || !u || !v || width < 2 || height < 2 || (width & 1) || (height & 1)) return -5;
    rgb_to_yuv(rgb, width, height, y, u, v, width);
    return 0;
}

/* Encodes one slice (`sp`) of a picture whose padded source planes are sy,
 * su, sv (hi3d_h264_source_planes) as one length-prefixed NAL unit (4-byte
 * big-endian size, nal_ref_idc 3) into out. A P slice predicts from the
 * sp->nref pictures of refs (y, u, v each: filtered reconstructions of the
 * coded size, most recent first) whose picture ids are ref_ids. The slice's
 * reconstruction (unfiltered) goes into ry, ru, rv (the coded size) and its
 * macroblocks' state into mbinfo (hi3d_h264_mbinfo_size() bytes each, of
 * h264_decode.c), which the deblocking filter (hi3d_h264_deblock, the same
 * code the decoder runs) reads once every slice is coded; counts
 * (ST_COUNT) gets what the slice used.
 * Returns 0; -1 if `out` is too small, -2 out of memory, -5 bad argument. */
int hi3d_h264_encode_slice(const SliceParams *sp, const uint8_t *sy, const uint8_t *su, const uint8_t *sv,
                           uint8_t *const *refs, const int32_t *ref_ids, uint8_t *ry, uint8_t *ru, uint8_t *rv,
                           void *mbinfo, uint8_t *out, long out_cap, long *out_len, int64_t *counts) {
    if (!sp || !sy || !su || !sv || !ry || !ru || !rv || !mbinfo || !out || !out_len || !counts) return -5;
    if (sp->mb_w < 1 || sp->mb_h < 1 || sp->mb_w > 1024 || sp->mb_h > 1024) return -5;
    if (sp->first_row < 0 || sp->rows < 1 || sp->first_row >= sp->mb_h) return -5;
    if (sp->qp < 0 || sp->qp > 51 || (sp->nal_type != 5 && sp->nal_type != 1)) return -5;
    if (sp->slice_type != 2 && sp->slice_type != 0) return -5;
    if (sp->idr_pic_id < 0 || sp->idr_pic_id > 65535 || sp->frame_num < 0 || sp->frame_num > 15) return -5;
    if ((sp->poc_type != 0 && sp->poc_type != 2) || sp->poc_lsb < 0 || sp->poc_lsb > 255) return -5;
    if (sp->nal_type == 5 && (sp->frame_num != 0 || sp->slice_type != 2)) return -5;
    if (sp->filter_idc < 0 || sp->filter_idc > 2 || sp->filter_a_div2 < -6 || sp->filter_a_div2 > 6 ||
        sp->filter_b_div2 < -6 || sp->filter_b_div2 > 6)
        return -5;
    if (sp->partition < FORCE_NONE || sp->partition > FORCE_SKIP || sp->mv_range_y < 256) return -5;
    if (sp->slice_type == 0 && (sp->nref < 1 || sp->nref > 16 || !refs || !ref_ids)) return -5;
    Enc e;
    e.mb_w = sp->mb_w;
    e.mb_h = sp->mb_h;
    e.w16 = e.mb_w * 16;
    e.h16 = e.mb_h * 16;
    e.qp = sp->qp;
    e.qpc = CHROMA_QP[sp->qp];
    {
        static const int LAMBDA[52] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
                                        3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                                        23, 25, 29, 32, 36, 40, 45, 51, 57, 64, 72};
        e.lambda = LAMBDA[sp->qp];
    }
    e.sy = sy;
    e.su = su;
    e.sv = sv;
    e.ry = ry;
    e.ru = ru;
    e.rv = rv;
    e.mb = (MbInfo *)mbinfo;
    e.sp = sp;
    e.ref_ids = ref_ids;
    e.counts = counts;
    for (int i = 0; sp->slice_type == 0 && i < sp->nref; i++) {
        if (!refs[3 * i] || !refs[3 * i + 1] || !refs[3 * i + 2]) return -5;
        RefPic p = {refs[3 * i], refs[3 * i + 1], refs[3 * i + 2], e.w16, e.h16, e.w16};
        e.refs[i] = p;
    }
    int last_row = sp->first_row + sp->rows < e.mb_h ? sp->first_row + sp->rows : e.mb_h;
    long rbsp_cap = (long)e.mb_w * (last_row - sp->first_row) * 420 + 64;
    uint8_t *rbsp = malloc(rbsp_cap);
    uint8_t tmpbuf[4096];
    if (!rbsp) return -2;
    int first = sp->first_row * e.mb_w, p_slice = sp->slice_type == 0;
    BitW w = {rbsp, rbsp_cap, 0, 0, 0, 0};
    BitW tmp = {tmpbuf, sizeof(tmpbuf), 0, 0, 0, 0};
    put_ue(&w, (uint32_t)first);
    put_ue(&w, p_slice ? 5 : 7); /* every slice of the picture has this type */
    put_ue(&w, 0);               /* pic_parameter_set_id */
    put_bits(&w, (uint32_t)sp->frame_num, 4);
    if (sp->nal_type == 5) put_ue(&w, (uint32_t)sp->idr_pic_id);
    if (sp->poc_type == 0) put_bits(&w, (uint32_t)sp->poc_lsb, 8);
    if (p_slice) {
        put_bits(&w, sp->nref != 1, 1); /* num_ref_idx_active_override_flag (the PPS says 1) */
        if (sp->nref != 1) put_ue(&w, (uint32_t)(sp->nref - 1));
        put_bits(&w, 0, 1); /* ref_pic_list_modification_flag_l0 */
    }
    if (sp->nal_type == 5) put_bits(&w, 0, 2); /* no_output_of_prior_pics, long_term_reference */
    else put_bits(&w, 0, 1);                   /* adaptive_ref_pic_marking_mode_flag: the sliding window */
    put_se(&w, 0);                              /* slice_qp_delta */
    put_ue(&w, (uint32_t)sp->filter_idc);       /* disable_deblocking_filter_idc */
    if (sp->filter_idc != 1) {
        put_se(&w, sp->filter_a_div2);
        put_se(&w, sp->filter_b_div2);
    }
    int run = 0;
    for (int my = sp->first_row; my < last_row; my++)
        for (int mx = 0; mx < e.mb_w; mx++) {
            if (p_slice) encode_mb_p(&e, &w, &tmp, mx, my, first, &run);
            else encode_mb_i(&e, &w, &tmp, mx, my, first);
        }
    if (run) {
        flush_skips(&e, &w, &run, last_row * e.mb_w);
        counts[ST_SKIP_RUN_END]++;
    }
    put_bits(&w, 1, 1); /* rbsp_stop_one_bit */
    if (w.nbits) put_bits(&w, 0, 8 - w.nbits);
    int rc = 0;
    long n = -1;
    if (!w.full && out_cap >= 5) {
        out[4] = (uint8_t)(0x60 | sp->nal_type); /* nal_ref_idc 3 */
        n = escape_nal(rbsp, w.len, out + 5, out_cap - 5);
    }
    if (n < 0) {
        rc = -1;
        *out_len = 0;
    } else {
        n += 1;
        out[0] = (uint8_t)(n >> 24);
        out[1] = (uint8_t)(n >> 16);
        out[2] = (uint8_t)(n >> 8);
        out[3] = (uint8_t)n;
        *out_len = 4 + n;
    }
    free(rbsp);
    return rc;
}
