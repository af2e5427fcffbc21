/* H.264 intra encoder of one picture (utils/h264.py binds it).
 *
 * A picture is coded as Constrained Baseline I slices with CAVLC: every
 * macroblock is Intra16x16 (4 luma modes), Intra4x4 (9 modes a block) or
 * I_PCM, and chroma takes DC, horizontal, vertical or plane. The modes are
 * chosen by SATD against the source plus lambda times their mode bits; a
 * macroblock whose coded bits exceed those of I_PCM (or whose levels do not
 * fit CAVLC's Baseline escape) is sent as I_PCM. QP is constant; the loop
 * filter is off (disable_deblocking_filter_idc = 1), so the encoder's
 * reconstruction, which later intra prediction reads, is the decoded
 * picture bit for bit.
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

typedef struct {
    int w16, h16, mb_w, mb_h, qp, qpc, lambda;
    uint8_t *sy, *su, *sv;    /* source planes, padded */
    uint8_t *ry, *ru, *rv;    /* reconstruction, padded */
    MbInfo *mb;
} Enc;

typedef struct {
    int type, m16, cmode, cbp;
    int i4[16];
    int luma[16][16];  /* levels, raster; I16: AC only (index 0 unused) */
    int dc[16];        /* I16 DC levels, raster of blocks */
    int cdc[2][4];
    int cac[2][4][16];
} MbCode;

/* Transforms and quantises one 4x4 luma residual `res` into levels `lv`;
 * the transform coefficients go to `w_out` when given (Intra16x16 takes
 * their DCs through its Hadamard). */
static void code_block(const Enc *e, const int *res, int *lv, int *w_out) {
    int qbits = 15 + e->qp / 6, f = (1 << qbits) / 3;
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
        code_block(e, res, c->luma[b], NULL);
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
        code_block(e, res, c->luma[b], w[b]);
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

/* chroma: mode by SAD, transform, quantise and reconstruct both components */
static void code_chroma(Enc *e, int mx, int my, int avail, MbCode *c) {
    int s = e->w16 / 2;
    uint8_t top[2][8], left[2][8], pred[2][64];
    int tl[2];
    uint8_t *src[2] = {e->su + my * 8 * s + mx * 8, e->sv + my * 8 * s + mx * 8};
    uint8_t *rec[2] = {e->ru + my * 8 * s + mx * 8, e->rv + my * 8 * s + mx * 8};
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
    int qpc = e->qpc, qbits = 15 + qpc / 6, f = (1 << qbits) / 3;
    int cbpc = 0;
    for (int k = 0; k < 2; k++) {
        pred_chroma(best, top[k], left[k], tl[k], avail, pred[k]);
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

/* macroblock_layer of an I4 or I16 MB into w; fills cur->nz/nzc. Returns 0,
 * or -1 when a level needs an escape Baseline does not have. */
static int write_mb(BitW *w, const MbCode *c, MbInfo *cur, const MbInfo *lm, const MbInfo *tm) {
    int cbpl = c->cbp & 15, cbpc = c->cbp >> 4, sc[16];
    if (c->type == MB_I4) {
        put_ue(w, 0);
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
        put_ue(w, 1 + c->m16 + 4 * cbpc + (cbpl ? 12 : 0));
        put_ue(w, c->cmode);
        put_se(w, 0);
    }
    memset(cur->nz, 0, sizeof(cur->nz));
    memset(cur->nzc, 0, sizeof(cur->nzc));
    if (c->type == MB_I16) {
        for (int i = 0; i < 16; i++) sc[i] = c->dc[ZIGZAG[i]];
        if (write_block(w, sc, 16, luma_nc(cur, lm, tm, 0, 0)) < 0) return -1;
    }
    for (int b = 0; b < 16; b++) {
        int bx = BLK_X[b], by = BLK_Y[b], n;
        if (!(cbpl & (1 << (b >> 2)))) continue;
        int nc = luma_nc(cur, lm, tm, bx, by);
        if (c->type == MB_I16) {
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

static void write_pcm(BitW *w, Enc *e, int mx, int my, MbInfo *cur) {
    put_ue(w, 25);
    if (w->nbits) put_bits(w, 0, 8 - w->nbits);
    int s = e->w16, cs = e->w16 / 2;
    for (int y = 0; y < 16; y++)
        for (int x = 0; x < 16; x++) {
            uint8_t v = e->sy[(my * 16 + y) * s + mx * 16 + x];
            put_bits(w, v, 8);
            e->ry[(my * 16 + y) * s + mx * 16 + x] = v;
        }
    for (int k = 0; k < 2; k++) {
        uint8_t *src = k ? e->sv : e->su, *rec = k ? e->rv : e->ru;
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                put_bits(w, src[(my * 8 + y) * cs + mx * 8 + x], 8);
                rec[(my * 8 + y) * cs + mx * 8 + x] = src[(my * 8 + y) * cs + mx * 8 + x];
            }
    }
    cur->type = MB_PCM;
    memset(cur->i4, I4_DC, sizeof(cur->i4));
    memset(cur->nz, 16, sizeof(cur->nz));
    memset(cur->nzc, 16, sizeof(cur->nzc));
}

static void encode_mb(Enc *e, BitW *w, BitW *tmp, int mx, int my, int first_mb) {
    int avail = mb_availability(mx, my, e->mb_w, first_mb);
    MbInfo *cur = &e->mb[my * e->mb_w + mx];
    const MbInfo *lm = (avail & 2) ? cur - 1 : NULL;
    const MbInfo *tm = (avail & 1) ? cur - e->mb_w : NULL;
    static const MbCode zero;
    MbCode c4 = zero, c16 = zero;
    uint8_t pred16[256];
    memset(cur, 0, sizeof(*cur));
    int cost16 = try_i16(e, mx, my, avail, &c16, pred16);
    int cost4 = try_i4(e, mx, my, avail, lm, tm, cur, &c4);
    MbCode *c;
    if (cost16 <= cost4) {
        c = &c16;
        c->type = MB_I16;
        memset(cur->i4, I4_DC, sizeof(cur->i4));
        recon_i16(e, mx, my, c, pred16);
    } else {
        c = &c4;
        c->type = MB_I4;
    }
    cur->type = (int8_t)c->type;
    code_chroma(e, mx, my, avail, c);
    tmp->len = 0;
    tmp->nbits = 0;
    tmp->acc = 0;
    tmp->full = 0;
    int ok = write_mb(tmp, c, cur, lm, tm) == 0 && !tmp->full;
    long pcm_bits = 9 + (8 - (bit_count(w) + 9) % 8) % 8 + 384 * 8;
    if (ok && bit_count(tmp) <= pcm_bits) put_from(w, tmp);
    else write_pcm(w, e, mx, my, cur);
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

/* The source planes of the encoder: converted, then padded to whole
 * macroblocks by repeating the last column, then the last row. */
static void source_planes(Enc *e, const uint8_t *rgb, int width, int height) {
    int s = e->w16, cs = e->w16 / 2;
    rgb_to_yuv(rgb, width, height, e->sy, e->su, e->sv, s);
    uint8_t *planes[3] = {e->sy, e->su, e->sv};
    int ws[3] = {width, width / 2, width / 2}, hs[3] = {height, height / 2, height / 2};
    int ss[3] = {s, cs, cs}, ph[3] = {e->h16, e->h16 / 2, e->h16 / 2};
    for (int k = 0; k < 3; k++) {
        uint8_t *p = planes[k];
        for (int y = 0; y < hs[k]; y++) memset(p + y * ss[k] + ws[k], p[y * ss[k] + ws[k] - 1], ss[k] - ws[k]);
        for (int y = hs[k]; y < ph[k]; y++) memcpy(p + y * ss[k], p + (hs[k] - 1) * ss[k], ss[k]);
    }
}

/* The encoder's colour conversion alone: RGB (height x width x 3, both
 * even) -> y (height x width), u and v (height/2 x width/2). Returns 0, -5
 * for a bad argument. */
int hi3d_h264_rgb_to_yuv420(const uint8_t *rgb, int width, int height, uint8_t *y, uint8_t *u, uint8_t *v) {
    if (!rgb || !y || !u || !v || width < 2 || height < 2 || (width & 1) || (height & 1)) return -5;
    rgb_to_yuv(rgb, width, height, y, u, v, width);
    return 0;
}

/* Encodes one RGB picture (height x width x 3, contiguous, both even) as
 * length-prefixed NAL units (4-byte big-endian sizes: an MP4 sample), one
 * slice NAL per `slice_rows` macroblock rows (0: one slice). nal_type 5
 * (IDR, with idr_pic_id) or 1; poc_type 0 writes pic_order_cnt_lsb (8
 * bits), 2 writes none; frame_num is 4 bits. The reconstruction goes to
 * rec_y (height16 x width16), rec_u and rec_v (half each way).
 * Returns 0; -1 if `out` is too small, -2 out of memory, -5 bad argument. */
int hi3d_h264_encode_frame(const uint8_t *rgb, int width, int height, int qp, int slice_rows,
                           int nal_type, int idr_pic_id, int frame_num, int poc_type, int poc_lsb,
                           uint8_t *out, long out_cap, long *out_len,
                           uint8_t *rec_y, uint8_t *rec_u, uint8_t *rec_v) {
    if (!rgb || !out || !out_len || !rec_y || !rec_u || !rec_v) return -5;
    if (width < 2 || height < 2 || (width & 1) || (height & 1) || width > 16384 || height > 16384) return -5;
    if (qp < 0 || qp > 51 || slice_rows < 0 || (nal_type != 5 && nal_type != 1)) return -5;
    if (idr_pic_id < 0 || idr_pic_id > 65535 || frame_num < 0 || frame_num > 15) return -5;
    if ((poc_type != 0 && poc_type != 2) || poc_lsb < 0 || poc_lsb > 255) return -5;
    if (nal_type == 5 && frame_num != 0) return -5;
    Enc e;
    e.mb_w = (width + 15) / 16;
    e.mb_h = (height + 15) / 16;
    e.w16 = e.mb_w * 16;
    e.h16 = e.mb_h * 16;
    e.qp = qp;
    e.qpc = CHROMA_QP[qp];
    {
        static const int LAMBDA[52] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
                                        3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                                        23, 25, 29, 32, 36, 40, 45, 51, 57, 64, 72};
        e.lambda = LAMBDA[qp];
    }
    long ysz = (long)e.w16 * e.h16, csz = ysz / 4;
    uint8_t *planes = malloc(ysz + 2 * csz);
    e.mb = calloc((size_t)e.mb_w * e.mb_h, sizeof(MbInfo));
    long rbsp_cap = (long)e.mb_w * e.mb_h * 400 + 64;
    uint8_t *rbsp = malloc(rbsp_cap);
    uint8_t tmpbuf[4096];
    if (!planes || !e.mb || !rbsp) {
        free(planes);
        free(e.mb);
        free(rbsp);
        return -2;
    }
    e.sy = planes;
    e.su = planes + ysz;
    e.sv = planes + ysz + csz;
    e.ry = rec_y;
    e.ru = rec_u;
    e.rv = rec_v;
    source_planes(&e, rgb, width, height);
    long o = 0;
    int rc = 0;
    int rows = slice_rows > 0 ? slice_rows : e.mb_h;
    for (int y0 = 0; y0 < e.mb_h && rc == 0; y0 += rows) {
        int first = y0 * e.mb_w;
        BitW w = {rbsp, rbsp_cap, 0, 0, 0, 0};
        BitW tmp = {tmpbuf, sizeof(tmpbuf), 0, 0, 0, 0};
        put_ue(&w, (uint32_t)first);
        put_ue(&w, 7); /* I, every slice of the picture */
        put_ue(&w, 0); /* pic_parameter_set_id */
        put_bits(&w, (uint32_t)frame_num, 4);
        if (nal_type == 5) put_ue(&w, (uint32_t)idr_pic_id);
        if (poc_type == 0) put_bits(&w, (uint32_t)poc_lsb, 8);
        if (nal_type == 5) put_bits(&w, 0, 2); /* no_output_of_prior_pics, long_term_reference */
        else put_bits(&w, 0, 1);               /* adaptive_ref_pic_marking_mode_flag */
        put_se(&w, 0);                          /* slice_qp_delta */
        put_ue(&w, 1);                          /* disable_deblocking_filter_idc */
        for (int my = y0; my < y0 + rows && my < e.mb_h; my++)
            for (int mx = 0; mx < e.mb_w; mx++) encode_mb(&e, &w, &tmp, mx, my, first);
        put_bits(&w, 1, 1); /* rbsp_stop_one_bit */
        if (w.nbits) put_bits(&w, 0, 8 - w.nbits);
        if (w.full || o + 5 > out_cap) {
            rc = -1;
            break;
        }
        out[o + 4] = (uint8_t)(0x60 | nal_type); /* nal_ref_idc 3 */
        long n = escape_nal(rbsp, w.len, out + o + 5, out_cap - o - 5);
        if (n < 0) {
            rc = -1;
            break;
        }
        n += 1;
        out[o] = (uint8_t)(n >> 24);
        out[o + 1] = (uint8_t)(n >> 16);
        out[o + 2] = (uint8_t)(n >> 8);
        out[o + 3] = (uint8_t)n;
        o += 4 + n;
    }
    *out_len = o;
    free(planes);
    free(e.mb);
    free(rbsp);
    return rc;
}
