/* Radiance RGBE (.hdr) decoder with fused 2x2 envmap pooling.
 *
 * The OpenRooms per-pixel envmap GT files are 1920x5120 Radiance pictures
 * (dataLoader.py:286-319 in the reference decodes them with cv2.imread and
 * then reshapes/pools in numpy).  cv2's HDR decoder costs ~540 ms per file
 * on this host and the numpy pooling another ~480 ms, which starves the
 * training step (the reference hides the same cost behind 8-16 worker
 * PROCESSES, trainBRDF.py:136-137).  This decoder does ONE pass: RLE
 * scanline decode -> float conversion -> 2x2 block-mean accumulation into
 * the [R, C, eh*ew, 3] output, never materializing the full-size float
 * image.  Called through ctypes (GIL released), so BatchIterator's worker
 * THREADS scale it across cores.
 *
 * Float conversion matches OpenCV's rgbe2float exactly
 * (v = byte * 2^(E-136); 0 when E == 0), and the channel order of the
 * output is BGR to match cv2.imread (the reference keeps envmaps in
 * cv2's BGR order - loadEnvmap does not flip, unlike loadHdr).
 *
 * Format notes (Radiance "32-bit_rle_rgbe"):
 *  - header: text lines to an empty line, then "-Y <H> +X <W>";
 *  - new-style RLE scanline (width in [8, 32767]): 4 bytes
 *    {2, 2, hi, lo}, then 4 independent byte streams (R, G, B, E), each
 *    a sequence of {count > 128: run of (count-128) copies of next byte;
 *    count <= 128: count literal bytes};
 *  - otherwise flat RGBE quadruples, with the old-style {1,1,1,n}
 *    repeat marker supported.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* exponent lookup: v = byte * 2^(E-136), 0 when E == 0 (OpenCV parity).
 * Filled once at dlopen time (library constructors run single-threaded),
 * NOT lazily per call: the decoder is invoked from several GIL-released
 * loader threads at once and a lazy static init would be a data race. */
static float ldexp_tab[256];

__attribute__((constructor)) static void init_ldexp_tab(void) {
    for (int i = 1; i < 256; i++) ldexp_tab[i] = ldexpf(1.0f, i - 136);
    ldexp_tab[0] = 0.0f;
}

/* Decode one new-style RLE channel stream into dst[0..width).
 * Returns bytes consumed from src, or -1 on malformed input. */
static long decode_channel(const uint8_t *src, long avail, uint8_t *dst,
                           long width) {
    long got = 0, used = 0;
    while (got < width) {
        if (used >= avail) return -1;
        int count = src[used++];
        if (count > 128) { /* run */
            count -= 128;
            if (used >= avail || got + count > width) return -1;
            memset(dst + got, src[used++], count);
            got += count;
        } else { /* literals */
            if (count == 0 || got + count > width || used + count > avail)
                return -1;
            memcpy(dst + got, src + used, count);
            used += count;
            got += count;
        }
    }
    return used;
}

/* Parse the text header; returns offset of pixel data and fills h/w,
 * or -1 on failure.  Only the standard "-Y H +X W" orientation is
 * supported (what cv2/Radiance write). */
static long parse_header(const uint8_t *buf, long n, long *h, long *w) {
    long pos = 0;
    if (n < 2 || buf[0] != '#' || buf[1] != '?') return -1;
    int saw_blank = 0;
    while (pos < n) {
        long eol = pos;
        while (eol < n && buf[eol] != '\n') eol++;
        if (eol >= n) return -1;
        if (eol == pos) { /* empty line ends the header */
            saw_blank = 1;
            pos = eol + 1;
            break;
        }
        pos = eol + 1;
    }
    if (!saw_blank) return -1;
    /* resolution line */
    long eol = pos;
    while (eol < n && buf[eol] != '\n') eol++;
    if (eol >= n) return -1;
    char line[128];
    long len = eol - pos < 127 ? eol - pos : 127;
    memcpy(line, buf + pos, len);
    line[len] = 0;
    long hh, ww;
    if (sscanf(line, "-Y %ld +X %ld", &hh, &ww) != 2) return -1;
    *h = hh;
    *w = ww;
    return eol + 1;
}

/* Accumulate one decoded scanline (4 channel planes) into the pooled
 * output.  y: scanline index; file layout rows = R*eh0 + (row inside the
 * per-pixel envmap tile); out[R, C, ehi*ew + ewi, bgr]. */
static void accumulate(const uint8_t *r, const uint8_t *g, const uint8_t *b,
                       const uint8_t *e, long width, long y, float *out,
                       long cols, long eh0, long ew0, long eh, long ew,
                       float inv_pool) {
    long R = y / eh0;
    long ehi = (y % eh0) / (eh0 / eh);
    long d = eh * ew;
    long sx = ew0 / ew;
    /* blocked iteration (C, ewi, k) instead of per-pixel div/mod */
    long x = 0;
    for (long C = 0; C < cols; C++) {
        float *orow = out + ((R * cols + C) * d + ehi * ew) * 3;
        for (long ewi = 0; ewi < ew; ewi++) {
            float ab = 0.0f, ag = 0.0f, ar = 0.0f;
            for (long k = 0; k < sx; k++, x++) {
                float f = ldexp_tab[e[x]];
                ab += (float)b[x] * f;
                ag += (float)g[x] * f;
                ar += (float)r[x] * f;
            }
            float *o = orow + ewi * 3;
            /* BGR order to match cv2.imread */
            o[0] += ab * inv_pool;
            o[1] += ag * inv_pool;
            o[2] += ar * inv_pool;
        }
    }
    (void)width;
}

/* Decode an RGBE file (in-memory bytes) directly into the pooled
 * [rows, cols, eh*ew, 3] float32 output (caller-zeroed).  The file must
 * be rows*eh0 x cols*ew0.  Returns 0 on success, negative error code
 * otherwise. */
int rgbe_decode_pooled(const uint8_t *buf, long n, float *out, long rows,
                       long cols, long eh0, long ew0, long eh, long ew,
                       float scale) {
    long h, w;
    long pos = parse_header(buf, n, &h, &w);
    if (pos < 0) return -2;
    if (h != rows * eh0 || w != cols * ew0) return -3;
    if (eh0 % eh != 0 || ew0 % ew != 0 ||
        (eh0 / eh) != (ew0 / ew))
        return -4;
    long s = eh0 / eh;
    /* exposure scale folded into the pooling weight: saves the caller a
     * separate full-size multiply over the output */
    float inv_pool = scale / (float)(s * s);

    uint8_t *planes = (uint8_t *)malloc(4 * w);
    if (!planes) return -5;
    uint8_t *pr = planes, *pg = planes + w, *pb = planes + 2 * w,
            *pe = planes + 3 * w;

    for (long y = 0; y < h; y++) {
        if (pos + 4 > n) goto fail;
        if (w >= 8 && w < 32768 && buf[pos] == 2 && buf[pos + 1] == 2 &&
            ((long)buf[pos + 2] << 8 | buf[pos + 3]) == w) {
            /* new-style RLE: 4 sequential channel streams */
            pos += 4;
            uint8_t *chan[4] = {pr, pg, pb, pe};
            for (int ci = 0; ci < 4; ci++) {
                long used = decode_channel(buf + pos, n - pos, chan[ci], w);
                if (used < 0) goto fail;
                pos += used;
            }
        } else {
            /* flat RGBE, with old-style {1,1,1,n} repeat markers */
            long x = 0;
            int shift = 0;
            while (x < w) {
                if (pos + 4 > n) goto fail;
                uint8_t R = buf[pos], G = buf[pos + 1], B = buf[pos + 2],
                        E = buf[pos + 3];
                pos += 4;
                if (R == 1 && G == 1 && B == 1) {
                    if (x == 0 || shift > 24) goto fail;
                    long rep = (long)E << shift;
                    if (x + rep > w) goto fail;
                    for (long k = 0; k < rep; k++) {
                        pr[x] = pr[x - 1];
                        pg[x] = pg[x - 1];
                        pb[x] = pb[x - 1];
                        pe[x] = pe[x - 1];
                        x++;
                    }
                    shift += 8;
                } else {
                    pr[x] = R;
                    pg[x] = G;
                    pb[x] = B;
                    pe[x] = E;
                    x++;
                    shift = 0;
                }
            }
        }
        accumulate(pr, pg, pb, pe, w, y, out, cols, eh0, ew0, eh, ew,
                   inv_pool);
    }
    free(planes);
    return 0;
fail:
    free(planes);
    return -6;
}

/* Plain full-resolution decode: out is [h, w, 3] float32 in BGR order
 * (cv2.imread parity).  h/w are validated against expected_h/w when
 * those are positive.  Returns 0 on success. */
int rgbe_decode(const uint8_t *buf, long n, float *out, long expected_h,
                long expected_w) {
    long h, w;
    long pos = parse_header(buf, n, &h, &w);
    if (pos < 0) return -2;
    if ((expected_h > 0 && h != expected_h) ||
        (expected_w > 0 && w != expected_w))
        return -3;

    uint8_t *planes = (uint8_t *)malloc(4 * w);
    if (!planes) return -5;
    uint8_t *pr = planes, *pg = planes + w, *pb = planes + 2 * w,
            *pe = planes + 3 * w;
    for (long y = 0; y < h; y++) {
        if (pos + 4 > n) goto fail;
        if (w >= 8 && w < 32768 && buf[pos] == 2 && buf[pos + 1] == 2 &&
            ((long)buf[pos + 2] << 8 | buf[pos + 3]) == w) {
            pos += 4;
            uint8_t *chan[4] = {pr, pg, pb, pe};
            for (int ci = 0; ci < 4; ci++) {
                long used = decode_channel(buf + pos, n - pos, chan[ci], w);
                if (used < 0) goto fail;
                pos += used;
            }
        } else {
            long x = 0;
            int shift = 0;
            while (x < w) {
                if (pos + 4 > n) goto fail;
                uint8_t R = buf[pos], G = buf[pos + 1], B = buf[pos + 2],
                        E = buf[pos + 3];
                pos += 4;
                if (R == 1 && G == 1 && B == 1) {
                    if (x == 0 || shift > 24) goto fail;
                    long rep = (long)E << shift;
                    if (x + rep > w) goto fail;
                    for (long k = 0; k < rep; k++) {
                        pr[x] = pr[x - 1];
                        pg[x] = pg[x - 1];
                        pb[x] = pb[x - 1];
                        pe[x] = pe[x - 1];
                        x++;
                    }
                    shift += 8;
                } else {
                    pr[x] = R;
                    pg[x] = G;
                    pb[x] = B;
                    pe[x] = E;
                    x++;
                    shift = 0;
                }
            }
        }
        float *row = out + y * w * 3;
        for (long x = 0; x < w; x++) {
            float f = ldexp_tab[pe[x]];
            row[x * 3 + 0] = (float)pb[x] * f;
            row[x * 3 + 1] = (float)pg[x] * f;
            row[x * 3 + 2] = (float)pr[x] * f;
        }
    }
    free(planes);
    return 0;
fail:
    free(planes);
    return -6;
}

/* ABI version of the exported surface.  Bumped whenever any exported
 * signature changes; hdr.py refuses to load a binary whose version
 * differs (a stale cached .so left behind by a failed rebuild would
 * otherwise be called through mismatched ctypes argtypes). */
long rgbe_abi_version(void) { return 2; }

/* Header-only parse: fills h/w, returns 0 on success.  Exported so the
 * Python full-resolution helper (hdr.decode_rgbe) sizes its output with
 * the SAME parser the decoders use - no fixed-size header cap or exact
 * "\n\n" search on the Python side. */
int rgbe_dims(const uint8_t *buf, long n, long *h, long *w) {
    return parse_header(buf, n, h, w) < 0 ? -2 : 0;
}
