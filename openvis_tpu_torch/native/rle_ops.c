/* Native RLE kernels for the video-instance evaluators.
 *
 * The reference delegates RLE work to pycocotools' C core; this is the
 * equivalent for openvis-tpu: column-major run-length encode/decode and a
 * run-walk intersection/area that never materializes the masks — the hot
 * path of the spatio-temporal IoU in the YTVIS/BURST evaluators
 * (evals/ytvoseval.py:207-225 semantics).
 *
 * Copy of openvis_tpu/native/rle_ops.c.  Built as a plain shared library
 * into openvis_tpu_torch/_build/ and loaded via ctypes
 * (openvis_tpu_torch/native/__init__.py); the pure-Python encoder of
 * openvis_tpu_torch/data/rle.py is its plain version.
 */

#include <stdint.h>
#include <stddef.h>

/* Encode a column-major (Fortran) flattened binary mask into alternating
 * background/foreground run lengths.  Returns the number of runs written,
 * or -1 if max_counts would overflow.  Counts always start with a
 * (possibly zero) background run. */
long rle_encode(const uint8_t *flat, long n, long *counts, long max_counts) {
    long k = 0;
    uint8_t val = 0;
    long run = 0;
    for (long i = 0; i < n; i++) {
        if (flat[i] != val) {
            if (k >= max_counts) return -1;
            counts[k++] = run;
            run = 0;
            val = !val;
        }
        run++;
    }
    if (k >= max_counts) return -1;
    counts[k++] = run;
    return k;
}

/* Decode run lengths into a column-major flattened mask (caller zeroes or
 * we overwrite fully).  Returns 0 on success, -1 on overflow. */
long rle_decode(const long *counts, long k, uint8_t *flat, long n) {
    long pos = 0;
    uint8_t val = 0;
    for (long i = 0; i < k; i++) {
        long c = counts[i];
        if (pos + c > n) return -1;
        for (long j = 0; j < c; j++) flat[pos + j] = val;
        pos += c;
        val = !val;
    }
    while (pos < n) flat[pos++] = 0;
    return 0;
}

/* Foreground area of an RLE. */
long rle_area(const long *counts, long k) {
    long a = 0;
    for (long i = 1; i < k; i += 2) a += counts[i];
    return a;
}

/* Run-walk intersection of two RLEs (no decode).  Writes intersection and
 * union pixel counts. */
void rle_intersection_union(const long *ca, long ka, const long *cb, long kb,
                            long *inter_out, long *union_out) {
    long ia = 0, ib = 0;          /* run indices */
    long ra = ka ? ca[0] : 0;     /* remaining in current run */
    long rb = kb ? cb[0] : 0;
    uint8_t va = 0, vb = 0;       /* current run values */
    long inter = 0, uni = 0;
    /* skip exhausted leading runs */
    while (ia < ka - 1 && ra == 0) { ia++; ra = ca[ia]; va = !va; }
    while (ib < kb - 1 && rb == 0) { ib++; rb = cb[ib]; vb = !vb; }
    while (ia < ka && ib < kb) {
        long step = ra < rb ? ra : rb;
        if (step > 0) {
            if (va && vb) inter += step;
            if (va || vb) uni += step;
            ra -= step;
            rb -= step;
        }
        if (ra == 0) {
            ia++;
            if (ia < ka) { ra = ca[ia]; va = !va; }
        }
        if (rb == 0) {
            ib++;
            if (ib < kb) { rb = cb[ib]; vb = !vb; }
        }
        if (ia < ka && ra == 0 && ia == ka - 1) ia = ka; /* done */
        if (ib < kb && rb == 0 && ib == kb - 1) ib = kb;
    }
    /* tails where one mask continues alone */
    while (ia < ka) { if (va) uni += ra; ia++; if (ia < ka) { ra = ca[ia]; va = !va; } }
    while (ib < kb) { if (vb) uni += rb; ib++; if (ib < kb) { rb = cb[ib]; vb = !vb; } }
    *inter_out = inter;
    *union_out = uni;
}

/* Batched pairwise IoU between two sets of RLEs packed as
 * (offsets[na+1], flat counts) — fills ious[na*nb] (row-major d-major). */
void rle_iou_matrix(const long *counts_a, const long *off_a, long na,
                    const long *counts_b, const long *off_b, long nb,
                    const uint8_t *iscrowd_b, double *ious) {
    for (long i = 0; i < na; i++) {
        for (long j = 0; j < nb; j++) {
            long inter, uni;
            rle_intersection_union(counts_a + off_a[i], off_a[i + 1] - off_a[i],
                                   counts_b + off_b[j], off_b[j + 1] - off_b[j],
                                   &inter, &uni);
            if (iscrowd_b && iscrowd_b[j]) {
                uni = rle_area(counts_a + off_a[i], off_a[i + 1] - off_a[i]);
            }
            ious[i * nb + j] = uni > 0 ? (double)inter / (double)uni : 0.0;
        }
    }
}
