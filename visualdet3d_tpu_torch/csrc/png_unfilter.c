/* PNG row unfiltering (the five filter types of the PNG specification,
 * section 9) for the port's image reader, visualdet3d_tpu_torch/data/image_io.py.
 *
 * Built with the host C compiler into a shared library at first use and
 * called through ctypes, which releases the interpreter lock: the data
 * loader's threads decode in parallel. Average and Paeth depend on the
 * byte one pixel to the left, so a row is a sequential pass; numpy cannot
 * vectorise them, which is why this is C.
 */
#include <stdint.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

/* in: `height` rows of 1 filter-type byte + `rowbytes` filtered bytes.
 * out: height * rowbytes unfiltered bytes. bpp: bytes per pixel (>= 1).
 * Returns 0, or 1 + the index of the first row whose filter type is not
 * 0-4 (out is then incomplete). */
int vd3d_png_unfilter(const uint8_t *in, uint8_t *out, int64_t height, int64_t rowbytes,
                      int64_t bpp) {
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t *src = in + r * (rowbytes + 1);
        uint8_t *dst = out + r * rowbytes;
        const uint8_t *prior = r > 0 ? dst - rowbytes : NULL;
        int64_t i;
        switch (src[0]) {
        case 0:
            memcpy(dst, src + 1, (size_t)rowbytes);
            break;
        case 1:
            for (i = 0; i < rowbytes && i < bpp; ++i) dst[i] = src[1 + i];
            for (; i < rowbytes; ++i) dst[i] = (uint8_t)(src[1 + i] + dst[i - bpp]);
            break;
        case 2:
            if (prior == NULL) {
                memcpy(dst, src + 1, (size_t)rowbytes);
            } else {
                for (i = 0; i < rowbytes; ++i) dst[i] = (uint8_t)(src[1 + i] + prior[i]);
            }
            break;
        case 3:
            for (i = 0; i < rowbytes; ++i) {
                int left = i >= bpp ? dst[i - bpp] : 0;
                int up = prior != NULL ? prior[i] : 0;
                dst[i] = (uint8_t)(src[1 + i] + ((left + up) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < rowbytes; ++i) {
                int left = i >= bpp ? dst[i - bpp] : 0;
                int up = prior != NULL ? prior[i] : 0;
                int up_left = (prior != NULL && i >= bpp) ? prior[i - bpp] : 0;
                dst[i] = (uint8_t)(src[1 + i] + paeth(left, up, up_left));
            }
            break;
        default:
            return (int)(r + 1);
        }
    }
    return 0;
}
