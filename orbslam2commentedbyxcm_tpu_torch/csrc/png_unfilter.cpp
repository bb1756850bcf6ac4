// PNG row unfiltering (PNG specification, section 9: filter method 0) on the
// host, for utils/png.py. Average and Paeth read the reconstructed byte to
// the left, so a row is a sequential scan, bound by that chain's latency:
// milliseconds per megapixel, where a per-byte Python loop takes ~0.5 s.
//
// Built with the host C++ compiler by kernels.host_library(), bound with
// ctypes (which releases the GIL for the call, so the dataset prefetch thread
// decodes while the tracking thread runs).

#include <cstdint>
#include <cstdlib>

extern "C" {

// src: height rows of (1 + stride) bytes, each a filter type byte then the
// filtered scanline; dst: height * stride bytes. bpp: bytes per complete
// pixel (at least 1). Returns 0, or -(row + 1) for a row whose filter type is
// not 0-4.
int png_unfilter(const uint8_t* src, uint8_t* dst, int height, int stride, int bpp) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = src + (size_t)y * (stride + 1);
        const int filter = in[0];
        ++in;
        uint8_t* out = dst + (size_t)y * stride;
        const uint8_t* up = y > 0 ? out - stride : nullptr;
        switch (filter) {
        case 0:  // None
            for (int x = 0; x < stride; ++x) out[x] = in[x];
            break;
        case 1:  // Sub
            for (int x = 0; x < stride; ++x) out[x] = (uint8_t)(in[x] + (x >= bpp ? out[x - bpp] : 0));
            break;
        case 2:  // Up
            for (int x = 0; x < stride; ++x) out[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
            break;
        case 3:  // Average
            for (int x = 0; x < stride; ++x) {
                const int a = x >= bpp ? out[x - bpp] : 0;
                const int b = up ? up[x] : 0;
                out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (int x = 0; x < stride; ++x) {
                const int a = x >= bpp ? out[x - bpp] : 0;
                const int b = up ? up[x] : 0;
                const int c = (up && x >= bpp) ? up[x - bpp] : 0;
                // distances of p = a + b - c to a, b and c
                const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[x] = (uint8_t)(in[x] + pred);
            }
            break;
        default:
            return -(y + 1);
        }
    }
    return 0;
}

}  // extern "C"
