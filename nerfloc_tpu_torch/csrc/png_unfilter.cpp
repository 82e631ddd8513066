// PNG row reconstruction for the rows that read the row above: Up (2), Avg
// (3) and Paeth (4). Avg and Paeth bytes also depend on the reconstructed
// byte to their left, so they run in sequence along a row (PNG
// specification, section 9), and every such row waits for the one above.
// Host code with a plain C interface, loaded with ctypes by
// nerfloc_tpu_torch/data/png.py, which reconstructs the None and Sub rows
// itself in numpy first and then hands the whole image over in one call.
#include <cstdint>
#include <cstdlib>

extern "C" {

// Reconstructs, top to bottom, every row y of an image of `h` rows of `n`
// bytes whose filter type types[y] is 2, 3 or 4. `filt` holds the filtered
// rows (without their filter-type bytes), `out` the reconstructed rows: on
// entry those of type 0 and 1 must already be there. `bpp` is the bytes per
// complete pixel (at least 1); the row above the first is zeros. Returns 0,
// or -1 - y for a filter type above 4 at row y.
int png_unfilter(const uint8_t* types, const uint8_t* filt, uint8_t* out,
                 int64_t h, int64_t n, int bpp) {
    for (int64_t y = 0; y < h; ++y) {
        const int t = types[y];
        if (t < 2) continue;
        if (t > 4) return static_cast<int>(-1 - y);
        const uint8_t* f = filt + y * n;
        uint8_t* o = out + y * n;
        if (y == 0) {
            // the row above is zeros: Up copies, Avg halves the left byte,
            // Paeth predicts the left byte
            for (int64_t i = 0; i < n; ++i) {
                const int a = i >= bpp ? o[i - bpp] : 0;
                o[i] = static_cast<uint8_t>(f[i] + (t == 2 ? 0 : t == 3 ? a >> 1 : a));
            }
            continue;
        }
        const uint8_t* prior = out + (y - 1) * n;
        if (t == 2) {
            for (int64_t i = 0; i < n; ++i) o[i] = static_cast<uint8_t>(f[i] + prior[i]);
            continue;
        }
        const int64_t head = bpp < n ? bpp : n;
        for (int64_t i = 0; i < head; ++i)   // no left neighbour: a = c = 0
            o[i] = static_cast<uint8_t>(f[i] + (t == 3 ? prior[i] >> 1 : prior[i]));
        if (t == 3) {
            for (int64_t i = head; i < n; ++i)
                o[i] = static_cast<uint8_t>(f[i] + ((o[i - bpp] + prior[i]) >> 1));
            continue;
        }
        for (int64_t i = head; i < n; ++i) {
            // branch-free predictor: the bytes are data, the branches would
            // be mispredicted about half the time
            const int a = o[i - bpp], b = prior[i], c = prior[i - bpp];
            const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
            const int bc = pb <= pc ? b : c;
            o[i] = static_cast<uint8_t>(f[i] + (((pa <= pb) & (pa <= pc)) ? a : bc));
        }
    }
    return 0;
}

}  // extern "C"
