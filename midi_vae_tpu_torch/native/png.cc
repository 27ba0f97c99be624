// png — the scanline filters of PNG (ISO/IEC 15948, section 9) undone, for
// the PyTorch port's PNG decoder (native/png.py). Python inflates the image
// data with zlib and checks every chunk; this file reverses the per-row
// filters, which the Sub, Average and Paeth types make a dependency from
// one byte to the one a pixel before it, so they run here and not in a
// Python loop.
//
// A filtered image (or one Adam7 pass) is `rows` scanlines, each a filter
// type byte (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) followed by `stride`
// bytes. `bpp` is the bytes of one whole pixel, at least 1 (the filters of
// bit depths below 8 work on bytes). The row above the first is zero.
//
// C ABI (ctypes):
//   int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t rows,
//                        int64_t stride, int64_t bpp)
//           — writes rows × stride unfiltered bytes to out and returns -1,
//             or returns the index of the first row whose filter type is
//             not 0..4 (out then holds the rows before it)

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t rows, int64_t stride, int64_t bpp) {
  const uint8_t* prior = nullptr;  // the unfiltered row above, null for the first
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t type = in[r * (stride + 1)];
    const uint8_t* src = in + r * (stride + 1) + 1;
    uint8_t* dst = out + r * stride;
    switch (type) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) dst[i] = static_cast<uint8_t>(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return r;
    }
    prior = dst;
  }
  return -1;
}

}  // extern "C"
