// PNG scanline unfiltering for the port's image codec
// (flaxdiff_tpu_torch/data/codec.py): zlib's inflate (Python's standard
// library) yields `height` rows of one filter-type byte then `stride`
// bytes; this undoes the five filters of the PNG specification (ISO/IEC
// 15948, section 9) in place of OpenCV's libpng, which the card's machine
// lacks. Average and Paeth read the byte just decoded to their left, so a
// row is sequential: the loop stays out of the interpreter.
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// data: height rows of (1 + stride) bytes; out: height * stride bytes; bpp:
// bytes per complete pixel (the filters' left neighbour distance). Returns
// 0, or 1 + the row index of the first row with an unknown filter type.
int64_t png_unfilter(const uint8_t* data, uint8_t* out, int64_t height, int64_t stride,
                     int32_t bpp) {
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t* src = data + r * (stride + 1);
    const uint8_t filter = *src++;
    uint8_t* dst = out + r * stride;
    const uint8_t* up = r ? dst - stride : nullptr;
    switch (filter) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
