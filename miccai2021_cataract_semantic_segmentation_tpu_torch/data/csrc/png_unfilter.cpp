// PNG row unfiltering (PNG spec section 9) for the port's host decoder,
// data/png.py: the five filter types of 8-bit, non-interlaced images,
// one row after another, each row along its bytes.
//
// in:  h rows of (1 + row_bytes) bytes, each a filter-type byte and the
//      filtered row; out: h * row_bytes unfiltered bytes; bpp: bytes a
//      pixel (1 gray, 3 RGB). Returns 0, or -(r + 1) where row r has a
//      filter type above 4.

#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* in, uint8_t* out, int h,
                            int row_bytes, int bpp) {
  for (int r = 0; r < h; r++) {
    const uint8_t* src = in + (size_t)r * (row_bytes + 1);
    const uint8_t type = src[0];
    src += 1;
    uint8_t* dst = out + (size_t)r * row_bytes;
    const uint8_t* up = r > 0 ? dst - row_bytes : nullptr;
    switch (type) {
      case 0:
        for (int i = 0; i < row_bytes; i++) dst[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < row_bytes; i++)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row_bytes; i++)
          dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < row_bytes; i++) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < row_bytes; i++) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}
