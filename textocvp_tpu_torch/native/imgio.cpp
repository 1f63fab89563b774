// Host-side image decode and resize for the port's data pipeline
// (counterpart of the JAX package's textocvp_tpu/native/imgio.cpp).
//
//   * A bilinear resize that is bit-exact with PIL's Image.BILINEAR for
//     uint8 RGB images: the same triangle filter (its support widened by the
//     scale when it downscales), the same 22-bit fixed-point coefficients,
//     the same horizontal-then-vertical pass order through a uint8
//     intermediate (Pillow's src/libImaging/Resample.c).
//   * A PNG decoder that needs only zlib: it walks the chunks (checking the
//     CRC of every critical one), inflates the IDAT stream, undoes the five
//     PNG filters of 8-bit, non-interlaced images of colour types 0, 2, 3,
//     4 and 6 and converts them to RGB8 as PIL's Image.convert("RGB") does
//     (gray replicated, palette indices looked up, alpha dropped without
//     compositing), then resizes, all in one call.
//
// A plain C ABI bound through ctypes, which releases the GIL during a call;
// every entry point keeps no state and may run on many threads at once.

#include <zlib.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL's PRECISION_BITS for 8 bits a channel

inline uint8_t clip8(int64_t in) {
  // PIL: clip8(ss), ss started at 1 << (PRECISION_BITS - 1)
  int64_t v = in >> kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Pillow's precompute_coeffs for the triangle filter, support 1.0, over the
// whole input (no box).
struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;  // 2 * out_size: (xmin, xcount) an output pixel
  std::vector<int> kk;      // out_size * ksize fixed-point weights
};

Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  const double filterscale_raw = static_cast<double>(in_size) / out_size;
  const double filterscale = filterscale_raw < 1.0 ? 1.0 : filterscale_raw;
  const double support = 1.0 * filterscale;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(2 * static_cast<size_t>(out_size));
  c.kk.resize(static_cast<size_t>(out_size) * c.ksize);
  std::vector<double> w(static_cast<size_t>(c.ksize));

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * filterscale_raw;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double val = bilinear_filter((x + xmin - center + 0.5) * ss);
      w[static_cast<size_t>(x)] = val;
      ww += val;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) w[static_cast<size_t>(x)] /= ww;
    }
    int* kk_row = &c.kk[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double v = w[static_cast<size_t>(x)] * (1 << kPrecisionBits);
      kk_row[x] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
    }
    for (int x = xmax; x < c.ksize; ++x) kk_row[x] = 0;
    c.bounds[2 * static_cast<size_t>(xx) + 0] = xmin;
    c.bounds[2 * static_cast<size_t>(xx) + 1] = xmax;
  }
  return c;
}

// (h, in_w, 3) -> (h, out_w, 3)
void resample_horizontal(const uint8_t* in, int h, int in_w, uint8_t* out,
                         int out_w, const Coeffs& c) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* in_row = in + static_cast<size_t>(yy) * in_w * 3;
    uint8_t* out_row = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = c.bounds[2 * static_cast<size_t>(xx) + 0];
      const int xmax = c.bounds[2 * static_cast<size_t>(xx) + 1];
      const int* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
      int64_t ss0 = 1 << (kPrecisionBits - 1);
      int64_t ss1 = ss0, ss2 = ss0;
      for (int x = 0; x < xmax; ++x) {
        const uint8_t* px = in_row + static_cast<size_t>(x + xmin) * 3;
        ss0 += static_cast<int64_t>(px[0]) * k[x];
        ss1 += static_cast<int64_t>(px[1]) * k[x];
        ss2 += static_cast<int64_t>(px[2]) * k[x];
      }
      out_row[xx * 3 + 0] = clip8(ss0);
      out_row[xx * 3 + 1] = clip8(ss1);
      out_row[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// (in_h, w, 3) -> (out_h, w, 3)
void resample_vertical(const uint8_t* in, int in_h, int w, uint8_t* out,
                       int out_h, const Coeffs& c) {
  (void)in_h;
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = c.bounds[2 * static_cast<size_t>(yy) + 0];
    const int ymax = c.bounds[2 * static_cast<size_t>(yy) + 1];
    const int* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
    uint8_t* out_row = out + static_cast<size_t>(yy) * w * 3;
    for (int xx = 0; xx < w * 3; ++xx) {
      int64_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y) {
        ss += static_cast<int64_t>(
                  in[static_cast<size_t>(y + ymin) * w * 3 + xx]) *
              k[y];
      }
      out_row[xx] = clip8(ss);
    }
  }
}

inline int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16) | (uint32_t{p[2]} << 8) | p[3];
}

// Undo the filters of h scanlines of stride bytes (bpp bytes a pixel) and
// write them as packed RGB8. Returns 0, or the error codes of
// imgio_decode_png_rgb.
int unfilter_rgb(const uint8_t* raw, int h, int w, int color_type,
                 const uint8_t* palette, int palette_entries, uint8_t* out) {
  const int bpp = channels_of(color_type);
  const size_t stride = static_cast<size_t>(w) * bpp;
  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
    const uint8_t filter = line[0];
    const uint8_t* src = line + 1;
    switch (filter) {
      case 0:
        std::memcpy(cur.data(), src, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const int left = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const bool has_left = i >= static_cast<size_t>(bpp);
          const int left = has_left ? cur[i - bpp] : 0;
          const int up_left = has_left ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + paeth(left, prev[i], up_left));
        }
        break;
      default:
        return 11;
    }
    uint8_t* o = out + static_cast<size_t>(y) * w * 3;
    switch (color_type) {
      case 0:
        for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = cur[x];
        break;
      case 2:
        std::memcpy(o, cur.data(), stride);
        break;
      case 3:
        for (int x = 0; x < w; ++x) {
          const int idx = cur[x];
          if (idx >= palette_entries) return 12;
          std::memcpy(o + 3 * x, palette + 3 * idx, 3);
        }
        break;
      case 4:
        for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = cur[2 * x];
        break;
      case 6:
        for (int x = 0; x < w; ++x) std::memcpy(o + 3 * x, cur.data() + 4 * x, 3);
        break;
    }
    prev.swap(cur);
  }
  return 0;
}

}  // namespace

extern "C" {

// PIL-BILINEAR-bit-exact resize of an RGB8 image. Returns 0 on success.
int imgio_resize_bilinear_rgb(const uint8_t* in, int in_h, int in_w,
                              uint8_t* out, int out_h, int out_w) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0) return 1;
  if (in_h == out_h && in_w == out_w) {
    std::memcpy(out, in, static_cast<size_t>(in_h) * in_w * 3);
    return 0;
  }
  // Pillow: the horizontal pass first, into a uint8 intermediate
  const uint8_t* src = in;
  std::vector<uint8_t> tmp;
  int cur_w = in_w;
  if (out_w != in_w) {
    const Coeffs ch = precompute_coeffs(in_w, out_w);
    tmp.resize(static_cast<size_t>(in_h) * out_w * 3);
    resample_horizontal(src, in_h, in_w, tmp.data(), out_w, ch);
    src = tmp.data();
    cur_w = out_w;
  }
  if (out_h != in_h) {
    const Coeffs cv = precompute_coeffs(in_h, out_h);
    resample_vertical(src, in_h, cur_w, out, out_h, cv);
  } else {
    std::memcpy(out, src, static_cast<size_t>(out_h) * cur_w * 3);
  }
  return 0;
}

// Decode an in-memory PNG to packed RGB8 of (out_h, out_w), resized when
// that is not the PNG's own size. header receives the IHDR's height, width,
// bit depth and colour type once they are read. Returns 0 on success, or:
// 1 no PNG signature, 2 truncated (a chunk cut short, or no IEND), 3 a
// critical chunk's CRC does not hold, 4 an invalid or missing IHDR, 5
// interlaced, 6 a bit depth other than 8, 7 a colour type other than 0, 2,
// 3, 4 or 6, 8 a palette image without PLTE, 9 corrupt image data (zlib), 10
// less image data than the header says, 11 a filter type past 4, 12 a
// palette index past the palette, 13 an empty output size, 14 out of memory.
static int decode_png_rgb(const uint8_t* buf, size_t len, uint8_t* out, int out_h,
                          int out_w, int32_t* header) {
  static const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || std::memcmp(buf, kSignature, 8) != 0) return 1;
  if (out_h <= 0 || out_w <= 0) return 13;
  int h = 0, w = 0, bit_depth = 0, color_type = -1, interlace = 0;
  bool have_ihdr = false;
  const uint8_t* palette = nullptr;
  int palette_entries = 0;
  std::vector<uint8_t> raw;
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  bool inflating = false, inflated = false;
  int rc = 0;
  size_t pos = 8;
  for (;;) {
    if (pos + 12 > len) { rc = 2; break; }
    const uint32_t length = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* body = buf + pos + 8;
    if (length > len - pos - 12) { rc = 2; break; }
    if (type[0] < 'a') {  // a critical chunk: its CRC must hold
      uLong crc = crc32(crc32(0L, Z_NULL, 0), type, 4);
      crc = crc32(crc, body, length);
      if (crc != be32(body + length)) { rc = 3; break; }
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (length != 13) { rc = 4; break; }
      w = static_cast<int>(be32(body)), h = static_cast<int>(be32(body + 4));
      bit_depth = body[8], color_type = body[9], interlace = body[12];
      header[0] = h, header[1] = w, header[2] = bit_depth, header[3] = color_type;
      if (h <= 0 || w <= 0 || body[10] != 0 || body[11] != 0) { rc = 4; break; }
      if (interlace) { rc = 5; break; }
      if (bit_depth != 8) { rc = 6; break; }
      if (channels_of(color_type) == 0) { rc = 7; break; }
      have_ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      palette = body;
      palette_entries = static_cast<int>(length / 3);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (!have_ihdr) { rc = 4; break; }
      if (color_type == 3 && palette == nullptr) { rc = 8; break; }
      if (!inflating) {
        raw.resize(static_cast<size_t>(h) * (static_cast<size_t>(w) * channels_of(color_type) + 1));
        if (inflateInit(&zs) != Z_OK) { rc = 9; break; }
        zs.next_out = raw.data();
        zs.avail_out = static_cast<uInt>(raw.size());
        inflating = true;
      }
      if (!inflated) {
        zs.next_in = const_cast<uint8_t*>(body);
        zs.avail_in = length;
        while (zs.avail_in > 0 && zs.avail_out > 0) {
          const int z = inflate(&zs, Z_NO_FLUSH);
          if (z == Z_STREAM_END) { inflated = true; break; }
          if (z != Z_OK) { rc = 9; break; }
        }
        if (rc) break;
        if (zs.avail_out == 0) inflated = true;  // all scanlines are in
      }
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<size_t>(length);
  }
  if (inflating) inflateEnd(&zs);
  if (rc) return rc;
  if (!have_ihdr) return 4;
  if (color_type == 3 && palette == nullptr) return 8;
  if (!inflating || zs.avail_out != 0) return 10;
  if (out_h == h && out_w == w) {
    return unfilter_rgb(raw.data(), h, w, color_type, palette, palette_entries, out);
  }
  std::vector<uint8_t> full(static_cast<size_t>(h) * w * 3);
  rc = unfilter_rgb(raw.data(), h, w, color_type, palette, palette_entries, full.data());
  if (rc) return rc;
  return imgio_resize_bilinear_rgb(full.data(), h, w, out, out_h, out_w) == 0 ? 0 : 13;
}

int imgio_decode_png_rgb(const uint8_t* buf, size_t len, uint8_t* out, int out_h,
                         int out_w, int32_t* header) {
  try {
    return decode_png_rgb(buf, len, out, out_h, out_w, header);
  } catch (const std::bad_alloc&) {
    return 14;
  }
}

}  // extern "C"
