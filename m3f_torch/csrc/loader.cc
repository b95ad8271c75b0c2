// The port's native data loader: threaded JPEG decode + resize.
//
// The port's own copy of the reference's loader (same C ABI, same decode
// and resize, bit for bit): one in-process C++ thread pool decodes a whole
// window-sequence batch per call, with the GIL released for the entire call
// (ctypes), so no fork, no IPC and no per-image Python work. It runs on the
// host and feeds the card's training and eval batches.
//
// C ABI (ctypes-friendly), no C++ types across the boundary:
//   m3f_decode_jpeg_batch(paths, n, out, H, W, n_threads, ok) -> n_failed
//     paths: array of n NUL-terminated file paths ("" = missing)
//     out:   caller-allocated uint8 buffer [n, H, W, 3] (RGB)
//     ok:    per slot (may be null): 1 decoded; 0 missing or corrupt; 2 a
//            stream the own decoder does not take (M3F_LOADER_OWN only).
//            A slot that is not 1 is zeroed and counts in the return.
//   m3f_loader_self_test() -> 42
//
// The decoder is chosen at build time:
//   default          libjpeg (jpeglib.h, -ljpeg): the reference's decode.
//   -DM3F_LOADER_OWN for a host without libjpeg's headers: the port's own
//                    baseline decoder (below), libjpeg's default decode bit
//                    for bit on the streams it takes (sequential Huffman,
//                    8-bit, grey or YCbCr); any other stream (progressive,
//                    arithmetic, 12-bit, CMYK, ...) gets ok 2, which the
//                    caller raises on rather than decode it differently.
// Either fills the same slot or scratch, then the same resize_bilinear.
//
// Built on first use by m3f_torch/data/native_loader.py:
//   g++ -O3 -std=c++17 -fPIC -pthread -shared loader.cc -o ... -ljpeg
// (or -DM3F_LOADER_OWN) into build/loader/ at the repository root, keyed by
// a hash of this file and the flags.

#include <atomic>
#include <condition_variable>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#ifndef M3F_LOADER_OWN
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

// The outcome of one file's decode (the ok byte of its slot).
enum Decoded { kFailed = 0, kDecoded = 1, kUnsupported = 2 };

// The destination of a decode: the slot itself when the image is exactly
// out_w×out_h (the common case for pre-cropped 112×112 faces), else
// `pixels`, for resizing.
uint8_t* rgb_target(std::vector<uint8_t>& pixels, uint8_t* direct, int out_w,
                    int out_h, int w, int h) {
  if (direct && w == out_w && h == out_h) return direct;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  return pixels.data();
}

#ifdef M3F_LOADER_OWN
// ---------------------------------------------------------------------------
// Component planes → RGB exactly as libjpeg(-turbo) makes them by default:
// "fancy" (triangle-filter) chroma upsampling (jdsample.c h2v1 / h2v2 /
// h1v2_fancy_upsample; plain replication where a plane is at most 2 samples
// wide or the ratio is another integer) and the integer YCbCr → RGB tables
// of jdcolor.c.
// ---------------------------------------------------------------------------

struct Planes {
  int ncomp = 0;                 // 1 (grey) or 3 (Y, Cb, Cr)
  const uint8_t* data[3] = {};
  int stride[3] = {};
  int w[3] = {}, h[3] = {};      // samples in each plane
  int hf[3] = {1, 1, 1};         // upsampling factors to full resolution
  int vf[3] = {1, 1, 1};
};

// One plane upsampled to the image's [out_h, out_w]; a row above the first
// or below the last is the first or the last (libjpeg's context rows).
void upsample_plane(const uint8_t* in, int stride, int cw, int ch, int hf,
                    int vf, int out_w, int out_h, uint8_t* out) {
  std::vector<uint8_t> row(static_cast<size_t>(cw) * hf);
  auto at = [&](int r) {
    r = r < 0 ? 0 : (r >= ch ? ch - 1 : r);
    return in + static_cast<size_t>(r) * stride;
  };
  for (int y = 0; y < out_h; ++y) {
    const int r = y / vf, v = y % vf;
    const uint8_t* in0 = at(r);
    uint8_t* o = row.data();
    if (hf == 2 && vf == 2 && cw > 2) {            // h2v2_fancy_upsample
      const uint8_t* in1 = at(v == 0 ? r - 1 : r + 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int c = 2; c < cw; ++c) {
        next_sum = in0[c] * 3 + in1[c];
        *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
    } else if (hf == 2 && vf == 1 && cw > 2) {     // h2v1_fancy_upsample
      int val = in0[0];
      *o++ = static_cast<uint8_t>(val);
      *o++ = static_cast<uint8_t>((val * 3 + in0[1] + 2) >> 2);
      for (int c = 1; c < cw - 1; ++c) {
        val = in0[c] * 3;
        *o++ = static_cast<uint8_t>((val + in0[c - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((val + in0[c + 1] + 2) >> 2);
      }
      val = in0[cw - 1];
      *o++ = static_cast<uint8_t>((val * 3 + in0[cw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(val);
    } else if (hf == 1 && vf == 2) {               // h1v2_fancy_upsample
      const uint8_t* in1 = at(v == 0 ? r - 1 : r + 1);
      const int bias = v == 0 ? 1 : 2;
      for (int c = 0; c < cw; ++c)
        *o++ = static_cast<uint8_t>((in0[c] * 3 + in1[c] + bias) >> 2);
    } else {                                       // replication
      for (int c = 0; c < cw; ++c)
        for (int k = 0; k < hf; ++k) *o++ = in0[c];
    }
    memcpy(out + static_cast<size_t>(y) * out_w, row.data(), out_w);
  }
}

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + half) >> 16);    // FIX(1.40200)
      cb_b[i] = static_cast<int>((116130 * x + half) >> 16);   // FIX(1.77200)
      cr_g[i] = -46802 * x;                                    // FIX(0.71414)
      cb_g[i] = -22554 * x + half;                             // FIX(0.34414)
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// `planes` → interleaved RGB [h, w, 3] in `dst` (jdcolor.c ycc_rgb_convert;
// a grey image is its plane three times).
void planes_to_rgb(const Planes& planes, int w, int h, uint8_t* dst) {
  const size_t n = static_cast<size_t>(w) * h;
  if (planes.ncomp == 1) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint8_t g =
            planes.data[0][static_cast<size_t>(y) * planes.stride[0] + x];
        uint8_t* o = dst + (static_cast<size_t>(y) * w + x) * 3;
        o[0] = o[1] = o[2] = g;
      }
    return;
  }
  std::vector<uint8_t> full(n * 3);
  for (int c = 0; c < 3; ++c)
    upsample_plane(planes.data[c], planes.stride[c], planes.w[c], planes.h[c],
                   planes.hf[c], planes.vf[c], w, h, full.data() + c * n);
  static const YccTables t;
  const uint8_t *yp = full.data(), *cbp = yp + n, *crp = cbp + n;
  for (size_t i = 0; i < n; ++i) {
    const int y = yp[i], cb = cbp[i], cr = crp[i];
    uint8_t* o = dst + i * 3;
    o[0] = clamp255(y + t.cr_r[cr]);
    o[1] = clamp255(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
    o[2] = clamp255(y + t.cb_b[cb]);
  }
}

// ---------------------------------------------------------------------------
// The port's own baseline JPEG decoder, bit for bit libjpeg(-turbo)'s default
// decode of the streams it takes: sequential Huffman (SOF0 / SOF1), 8-bit,
// one or three components (grey, or YCbCr by libjpeg's colour-space rules),
// interleaved or not, restart intervals; libjpeg's accurate integer IDCT
// (jidctint.c jpeg_idct_islow) and its range limiting, then planes_to_rgb.
// Any other stream (progressive, arithmetic coding, 12-bit, CMYK, RGB-coded)
// is declined (`*supported` false): its slot gets kUnsupported.
// ---------------------------------------------------------------------------

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {                    // jdhuff.c's derived table (slow path)
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
};

bool build_huff(const uint8_t* bits, const uint8_t* vals, int nvals, Huff* t) {
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  if (p != nvals) return false;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return false;      // bad table
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  memcpy(t->vals, vals, nvals);
  t->present = true;
  return true;
}

// The entropy-coded data of a scan: 0xFF 0x00 is a data 0xFF; a marker ends
// the data, after which zeros are read (libjpeg's fill_bit_buffer).
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint32_t acc = 0;
  int bits = 0;
  bool at_marker = false;
  bool insufficient = false;     // zeros were read past the data
  uint8_t byte() {
    if (at_marker || pos >= n) {
      insufficient = true;
      return 0;
    }
    uint8_t b = d[pos];
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) ++q;     // fill bytes
    if (q < n && d[q] == 0x00) {
      pos = q + 1;
      return 0xFF;
    }
    at_marker = true;                      // pos stays on the marker
    insufficient = true;
    return 0;
  }
  int bit() {
    if (bits == 0) {
      acc = byte();
      bits = 8;
    }
    return (acc >> --bits) & 1;
  }
  int get(int s) {
    int v = 0;
    for (int i = 0; i < s; ++i) v = (v << 1) | bit();
    return v;
  }
  int decode(const Huff& t) {              // jpeg_huff_decode
    int l = 1;
    int32_t code = bit();
    while (code > t.maxcode[l]) {
      code = (code << 1) | bit();
      if (++l > 16) return 0;              // bad code: libjpeg's 0
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // At a restart boundary: byte-align and consume the RSTn (where the data
  // stopped, or the next one ahead); the out-of-data state clears only
  // when there is one, as libjpeg's does.
  void restart() {
    bits = 0;
    size_t q = pos;
    auto is_rst = [&](size_t k) {
      return k + 1 < n && d[k] == 0xFF && d[k + 1] >= 0xD0 && d[k + 1] <= 0xD7;
    };
    if (!at_marker)
      while (q + 1 < n && !is_rst(q)) ++q;
    if (is_rst(q)) {
      pos = q + 2;
      at_marker = insufficient = false;
    }
  }
};

inline int huff_extend(int x, int s) {     // jdhuff.c HUFF_EXTEND
  return s == 0 ? 0 : (x < (1 << (s - 1)) ? x - (1 << s) + 1 : x);
}

// libjpeg's post-IDCT range limit: x + 128 clamped, indexed mod 1024.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      const int x = i < 512 ? i : i - 1024;
      const int v = x + 128;
      t[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
};

// jidctint.c jpeg_idct_islow on one dequantized-on-the-fly block.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  static const RangeLimit rl;
  const int CB = 13, P1 = 2;
  auto M = [](int64_t v, int64_t c) { return v * c; };
  auto D = [](int64_t x, int n) {
    return static_cast<int>((x + (int64_t(1) << (n - 1))) >> n);
  };
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = (in[0] * qq[0]) * (1 << P1);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int64_t z1 = M(z2 + z3, 4433);
    int64_t tmp2 = z1 + M(z3, -15137), tmp3 = z1 + M(z2, 6270);
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = M(z3 + z4, 9633);
    tmp0 = M(tmp0, 2446);
    tmp1 = M(tmp1, 16819);
    tmp2 = M(tmp2, 25172);
    tmp3 = M(tmp3, 12299);
    z1 = M(z1, -7373);
    z2 = M(z2, -20995);
    z3 = M(z3, -16069);
    z4 = M(z4, -3196);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = D(t10 + tmp3, CB - P1);
    w[56] = D(t10 - tmp3, CB - P1);
    w[8] = D(t11 + tmp2, CB - P1);
    w[48] = D(t11 - tmp2, CB - P1);
    w[16] = D(t12 + tmp1, CB - P1);
    w[40] = D(t12 - tmp1, CB - P1);
    w[24] = D(t13 + tmp0, CB - P1);
    w[32] = D(t13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = rl.t[D(w[0], P1 + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = M(z2 + z3, 4433);
    int64_t tmp2 = z1 + M(z3, -15137), tmp3 = z1 + M(z2, 6270);
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = M(z3 + z4, 9633);
    tmp0 = M(tmp0, 2446);
    tmp1 = M(tmp1, 16819);
    tmp2 = M(tmp2, 25172);
    tmp3 = M(tmp3, 12299);
    z1 = M(z1, -7373);
    z2 = M(z2, -20995);
    z3 = M(z3, -16069);
    z4 = M(z4, -3196);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int S = CB + P1 + 3;
    o[0] = rl.t[D(t10 + tmp3, S) & 1023];
    o[7] = rl.t[D(t10 - tmp3, S) & 1023];
    o[1] = rl.t[D(t11 + tmp2, S) & 1023];
    o[6] = rl.t[D(t11 - tmp2, S) & 1023];
    o[2] = rl.t[D(t12 + tmp1, S) & 1023];
    o[5] = rl.t[D(t12 - tmp1, S) & 1023];
    o[3] = rl.t[D(t13 + tmp0, S) & 1023];
    o[4] = rl.t[D(t13 - tmp0, S) & 1023];
  }
}

struct OwnComp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;            // blocks of the padded plane
  int dw = 0, dh = 0;            // libjpeg's downsampled_width / _height
  int pred = 0;
  std::vector<uint8_t> plane;    // bw*8 × bh*8 samples
};

inline int div_up(int a, int b) { return (a + b - 1) / b; }

// Decode `data` (a whole JPEG file) into rgb_target. Returns true on
// success; false with *supported true for a corrupt stream, with
// *supported false for a stream this decoder does not take.
bool own_decode(const uint8_t* data, size_t n, std::vector<uint8_t>& pixels,
                uint8_t* direct, int out_w, int out_h, int* w, int* h,
                bool* supported) {
  *supported = true;
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return false;
  uint16_t quant[4][64];
  bool have_q[4] = {};
  Huff dc[4], ac[4];
  OwnComp comp[3];
  int ncomp = 0, width = 0, height = 0, maxh = 1, maxv = 1, restart = 0;
  bool sof = false, jfif = false, adobe = false, any_scan = false;
  int adobe_transform = -1;
  size_t pos = 2;
  auto u16 = [&](size_t p) { return (data[p] << 8) | data[p + 1]; };
  while (true) {
    while (pos < n && data[pos] != 0xFF) ++pos;   // to the next marker
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) break;                          // premature end
    const int m = data[pos++];
    if (m == 0xD9) break;                         // EOI
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD8)) continue;
    if (pos + 2 > n) break;
    const size_t len = u16(pos);
    if (len < 2 || pos + len > n) return false;
    const uint8_t* seg = data + pos + 2;
    const size_t sl = len - 2;
    pos += len;
    if (m == 0xE0 && sl >= 5 && !memcmp(seg, "JFIF\0", 5)) {
      jfif = true;
    } else if (m == 0xEE && sl >= 12 && !memcmp(seg, "Adobe", 5)) {
      adobe = true;
      adobe_transform = seg[11];
    } else if (m == 0xDB) {                       // DQT
      size_t p = 0;
      while (p < sl) {
        const int pq = seg[p] >> 4, tq = seg[p] & 15;
        ++p;
        if (tq > 3 || pq > 1 || p + 64 * (pq + 1) > sl) return false;
        for (int i = 0; i < 64; ++i) {
          quant[tq][kNaturalOrder[i]] =
              pq ? static_cast<uint16_t>((seg[p + 2 * i] << 8) | seg[p + 2 * i + 1])
                 : seg[p + i];
        }
        have_q[tq] = true;
        p += 64 * (pq + 1);
      }
    } else if (m == 0xC4) {                       // DHT
      size_t p = 0;
      while (p < sl) {
        if (p + 17 > sl) return false;
        const int tc = seg[p] >> 4, th = seg[p] & 15;
        uint8_t bits[17] = {0};
        int count = 0;
        for (int l = 1; l <= 16; ++l) count += bits[l] = seg[p + l];
        p += 17;
        if (tc > 1 || th > 3 || count > 256 || p + count > sl) return false;
        if (!build_huff(bits, seg + p, count, tc ? &ac[th] : &dc[th]))
          return false;
        p += count;
      }
    } else if (m == 0xDD) {                       // DRI
      if (sl < 2) return false;
      restart = (seg[0] << 8) | seg[1];
    } else if (m == 0xC0 || m == 0xC1) {          // baseline / extended
      if (sl < 6 || seg[0] != 8) { *supported = false; return false; }
      height = (seg[1] << 8) | seg[2];
      width = (seg[3] << 8) | seg[4];
      ncomp = seg[5];
      if ((ncomp != 1 && ncomp != 3) || height == 0 || width == 0) {
        *supported = false;
        return false;
      }
      if (sl < 6 + 3 * static_cast<size_t>(ncomp)) return false;
      for (int c = 0; c < ncomp; ++c) {
        comp[c].id = seg[6 + 3 * c];
        comp[c].h = seg[7 + 3 * c] >> 4;
        comp[c].v = seg[7 + 3 * c] & 15;
        comp[c].tq = seg[8 + 3 * c];
        if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 ||
            comp[c].v > 4 || comp[c].tq > 3)
          return false;
        maxh = comp[c].h > maxh ? comp[c].h : maxh;
        maxv = comp[c].v > maxv ? comp[c].v : maxv;
      }
      for (int c = 0; c < ncomp; ++c)     // integer upsampling ratios only
        if (maxh % comp[c].h || maxv % comp[c].v) {
          *supported = false;
          return false;
        }
      const int mx = div_up(width, 8 * maxh), my = div_up(height, 8 * maxv);
      for (int c = 0; c < ncomp; ++c) {
        OwnComp& k = comp[c];
        k.bw = mx * k.h;
        k.bh = my * k.v;
        k.dw = div_up(width * k.h, maxh);
        k.dh = div_up(height * k.v, maxv);
        k.plane.assign(static_cast<size_t>(k.bw) * 8 * k.bh * 8, 0);
      }
      sof = true;
    } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {                       // other SOFn
      *supported = false;
      return false;
    } else if (m == 0xDA) {                       // SOS
      if (!sof || sl < 1) return false;
      if (ncomp == 3) {          // libjpeg's colour-space rules: YCbCr only
        const bool rgb_ids = comp[0].id == 'R' && comp[1].id == 'G' &&
                             comp[2].id == 'B';
        const bool ycc = jfif || (adobe ? adobe_transform != 0 : !rgb_ids);
        if (!ycc) { *supported = false; return false; }
      }
      const int ns = seg[0];
      if (ns < 1 || ns > ncomp || sl < 1 + 2 * static_cast<size_t>(ns) + 3)
        return false;
      OwnComp* sc[3];
      for (int i = 0; i < ns; ++i) {
        sc[i] = nullptr;
        for (int c = 0; c < ncomp; ++c)
          if (comp[c].id == seg[1 + 2 * i]) sc[i] = &comp[c];
        if (!sc[i]) return false;
        sc[i]->td = seg[2 + 2 * i] >> 4;
        sc[i]->ta = seg[2 + 2 * i] & 15;
        if (sc[i]->td > 3 || sc[i]->ta > 3 || !dc[sc[i]->td].present ||
            !ac[sc[i]->ta].present || !have_q[sc[i]->tq])
          return false;
        sc[i]->pred = 0;
      }
      const uint8_t* ss = seg + 1 + 2 * ns;
      if (ss[0] != 0 || ss[1] != 63 || ss[2] != 0) {
        *supported = false;
        return false;
      }
      BitReader br{data, n, pos};
      int16_t blk[64];
      // an MCU begun after the data ran out stays zero (uniform grey), as
      // libjpeg leaves it
      bool skip = false;
      auto block = [&](OwnComp& k, int bx, int by) {
        memset(blk, 0, sizeof blk);
        const int stride = k.bw * 8;
        uint8_t* out = k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8;
        if (skip) {
          idct_islow(blk, quant[k.tq], out, stride);
          return;
        }
        const int t = br.decode(dc[k.td]);
        int diff = t ? huff_extend(br.get(t), t) : 0;
        k.pred += diff;
        blk[0] = static_cast<int16_t>(k.pred);
        for (int i = 1; i < 64; ++i) {
          const int rs = br.decode(ac[k.ta]);
          const int r = rs >> 4, s = rs & 15;
          if (s) {
            i += r;
            blk[kNaturalOrder[i]] =
                static_cast<int16_t>(huff_extend(br.get(s), s));
          } else {
            if (r != 15) break;
            i += 15;
          }
        }
        idct_islow(blk, quant[k.tq], out, stride);
      };
      int mcus, per_row;
      if (ns == 1) {                  // non-interleaved: one block per MCU
        per_row = div_up(sc[0]->dw, 8);
        mcus = per_row * div_up(sc[0]->dh, 8);
      } else {
        per_row = div_up(width, 8 * maxh);
        mcus = per_row * div_up(height, 8 * maxv);
      }
      for (int mcu = 0; mcu < mcus; ++mcu) {
        if (restart && mcu && mcu % restart == 0) {
          br.restart();
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        }
        skip = br.insufficient;
        const int mx = mcu % per_row, my = mcu / per_row;
        if (ns == 1) {
          block(*sc[0], mx, my);
        } else {
          for (int i = 0; i < ns; ++i)
            for (int yy = 0; yy < sc[i]->v; ++yy)
              for (int xx = 0; xx < sc[i]->h; ++xx)
                block(*sc[i], mx * sc[i]->h + xx, my * sc[i]->v + yy);
        }
      }
      pos = br.pos;
      any_scan = true;
    }
  }
  if (!sof || !any_scan) return false;
  *w = width;
  *h = height;
  Planes pl;
  pl.ncomp = ncomp;
  for (int c = 0; c < ncomp; ++c) {
    pl.data[c] = comp[c].plane.data();
    pl.stride[c] = comp[c].bw * 8;
    pl.w[c] = comp[c].dw;
    pl.h[c] = comp[c].dh;
    pl.hf[c] = maxh / comp[c].h;
    pl.vf[c] = maxv / comp[c].v;
  }
  planes_to_rgb(pl, width, height,
                rgb_target(pixels, direct, out_w, out_h, width, height));
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>& data) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  data.clear();
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof buf, f)) > 0)
    data.insert(data.end(), buf, buf + got);
  fclose(f);
  return true;
}

// Decode one JPEG file to RGB (into rgb_target) with the own decoder; *w/*h
// get the source dimensions.
Decoded decode_jpeg_file(const char* path, std::vector<uint8_t>& pixels,
                         uint8_t* direct, int out_w, int out_h, int* w,
                         int* h) {
  thread_local std::vector<uint8_t> data;
  if (!read_file(path, data)) return kFailed;
  bool supported = true;
  if (own_decode(data.data(), data.size(), pixels, direct, out_w, out_h, w, h,
                 &supported))
    return kDecoded;
  return supported ? kFailed : kUnsupported;
}

#else

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file to RGB (into rgb_target) with libjpeg; *w/*h get
// the source dimensions.
Decoded decode_jpeg_file(const char* path, std::vector<uint8_t>& pixels,
                         uint8_t* direct, int out_w, int out_h, int* w,
                         int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return kFailed;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return kFailed;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = *w * 3;
  uint8_t* dst = rgb_target(pixels, direct, out_w, out_h, *w, *h);
  // read in max-sized batches — libjpeg-turbo SIMD paths like large requests
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rows[64];
    const unsigned remaining = cinfo.output_height - cinfo.output_scanline;
    const unsigned batch = remaining < 64 ? remaining : 64;
    for (unsigned i = 0; i < batch; ++i)
      rows[i] = dst + static_cast<size_t>(cinfo.output_scanline + i) * stride;
    jpeg_read_scanlines(&cinfo, rows, batch);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return kDecoded;
}

#endif  // M3F_LOADER_OWN

// Bilinear resize RGB uint8 (src WxH -> dst out_w x out_h), matching
// cv2.INTER_LINEAR's half-pixel-center sampling convention.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst,
                     int dw, int dh) {
  if (sw == dw && sh == dh) {
    memcpy(dst, src, static_cast<size_t>(sw) * sh * 3);
    return;
  }
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    if (y0 < 0) y0 = 0;
    // clamp the weight to [0,1]: when fy falls past the last source row the
    // raw fy-y0 would extrapolate (>1) and the uint8 cast below would wrap
    float wy = fy - y0;
    if (wy > 1.0f) wy = 1.0f;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      if (x0 < 0) x0 = 0;
      float wx = fx - x0;
      if (wx > 1.0f) wx = 1.0f;
      // degenerate 1-px-wide/tall sources: neighbor indices clamp to the
      // same row/col instead of dereferencing past the buffer (ADVICE r1)
      const int y1 = (y0 + 1 < sh) ? y0 + 1 : y0;
      const int x1 = (x0 + 1 < sw) ? x0 + 1 : x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * 3;
      uint8_t* o = dst + (static_cast<size_t>(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v0 = p00[c] + (p01[c] - p00[c]) * wx;
        const float v1 = p10[c] + (p11[c] - p10[c]) * wx;
        float v = v0 + (v1 - v0) * wy + 0.5f;
        if (v < 0.0f) v = 0.0f;
        if (v > 255.0f) v = 255.0f;
        o[c] = static_cast<uint8_t>(v);
      }
    }
  }
}

// Simple work-stealing-free parallel for: items [0, n) over k threads.
void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> threads;
  const int k = std::min(n_threads, n);
  threads.reserve(k - 1);
  for (int t = 1; t < k; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Decode n JPEGs into out[n, H, W, 3] RGB.  ok_out[i] (may be null) gets
// the slot's Decoded value; a slot that is not kDecoded is zeroed.
// Returns the number of slots that are not.
int m3f_decode_jpeg_batch(const char** paths, int n, uint8_t* out, int out_h,
                          int out_w, int n_threads, uint8_t* ok_out) {
  std::atomic<int> failed{0};
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * 3;
  parallel_for(n, n_threads, [&](int i) {
    uint8_t* slot = out + i * img_bytes;
    Decoded st = kFailed;
    if (paths[i] && paths[i][0]) {  // empty path = intentionally missing
      thread_local std::vector<uint8_t> scratch;
      int w = 0, h = 0;
      st = decode_jpeg_file(paths[i], scratch, slot, out_w, out_h, &w, &h);
      if (st == kDecoded && (w != out_w || h != out_h))
        resize_bilinear(scratch.data(), w, h, slot, out_w, out_h);
    }
    if (st != kDecoded) {
      memset(slot, 0, img_bytes);
      failed.fetch_add(1);
    }
    if (ok_out) ok_out[i] = static_cast<uint8_t>(st);
  });
  return failed.load();
}

int m3f_loader_self_test() { return 42; }

}  // extern "C"
