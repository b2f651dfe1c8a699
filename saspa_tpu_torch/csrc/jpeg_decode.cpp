// Host JPEG decoder that gives the pixels of PIL's `Image.open(p).convert("RGB")`
// where PIL links libjpeg-turbo with its default decompression settings.
//
// It follows libjpeg's structure stage by stage, so that every rounding is
// libjpeg's:
//   * entropy decoding: Huffman, baseline/extended sequential (jdhuff.c) and
//     progressive with spectral selection and successive approximation
//     (jdphuff.c), restart intervals; every scan fills one coefficient array
//     per component, and the image is reconstructed once the file is read
//     to EOI (libjpeg's buffered-image path: block smoothing only acts on
//     coefficients still unknown, and none is once every scan is in);
//   * the slow-but-accurate integer IDCT, jpeg_idct_islow (jidctint.c,
//     CONST_BITS 13, PASS1_BITS 2), its output clamped to 0..255 as the
//     SIMD versions' saturating packs clamp it;
//   * "fancy" chroma upsampling (jdsample.c): h2v1_fancy_upsample (4:2:2)
//     and h2v2_fancy_upsample (4:2:0) with their rounding biases, the image
//     edge rows replicated as jdmainct.c's context pointers replicate them,
//     and plain replication where the downsampled width is 2 or less;
//   * YCbCr -> RGB with jdcolor.c's fixed-point tables (SCALEBITS 16).
// Blocks past the right and bottom edges are decoded whole and cut off.
//
// Refused, with the feature named: arithmetic coding, lossless and
// hierarchical frames, 12-bit samples, other than 1 or 3 components, an
// RGB colour transform (Adobe APP14 transform 0, or R/G/B component ids),
// and sampling layouts other than 1x1, 2x1 and 2x2 over each component.
// A file that ends before its EOI marker raises "truncated", as PIL does.
//
// Plain C interface (no PyTorch headers): jpeg_header() reads the frame's
// size and component count, jpeg_decode() writes (H, W, C) uint8.  Both
// return 0, or 1 (corrupt or truncated) / 2 (unsupported) with a message.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  int code;
  JpegError(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

[[noreturn]] void corrupt(const std::string& m) { throw JpegError(1, m); }
[[noreturn]] void unsupported(const std::string& m) { throw JpegError(2, m); }

// zigzag index -> natural (row-major) index, padded as libjpeg pads it so
// that a corrupt run past 63 stays inside the block
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

// the JPEG standard's example tables (K.3), which libjpeg installs in
// slots 0 and 1 where a file defines none (jstdhuff.c: motion-JPEG frames
// leave them out)
const uint8_t kStdBits[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},          // DC 0
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},          // DC 1
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},       // AC 0
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};      // AC 1
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
     0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
     0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
     0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // codes of kLookBits bits or fewer: (length << 8) | symbol, 0 = longer
  uint16_t look[1 << kLookBits];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym, bool dc) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l - 1]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) corrupt("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += counts[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memcpy(vals, symbols, nsym);
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < counts[l - 1]; i++, p++) {
        int base = huffcode[p] << (kLookBits - l);
        for (int c = 0; c < (1 << (kLookBits - l)); c++) look[base + c] = uint16_t((l << 8) | symbols[p]);
      }
    }
    if (dc)
      for (int i = 0; i < nsym; i++)
        if (symbols[i] > 15) corrupt("bad Huffman table");
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;      // blocks per row / column, padded to whole MCUs
  int ds_w = 0, ds_h = 0;  // libjpeg's downsampled_width / downsampled_height
  bool latched = false;
  uint16_t quant[64];
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int last_dc = 0;
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;  // left-aligned
  int cnt = 0;
  bool marker = false;  // hit a marker: feed zeros from here on

  void reset(size_t p) {
    pos = p;
    acc = 0;
    cnt = 0;
    marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      unsigned c = 0;
      if (!marker) {
        if (pos >= n) corrupt("image file is truncated");
        c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q >= n) corrupt("image file is truncated");
          if (d[q] == 0) {
            pos = q + 1;
          } else {
            marker = true;
            pos = q - 1;  // at the FF before the marker code
            c = 0;
          }
        } else {
          pos++;
        }
      }
      acc |= uint64_t(c) << (56 - cnt);
      cnt += 8;
    }
  }
  inline unsigned bits(int k) {  // k in 1..16
    if (cnt < k) fill();
    unsigned r = unsigned(acc >> (64 - k));
    acc <<= k;
    cnt -= k;
    return r;
  }
  inline unsigned bit() { return bits(1); }
  inline int decode(const Huff& t) {
    if (cnt < 16) fill();
    unsigned e = t.look[acc >> (64 - kLookBits)];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int32_t code = int32_t(acc >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = int32_t(acc >> (64 - l));
    }
    if (l > 16) {  // libjpeg warns and returns 0 (JWRN_HUFF_BAD_CODE)
      acc <<= 16;
      cnt -= 16;
      return 0;
    }
    acc <<= l;
    cnt -= l;
    return t.vals[code + t.valoffset[l]];
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + int((~0u) << s) + 1 : r; }

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  bool progressive = false, frame = false, eoi = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[4];

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u16(size_t p) {
    if (p + 2 > n) corrupt("image file is truncated");
    return (d[p] << 8) | d[p + 1];
  }

  // next marker code at or after pos, skipping garbage and fill bytes
  int next_marker() {
    while (true) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) corrupt("image file is truncated");
      int m = d[pos++];
      if (m != 0) return m;
    }
  }

  void read_header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) corrupt("not a JPEG file");
    while (!frame) process_marker(next_marker());
  }

  // handles one marker segment; returns true at the start of a scan
  bool process_marker(int m) {
    if (m == 0xD9) {
      eoi = true;
      return false;
    }
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return false;
    int len = u16(pos);
    if (len < 2 || pos + len > n) corrupt("image file is truncated");
    const uint8_t* s = d + pos + 2;
    int L = len - 2;
    size_t end = pos + len;
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: sof(m, s, L); break;
      case 0xC3: case 0xC7: case 0xCB: case 0xCF: unsupported("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC5: case 0xC6: unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      case 0xC9: case 0xCA: case 0xCD: case 0xCE: case 0xCC:
        unsupported("arithmetic-coded JPEG (" + std::string(m == 0xCC ? "DAC" : "SOF" + std::to_string(m - 0xC0)) + ")");
      case 0xC4: dht(s, L); break;
      case 0xDB: dqt(s, L); break;
      case 0xDD:
        if (L < 2) corrupt("bad DRI marker");
        restart_interval = (s[0] << 8) | s[1];
        break;
      case 0xDA: pos = end; sos(s, L); return true;
      case 0xE0:
        if (L >= 14 && memcmp(s, "JFIF\0", 5) == 0) jfif = true;
        break;
      case 0xEE:
        if (L >= 12 && memcmp(s, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = s[11];
        }
        break;
      default:
        if (m == 0xDC) unsupported("DNL marker");
        break;  // APPn, COM, anything else with a length: skipped
    }
    pos = end;
    return false;
  }

  void sof(int m, const uint8_t* s, int L) {
    if (frame) corrupt("duplicate SOF marker");
    if (L < 6) corrupt("bad SOF marker");
    int precision = s[0];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp = s[5];
    if (precision != 8) unsupported(std::to_string(precision) + "-bit samples");
    if (ncomp == 4) unsupported("4 components (CMYK/YCCK)");
    if (ncomp != 1 && ncomp != 3) unsupported(std::to_string(ncomp) + " components");
    if (L < 6 + 3 * ncomp) corrupt("bad SOF marker");
    if (height == 0 || width == 0) corrupt("empty JPEG image (DNL not supported)");
    progressive = (m == 0xC2);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad component in SOF marker");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      int rh = hmax / c.h, rv = vmax / c.v;
      bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
      if (!ok) {
        std::string lay;
        for (int j = 0; j < ncomp; j++)
          lay += (j ? "," : "") + std::to_string(comp[j].h) + "x" + std::to_string(comp[j].v);
        unsupported("sampling layout " + lay);
      }
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.ds_w = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.ds_h = int((int64_t(height) * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  void colour_check() {
    if (ncomp != 3) return;
    bool rgb;
    if (jfif) rgb = false;  // jdapimin.c: JFIF implies YCbCr
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    if (rgb) unsupported(adobe && !jfif ? "Adobe APP14 colour transform 0 (RGB)" : "RGB components (no colour transform)");
  }

  void dht(const uint8_t* s, int L) {
    int p = 0;
    while (p < L) {
      if (p + 17 > L) corrupt("bad DHT marker");
      int tc = s[p] >> 4, th = s[p] & 15;
      const uint8_t* counts = s + p + 1;
      int nsym = 0;
      for (int i = 0; i < 16; i++) nsym += counts[i];
      if (tc > 1 || th > 3 || nsym > 256 || p + 17 + nsym > L) corrupt("bad DHT marker");
      (tc ? ac[th] : dc[th]).build(counts, s + p + 17, nsym, tc == 0);
      p += 17 + nsym;
    }
  }

  void dqt(const uint8_t* s, int L) {
    int p = 0;
    while (p < L) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      int need = 1 + 64 * (pq ? 2 : 1);
      if (tq > 3 || pq > 1 || p + need > L) corrupt("bad DQT marker");
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = pq ? uint16_t((s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k]) : s[p + 1 + k];
      qt_defined[tq] = true;
      p += need;
    }
  }

  // ---- scans -----------------------------------------------------------

  int ns = 0;
  Component* sc[4];
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  unsigned eobrun = 0;

  bool scanned = false;

  void sos(const uint8_t* s, int L) {
    if (!frame) corrupt("scan without a frame header");
    if (!scanned) {  // jinit_huff_decoder / jinit_phuff_decoder: std_huff_tables
      for (int i = 0; i < 2; i++) {
        if (!dc[i].defined) dc[i].build(kStdBits[i], kStdDcVals, 12, true);
        if (!ac[i].defined) ac[i].build(kStdBits[2 + i], kStdAcVals[i], 162, false);
      }
      scanned = true;
    }
    ns = s[0];
    if (ns < 1 || ns > 4 || L != 4 + 2 * ns) corrupt("bad SOS marker");
    for (int i = 0; i < ns; i++) {
      int cid = s[1 + 2 * i], tbl = s[2 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) c = &comp[j];
      if (!c) corrupt("scan names a component the frame has not");
      c->dc_tbl = tbl >> 4;
      c->ac_tbl = tbl & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) corrupt("bad SOS marker");
      sc[i] = c;
    }
    Ss = s[1 + 2 * ns];
    Se = s[2 + 2 * ns];
    Ah = s[3 + 2 * ns] >> 4;
    Al = s[3 + 2 * ns] & 15;
    if (progressive) {
      bool bad = Ss > Se || Se > 63 || Ah > 13 || Al > 13 || (Ss == 0 && Se != 0) || (Ss > 0 && ns != 1);
      if (bad) corrupt("invalid progressive parameters");
    } else if (Ss != 0 || Se != 63 || Ah != 0 || Al != 0) {
      corrupt("invalid sequential scan parameters");
    }
    for (int i = 0; i < ns; i++) {
      Component* c = sc[i];
      bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      bool need_ac = !progressive || Ss > 0;
      if ((need_dc && !dc[c->dc_tbl].defined) || (need_ac && !ac[c->ac_tbl].defined)) {
        char msg[64];
        snprintf(msg, sizeof msg, "Huffman table 0x%02x was not defined", need_dc && !dc[c->dc_tbl].defined ? c->dc_tbl : 16 + c->ac_tbl);
        corrupt(msg);
      }
      if (!c->latched) {  // jdinput.c latch_quant_tables: a component's table as of its first scan
        if (!qt_defined[c->tq]) corrupt("quantization table " + std::to_string(c->tq) + " was not defined");
        memcpy(c->quant, qt[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      if (c->coef.empty()) c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
    }
    decode_scan();
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    if (!progressive) {
      int s = br.decode(dc[c.dc_tbl]);
      if (s) s = extend(br.bits(s), s);
      c.last_dc += s;
      blk[0] = int16_t(c.last_dc);
      const Huff& t = ac[c.ac_tbl];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(t), r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (Ss == 0) {
      if (Ah == 0) {  // DC first
        int s = br.decode(dc[c.dc_tbl]);
        if (s) s = extend(br.bits(s), s);
        c.last_dc += s;
        blk[0] = int16_t(unsigned(c.last_dc) << Al);
      } else if (br.bit()) {  // DC refinement
        blk[0] = int16_t(blk[0] | (1 << Al));
      }
      return;
    }
    const Huff& t = ac[c.ac_tbl];
    if (Ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = Ss; k <= Se; k++) {
        int rs = br.decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(unsigned(extend(br.bits(s), s)) << Al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) eobrun += br.bits(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << Al, m1 = int(~0u << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int rs = br.decode(t), r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  void restart(BitReader& br, int& next_rst) {
    size_t p = br.pos;  // the reader stopped at or before the marker
    pos = p;
    int m = next_marker();
    if (m != 0xD0 + next_rst) {
      // libjpeg resynchronises (jpeg_resync_to_restart); here a marker that
      // is not the expected RSTn ends the scan's data
      pos -= 2;
    }
    next_rst = (next_rst + 1) & 7;
    br.reset(pos);
    for (int i = 0; i < ns; i++) sc[i]->last_dc = 0;
    eobrun = 0;
  }

  void decode_scan() {
    BitReader br{d, n, pos};
    for (int i = 0; i < ns; i++) sc[i]->last_dc = 0;
    eobrun = 0;
    int next_rst = 0, togo = restart_interval;
    if (ns == 1) {  // non-interleaved: the component's own blocks, no MCU padding
      Component& c = *sc[0];
      int bw = (c.ds_w + 7) / 8, bh = (c.ds_h + 7) / 8;
      for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
          if (restart_interval) {
            if (togo == 0) {
              restart(br, next_rst);
              togo = restart_interval;
            }
            togo--;
          }
          decode_block(br, c, &c.coef[(size_t(by) * c.bw + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          if (restart_interval) {
            if (togo == 0) {
              restart(br, next_rst);
              togo = restart_interval;
            }
            togo--;
          }
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) {
                size_t by = size_t(my) * c.v + v, bx = size_t(mx) * c.h + h;
                decode_block(br, c, &c.coef[(by * c.bw + bx) * 64]);
              }
          }
        }
    }
    pos = br.pos;
  }

  void read_all() {
    while (!eoi) process_marker(next_marker());
    if (!frame) corrupt("JPEG without a frame header");
  }
};

// ---- reconstruction --------------------------------------------------------

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }
inline uint8_t clamp_idct(int32_t x) {  // x is the sample less 128
  x += 128;
  return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// jidctint.c jpeg_idct_islow: one 8x8 block into out (row stride `stride`)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dcval = (int32_t(ip[0]) * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
      continue;
    }
    int32_t z2 = int32_t(ip[16]) * qp[16], z3 = int32_t(ip[48]) * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(ip[0]) * qp[0];
    z3 = int32_t(ip[32]) * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(ip[56]) * qp[56];
    tmp1 = int32_t(ip[40]) * qp[40];
    tmp2 = int32_t(ip[24]) * qp[24];
    tmp3 = int32_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, S);
    wp[56] = descale(tmp10 - tmp3, S);
    wp[8] = descale(tmp11 + tmp2, S);
    wp[48] = descale(tmp11 - tmp2, S);
    wp[16] = descale(tmp12 + tmp1, S);
    wp[40] = descale(tmp12 - tmp1, S);
    wp[24] = descale(tmp13 + tmp0, S);
    wp[32] = descale(tmp13 - tmp0, S);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* op = out + size_t(r) * stride;
    constexpr int S = CONST_BITS + PASS1_BITS + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = clamp_idct(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp_idct(descale(tmp10 + tmp3, S));
    op[7] = clamp_idct(descale(tmp10 - tmp3, S));
    op[1] = clamp_idct(descale(tmp11 + tmp2, S));
    op[6] = clamp_idct(descale(tmp11 - tmp2, S));
    op[2] = clamp_idct(descale(tmp12 + tmp1, S));
    op[5] = clamp_idct(descale(tmp12 - tmp1, S));
    op[3] = clamp_idct(descale(tmp13 + tmp0, S));
    op[4] = clamp_idct(descale(tmp13 - tmp0, S));
  }
}

// the component's samples, bw*8 x bh*8 (a component no scan reached is flat grey)
std::vector<uint8_t> component_plane(Component& c) {
  size_t stride = size_t(c.bw) * 8;
  std::vector<uint8_t> plane(stride * c.bh * 8, 128);
  if (c.coef.empty()) return plane;
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant, &plane[size_t(by) * 8 * stride + size_t(bx) * 8],
                 int(stride));
  return plane;
}

// the component upsampled to width x height (jdsample.c), one byte a sample
std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane, int hmax, int vmax, int width,
                              int height) {
  size_t stride = size_t(c.bw) * 8;
  int rh = hmax / c.h, rv = vmax / c.v;
  std::vector<uint8_t> out(size_t(width) * height);
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < height; y++) memcpy(&out[size_t(y) * width], &plane[y * stride], width);
    return out;
  }
  int dw = c.ds_w;
  bool fancy = dw > 2;  // jinit_upsampler: fancy only where downsampled_width > 2
  std::vector<uint8_t> row(size_t(2) * dw + 2);
  for (int y = 0; y < height; y++) {
    int iy = rv == 2 ? y / 2 : y;
    const uint8_t* in0 = &plane[size_t(iy) * stride];
    if (!fancy) {
      for (int x = 0; x < dw; x++) row[2 * x] = row[2 * x + 1] = in0[x];
    } else if (rv == 1) {  // h2v1_fancy_upsample
      row[0] = in0[0];
      row[1] = uint8_t((in0[0] * 3 + in0[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        int v3 = in0[x] * 3;
        row[2 * x] = uint8_t((v3 + in0[x - 1] + 1) >> 2);
        row[2 * x + 1] = uint8_t((v3 + in0[x + 1] + 2) >> 2);
      }
      int x = dw - 1;
      row[2 * x] = uint8_t((in0[x] * 3 + in0[x - 1] + 1) >> 2);
      row[2 * x + 1] = in0[x];
    } else {  // h2v2_fancy_upsample: even rows lean on the row above, odd on the row below
      int ny = (y & 1) ? iy + 1 : iy - 1;
      if (ny < 0) ny = 0;
      if (ny > c.ds_h - 1) ny = c.ds_h - 1;
      const uint8_t* in1 = &plane[size_t(ny) * stride];
      int this_s = in0[0] * 3 + in1[0], next_s = in0[1] * 3 + in1[1], last_s;
      row[0] = uint8_t((this_s * 4 + 8) >> 4);
      row[1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
      for (int x = 1; x < dw - 1; x++) {
        next_s = in0[x + 1] * 3 + in1[x + 1];
        row[2 * x] = uint8_t((this_s * 3 + last_s + 8) >> 4);
        row[2 * x + 1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
      }
      int x = dw - 1;
      row[2 * x] = uint8_t((this_s * 3 + last_s + 8) >> 4);
      row[2 * x + 1] = uint8_t((this_s * 4 + 7) >> 4);
    }
    memcpy(&out[size_t(y) * width], row.data(), width);
  }
  return out;
}

struct ColourTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColourTables() {  // jdcolor.c build_ycc_rgb_table
    constexpr int SB = 16;
    constexpr int32_t HALF = int32_t(1) << (SB - 1);
    auto fix = [](double x) { return int32_t(x * (1 << SB) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
  }
};

inline uint8_t clamp8(int x) { return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x)); }

void fail(const JpegError& e, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.what());
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, size_t n, int* width, int* height, int* channels, char* err, int errlen) {
  try {
    Decoder dec(data, n);
    dec.read_header();
    *width = dec.width;
    *height = dec.height;
    *channels = dec.ncomp;
    return 0;
  } catch (const JpegError& e) {
    fail(e, err, errlen);
    return e.code;
  }
}

int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int width, int height, int channels, char* err,
                int errlen) {
  try {
    Decoder dec(data, n);
    dec.read_all();
    dec.colour_check();
    if (dec.width != width || dec.height != height || dec.ncomp != channels)
      throw JpegError(1, "frame header changed between calls");
    if (dec.ncomp == 1) {
      Component& c = dec.comp[0];
      std::vector<uint8_t> up = upsample(c, component_plane(c), dec.hmax, dec.vmax, width, height);
      memcpy(out, up.data(), up.size());
      return 0;
    }
    std::vector<uint8_t> p[3];
    for (int i = 0; i < 3; i++) {
      Component& c = dec.comp[i];
      std::vector<uint8_t> plane = component_plane(c);
      p[i] = upsample(c, plane, dec.hmax, dec.vmax, width, height);
      c.coef.clear();
      c.coef.shrink_to_fit();
    }
    static const ColourTables t;
    size_t npx = size_t(width) * height;
    for (size_t i = 0; i < npx; i++) {
      int y = p[0][i], cb = p[1][i], cr = p[2][i];
      out[3 * i] = clamp8(y + t.cr_r[cr]);
      out[3 * i + 1] = clamp8(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp8(y + t.cb_b[cb]);
    }
    return 0;
  } catch (const JpegError& e) {
    fail(e, err, errlen);
    return e.code;
  } catch (const std::bad_alloc&) {
    if (err && errlen > 0) snprintf(err, size_t(errlen), "out of memory");
    return 1;
  }
}

}  // extern "C"
