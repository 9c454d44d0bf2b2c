// Host JPEG decoder whose pixels are bitwise libjpeg's default decode (the
// decode Pillow, OpenCV and the JAX package's native loader give through
// libjpeg-turbo): Huffman-coded baseline, extended-sequential and
// progressive 8-bit files, one or three components, any sampling factors
// libjpeg takes, restart intervals with libjpeg's resynchronisation, the
// islow integer IDCT with its range-limit table, libjpeg-turbo's fancy
// upsampling rules and the fixed-point YCbCr -> RGB tables.  Output is
// uint8 BGR [H, W, 3]; grey is replicated to three channels.
//
// What libjpeg rejects fails here too, and so do four files libjpeg-turbo
// could read but this decoder does not: CMYK / YCCK (four components),
// 12-bit samples, arithmetic coding and lossless (SOF3).  Data that ends
// before the image is complete fails (Pillow's truncated-image error).
// A progressive file whose scans leave some coefficients unsent would get
// libjpeg's block smoothing; that case fails instead of differing.
//
// Plain C interface, loaded through ctypes:
//   int nct_jpeg_decode(const uint8_t *data, size_t n, int *height,
//                       int *width, uint8_t **bgr, char *err, size_t errlen)
//   void nct_jpeg_free(uint8_t *bgr)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw JpegError{msg}; }

// Zigzag -> natural order, with libjpeg's 16 extra entries so that a
// corrupt run length past 63 lands on the last coefficient.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int count = 0;
  // derived (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_len[256];
  uint8_t look_sym[256];
};

void derive(HuffTable &t, bool is_dc) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) fail("bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look_len, 0, sizeof t.look_len);
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int look = huffcode[p] << (8 - l);
      for (int c = 1 << (8 - l); c > 0; c--, look++) {
        t.look_len[look] = static_cast<uint8_t>(l);
        t.look_sym[look] = t.vals[p];
      }
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++)
      if (t.vals[i] > 15) fail("bad Huffman table (DC symbol above 15)");
  }
}

// Entropy-coded data reader with libjpeg's semantics: 0xFF00 is a data
// 0xFF; a marker stops the reader, after which zeros are supplied and the
// segment counts as out of data once a needed bit is missing.
struct BitReader {
  const uint8_t *d;
  size_t n;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  int marker = 0;       // libjpeg's unread_marker
  bool insufficient = false;

  uint8_t byte() {
    if (pos >= n) fail("truncated: the data ends inside a scan");
    return d[pos++];
  }
  void fill() {
    while (cnt <= 56 && !marker) {
      uint8_t c = byte();
      if (c == 0xFF) {
        uint8_t c2;
        do c2 = byte(); while (c2 == 0xFF);
        if (c2 != 0) {
          marker = c2;
          return;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - cnt);
      cnt += 8;
    }
  }
  unsigned peek(int nb) {
    if (cnt < nb) fill();
    return static_cast<unsigned>(buf >> (64 - nb));
  }
  void consume(int nb) {
    if (nb > cnt) {
      insufficient = true;
      buf = 0;
      cnt = 0;
    } else {
      buf <<= nb;
      cnt -= nb;
    }
  }
  int bits(int nb) {
    if (nb == 0) return 0;
    unsigned v = peek(nb);
    consume(nb);
    return static_cast<int>(v);
  }
  int decode(const HuffTable &t) {
    unsigned look = peek(8);
    if (t.look_len[look]) {
      consume(t.look_len[look]);
      return t.look_sym[look];
    }
    int l = 9;
    int32_t code = bits(9);
    while (code > t.maxcode[l]) {
      code = (code << 1) | bits(1);
      l++;
    }
    if (l > 16) return 0;  // libjpeg: bad code, a zero is the safest result
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // jdmarker.c next_marker: skip to the next 0xFF <code>, code != 0
  int next_marker() {
    for (;;) {
      uint8_t c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (-(1 << s) + 1) : r;
}

struct Component {
  int id, h, v, tq;
  int comp_w, comp_h;          // downsampled size
  int bw, bh;                  // coefficient array size in blocks
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int quant[64];
  bool quant_latched = false;
  int coef_bits[64];           // progressive: -1 = not yet received
};

struct Decoder {
  const uint8_t *d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool saw_sof = false, progressive = false;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  int scans = 0;
  std::vector<Component> comps;

  uint8_t u8() {
    if (pos >= n) fail("truncated: the data ends inside a marker segment");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void read_app(int marker, int length) {
    size_t start = pos;
    int datalen = length - 2;
    if (datalen < 0) fail("bad marker length");
    if (pos + datalen > n) fail("truncated: the data ends inside a marker segment");
    const uint8_t *p = d + pos;
    if (marker == 0xE0 && datalen >= 14 && p[0] == 'J' && p[1] == 'F' &&
        p[2] == 'I' && p[3] == 'F' && p[4] == 0)
      saw_jfif = true;
    if (marker == 0xEE && datalen >= 12 && p[0] == 'A' && p[1] == 'd' &&
        p[2] == 'o' && p[3] == 'b' && p[4] == 'e') {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos = start + datalen;
  }

  void read_dqt(int length) {
    length -= 2;
    while (length > 0) {
      int b = u8();
      length--;
      int prec = b >> 4, idx = b & 15;
      if (idx >= 4) fail("bad quantisation table index");
      for (int i = 0; i < 64; i++) {
        int v = prec ? u16() : u8();
        qt[idx][kNatural[i]] = static_cast<uint16_t>(v);
      }
      length -= prec ? 128 : 64;
      qt_defined[idx] = true;
    }
    if (length != 0) fail("bad DQT marker length");
  }

  void read_dht(int length) {
    length -= 2;
    while (length > 16) {
      int index = u8();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = u8();
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail("bad Huffman table");
      HuffTable *t;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) fail("bad Huffman table index");
        t = &ac[index];
      } else {
        if (index < 0 || index >= 4) fail("bad Huffman table index");
        t = &dc[index];
      }
      std::memcpy(t->bits, bits, sizeof bits);
      std::memset(t->vals, 0, sizeof t->vals);
      for (int i = 0; i < count; i++) t->vals[i] = u8();
      t->count = count;
      t->defined = true;
      length -= count;
    }
    if (length != 0) fail("bad DHT marker length");
  }

  void read_sof(int marker, int length) {
    if (saw_sof) fail("two SOF markers");
    saw_sof = true;
    progressive = marker == 0xC2;
    int precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision == 12) fail("12-bit precision is not supported");
    if (precision != 8) fail("unsupported precision " + std::to_string(precision));
    if (height <= 0 || width <= 0 || nc <= 0)
      fail("empty image (zero height, width or components)");
    if (length - 8 != nc * 3) fail("bad SOF marker length");
    if (nc == 4) fail("CMYK / YCCK (4 components) is not supported");
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + " components are not supported");
    comps.resize(nc);
    for (auto &c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
      if (c.tq > 3) fail("bad quantisation table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto &c : comps) {
      c.comp_w = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.comp_h = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int &b : c.coef_bits) b = -1;
    }
  }

  // jdmarker.c read_restart_marker + jpeg_resync_to_restart
  void restart(BitReader &br, int &next_rst) {
    br.buf = 0;
    br.cnt = 0;
    if (br.marker == 0) br.marker = br.next_marker();
    if (br.marker == 0xD0 + next_rst) {
      br.marker = 0;
    } else {
      for (;;) {
        int m = br.marker;
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((next_rst + 1) & 7) ||
                   m == 0xD0 + ((next_rst + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((next_rst - 1) & 7) ||
                   m == 0xD0 + ((next_rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          br.marker = 0;
          break;
        }
        if (action == 3) break;
        br.marker = br.next_marker();
      }
    }
    next_rst = (next_rst + 1) & 7;
    if (br.marker == 0) br.insufficient = false;
  }

  void read_sos(int length) {
    if (!saw_sof) fail("SOS before SOF");
    int ns = u8();
    if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail("bad SOS marker length");
    std::vector<int> sc(ns), td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int cid = u8();
      int t = u8();
      int ci = -1;
      for (size_t k = 0; k < comps.size(); k++)
        if (comps[k].id == cid) ci = static_cast<int>(k);
      if (ci < 0) fail("bad component id in SOS");
      for (int k = 0; k < i; k++)
        if (sc[k] == ci) fail("bad component id in SOS");
      sc[i] = ci;
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    scans++;
    for (int ci : sc) {
      Component &c = comps[ci];
      if (!c.quant_latched) {
        if (!qt_defined[c.tq]) fail("quantisation table not defined");
        for (int k = 0; k < 64; k++) c.quant[k] = qt[c.tq][k];
        c.quant_latched = true;
      }
    }
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63) bad = true;
        if (ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("bad progression parameters");
      for (int ci : sc) {
        int *cb = comps[ci].coef_bits;
        for (int k = ss; k <= se; k++) cb[k] = al;
      }
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    // tables used by this scan
    std::vector<const HuffTable *> dct(ns, nullptr), act(ns, nullptr);
    for (int i = 0; i < ns; i++) {
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if (need_dc) {
        if (td[i] > 3 || !dc[td[i]].defined)
          fail("Huffman table not defined (no DHT for a table the scan uses)");
        derive(dc[td[i]], true);
        dct[i] = &dc[td[i]];
      }
      if (need_ac) {
        if (ta[i] > 3 || !ac[ta[i]].defined)
          fail("Huffman table not defined (no DHT for a table the scan uses)");
        derive(ac[ta[i]], false);
        act[i] = &ac[ta[i]];
      }
    }
    // MCU layout
    int mcus_x, mcus_y, blocks = 0;
    if (ns == 1) {
      const Component &c = comps[sc[0]];
      mcus_x = (c.comp_w + 7) / 8;
      mcus_y = (c.comp_h + 7) / 8;
      blocks = 1;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
      for (int ci : sc) blocks += comps[ci].h * comps[ci].v;
      if (blocks > 10) fail("too many blocks in an MCU");
    }

    BitReader br{d, n, pos};
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    const int p1 = 1 << al, m1 = -(1 << al);

    auto decode_block = [&](int i, int16_t *blk) {
      if (!progressive) {
        int s = br.decode(*dct[i]);
        if (s) s = extend(br.bits(s), s);
        s += last_dc[i];
        last_dc[i] = s;
        blk[0] = static_cast<int16_t>(s);
        const HuffTable &t = *act[i];
        for (int k = 1; k < 64; k++) {
          int rs = br.decode(t);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            s = extend(br.bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(s);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      } else if (ss == 0 && ah == 0) {      // DC first
        int s = br.decode(*dct[i]);
        if (s) s = extend(br.bits(s), s);
        s += last_dc[i];
        last_dc[i] = s;
        blk[0] = static_cast<int16_t>(static_cast<unsigned>(s) << al);
      } else if (ss == 0) {                 // DC refine
        if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
      } else if (ah == 0) {                 // AC first
        if (eobrun > 0) {
          eobrun--;
          return;
        }
        const HuffTable &t = *act[i];
        for (int k = ss; k <= se; k++) {
          int rs = br.decode(t);
          int r = rs >> 4;
          int s = rs & 15;
          if (s) {
            k += r;
            s = extend(br.bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            eobrun--;
            break;
          }
        }
      } else {                              // AC refine
        const HuffTable &t = *act[i];
        int k = ss;
        auto refine = [&](int16_t &c) {
          if (br.bits(1) && (c & p1) == 0)
            c = static_cast<int16_t>(c >= 0 ? c + p1 : c + m1);
        };
        if (eobrun == 0) {
          for (; k <= se; k++) {
            int rs = br.decode(t);
            int r = rs >> 4;
            int s = rs & 15;
            if (s) {
              s = br.bits(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1 << r;
              if (r) eobrun += br.bits(r);
              break;
            }
            do {
              int16_t &c = blk[kNatural[k]];
              if (c != 0) {
                refine(c);
              } else {
                if (--r < 0) break;
              }
              k++;
            } while (k <= se);
            if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
          }
        }
        if (eobrun > 0) {
          for (; k <= se; k++) {
            int16_t &c = blk[kNatural[k]];
            if (c != 0) refine(c);
          }
          eobrun--;
        }
      }
    };

    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            restart(br, next_rst);
            for (int &v : last_dc) v = 0;
            eobrun = 0;
            restarts_to_go = restart_interval;
          }
          restarts_to_go--;
        }
        if (br.insufficient) continue;
        if (ns == 1) {
          Component &c = comps[sc[0]];
          decode_block(0, &c.coef[(static_cast<size_t>(my) * c.bw + mx) * 64]);
        } else {
          for (int i = 0; i < ns; i++) {
            Component &c = comps[sc[i]];
            for (int yy = 0; yy < c.v; yy++)
              for (int xx = 0; xx < c.h; xx++) {
                size_t b = static_cast<size_t>(my * c.v + yy) * c.bw + mx * c.h + xx;
                decode_block(i, &c.coef[b * 64]);
              }
          }
        }
      }
    }
    // finish the scan: drop the unused bits; a marker the reader met is
    // the next one to handle
    // A reader that wants a byte past the end fails above: libjpeg waits
    // for more data there, and Pillow reports a truncated file.
    single_scan_image = scans == 1 && !progressive && ns == static_cast<int>(comps.size());
    pos = br.pos;
    if (br.marker) pending_marker = br.marker;
  }

  int pending_marker = 0;
  bool single_scan_image = false;

  // The next marker; the end of the data after a one-scan image reads as
  // EOI (every pixel row is out, so Pillow accepts the file).
  int next_marker() {
    if (pending_marker) {
      int m = pending_marker;
      pending_marker = 0;
      return m;
    }
    for (;;) {
      if (single_scan_image) {
        size_t p = pos;
        while (p < n && d[p] != 0xFF) p++;
        while (p < n && d[p] == 0xFF) p++;
        if (p >= n) return 0xD9;
      }
      uint8_t c = u8();
      while (c != 0xFF) c = u8();
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void parse() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                                   // EOI
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;   // RSTn, TEM
      if (m == 0xD8) fail("two SOI markers");
      if (m == 0xC3) fail("lossless JPEG (SOF3) is not supported");
      if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF))
        fail("arithmetic coding is not supported");
      if (m >= 0xC5 && m <= 0xC7) fail("hierarchical JPEG (SOF5-7) is not supported");
      int length = u16();
      if (length < 2) fail("bad marker length");
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(m, length);
          break;
        case 0xC4:
          read_dht(length);
          break;
        case 0xDB:
          read_dqt(length);
          break;
        case 0xDD:
          if (length != 4) fail("bad DRI marker length");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos(length);
          break;
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xCC || m == 0xDC) {
            read_app(m, length);
          } else {
            char buf[48];
            std::snprintf(buf, sizeof buf, "unknown JPEG marker 0x%02X", m);
            fail(buf);
          }
      }
    }
    if (!saw_sof || scans == 0) fail("JPEG file without image data");
    if (progressive) {
      for (auto &c : comps)
        for (int k = 0; k < 64; k++)
          if (c.coef_bits[k] != 0)
            fail("progressive scans leave coefficients unsent (libjpeg "
                 "would smooth the blocks)");
    }
  }
};

// jidctint.c (islow), with jdmaster.c's range-limit table folded in:
// a result is masked to 10 bits, read as signed, offset by 128 and clamped.
// libjpeg's JLONG is 64-bit on LP64 hosts; so are the sums here.
const int kConstBits = 13, kPass1Bits = 2;
const int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
              F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
              F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
              F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline uint8_t range_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

void idct_islow(const int16_t *in, const int *q, uint8_t *out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const int *qp = q + c;
    int32_t *wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (ip[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int32_t)descale(tmp10 + tmp3, sh);
    wp[56] = (int32_t)descale(tmp10 - tmp3, sh);
    wp[8] = (int32_t)descale(tmp11 + tmp2, sh);
    wp[48] = (int32_t)descale(tmp11 - tmp2, sh);
    wp[16] = (int32_t)descale(tmp12 + tmp1, sh);
    wp[40] = (int32_t)descale(tmp12 - tmp1, sh);
    wp[24] = (int32_t)descale(tmp13 + tmp0, sh);
    wp[32] = (int32_t)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t *wp = ws + r * 8;
    uint8_t *op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = range_limit(descale(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = range_limit(descale(tmp10 + tmp3, sh));
    op[7] = range_limit(descale(tmp10 - tmp3, sh));
    op[1] = range_limit(descale(tmp11 + tmp2, sh));
    op[6] = range_limit(descale(tmp11 - tmp2, sh));
    op[2] = range_limit(descale(tmp12 + tmp1, sh));
    op[5] = range_limit(descale(tmp12 - tmp1, sh));
    op[3] = range_limit(descale(tmp13 + tmp0, sh));
    op[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// One component at full resolution [height, width], by jdsample.c's
// method for its factors.  `plane` holds the IDCT output, `stride` wide;
// rows and columns past the downsampled size are never read: the
// neighbours of the last row and column are the row and column itself,
// as jdmainct.c's context rows and jdsample.c's edge cases make them.
std::vector<uint8_t> upsample(const Decoder &dec, const Component &c,
                              const std::vector<uint8_t> &plane, int stride) {
  const int W = dec.width, H = dec.height;
  const int cw = c.comp_w, ch = c.comp_h;
  const int hx = dec.hmax / c.h, vx = dec.vmax / c.v;
  std::vector<uint8_t> out(static_cast<size_t>(W) * H);
  // one downsampled row, one column of edge replica on each side
  std::vector<int> cur(cw + 2), nb(cw + 2);
  auto load = [&](std::vector<int> &dst, int y, int mul) {
    y = y < 0 ? 0 : y >= ch ? ch - 1 : y;
    const uint8_t *row = &plane[static_cast<size_t>(y) * stride];
    for (int i = 0; i < cw; i++) dst[i + 1] = row[i] * mul;
    dst[0] = dst[1];
    dst[cw + 1] = dst[cw];
  };
  const bool h2v1 = hx == 2 && vx == 1 && cw > 2;
  const bool h1v2 = hx == 1 && vx == 2;
  const bool h2v2 = hx == 2 && vx == 2 && cw > 2;
  for (int y = 0; y < H; y++) {
    uint8_t *op = &out[static_cast<size_t>(y) * W];
    if (h1v2 || h2v2) {
      // the nearer row (x3) plus the row above (even y) or below (odd y)
      int j = y >> 1;
      load(cur, j, 3);
      load(nb, (y & 1) ? j + 1 : j - 1, 1);
      for (int i = 0; i < cw + 2; i++) cur[i] += nb[i];
      if (h1v2) {
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; x++)
          op[x] = static_cast<uint8_t>((cur[x + 1] + bias) >> 2);
      } else {
        for (int x = 0; x < W; x++) {
          const int i = (x >> 1) + 1, t = cur[i] * 3;
          op[x] = static_cast<uint8_t>((x & 1) ? (t + cur[i + 1] + 7) >> 4
                                               : (t + cur[i - 1] + 8) >> 4);
        }
      }
    } else if (h2v1) {
      load(cur, y, 1);
      for (int x = 0; x < W; x++) {
        const int i = (x >> 1) + 1, t = cur[i] * 3;
        op[x] = static_cast<uint8_t>((x & 1) ? (t + cur[i + 1] + 2) >> 2
                                             : (t + cur[i - 1] + 1) >> 2);
      }
    } else {  // copy (1x1) or box replication: int_upsample, h2v1 / h2v2_upsample
      const uint8_t *row = &plane[static_cast<size_t>(std::min(y / vx, ch - 1)) * stride];
      if (hx == 1) {
        std::memcpy(op, row, W);
      } else {
        for (int x = 0; x < W; x++) op[x] = row[std::min(x / hx, cw - 1)];
      }
    }
  }
  return out;
}

std::vector<uint8_t> decode(const uint8_t *data, size_t n, int &H, int &W) {
  Decoder dec;
  dec.d = data;
  dec.n = n;
  dec.parse();
  H = dec.height;
  W = dec.width;
  for (const auto &c : dec.comps)
    if (dec.hmax % c.h || dec.vmax % c.v)
      fail("fractional sampling factors are not supported");
  std::vector<std::vector<uint8_t>> full;
  for (const auto &c : dec.comps) {
    int stride = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8);
    int nbx = (c.comp_w + 7) / 8, nby = (c.comp_h + 7) / 8;
    for (int by = 0; by < nby; by++)
      for (int bx = 0; bx < nbx; bx++)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                   &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
    full.push_back(upsample(dec, c, plane, stride));
  }
  std::vector<uint8_t> bgr(static_cast<size_t>(W) * H * 3);
  size_t npx = static_cast<size_t>(W) * H;
  if (dec.comps.size() == 1) {
    for (size_t i = 0; i < npx; i++)
      bgr[3 * i] = bgr[3 * i + 1] = bgr[3 * i + 2] = full[0][i];
    return bgr;
  }
  // jdapimin.c default_decompress_parms (libjpeg-turbo): JFIF means YCbCr;
  // else Adobe's transform decides; else the IDs 'R','G','B' mean RGB.
  bool rgb;
  if (dec.saw_jfif) {
    rgb = false;
  } else if (dec.saw_adobe) {
    rgb = dec.adobe_transform == 0;
  } else {
    rgb = dec.comps[0].id == 'R' && dec.comps[1].id == 'G' && dec.comps[2].id == 'B';
  }
  if (rgb) {
    for (size_t i = 0; i < npx; i++) {
      bgr[3 * i] = full[2][i];
      bgr[3 * i + 1] = full[1][i];
      bgr[3 * i + 2] = full[0][i];
    }
    return bgr;
  }
  // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
  const int kScale = 16;
  const int32_t half = 1 << (kScale - 1);
  auto FIX = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    int x = i - 128;
    cr_r[i] = (FIX(1.40200) * x + half) >> kScale;
    cb_b[i] = (FIX(1.77200) * x + half) >> kScale;
    cr_g[i] = -FIX(0.71414) * x;
    cb_g[i] = -FIX(0.34414) * x + half;
  }
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npx; i++) {
    int y = full[0][i], cb = full[1][i], cr = full[2][i];
    bgr[3 * i + 2] = clamp(y + cr_r[cr]);
    bgr[3 * i + 1] = clamp(y + ((cb_g[cb] + cr_g[cr]) >> kScale));
    bgr[3 * i] = clamp(y + cb_b[cb]);
  }
  return bgr;
}

}  // namespace

extern "C" {

int nct_jpeg_decode(const uint8_t *data, size_t n, int *height, int *width,
                    uint8_t **bgr, char *err, size_t errlen) {
  try {
    int H = 0, W = 0;
    std::vector<uint8_t> out = decode(data, n, H, W);
    uint8_t *buf = static_cast<uint8_t *>(std::malloc(out.size()));
    if (!buf) fail("out of memory");
    std::memcpy(buf, out.data(), out.size());
    *height = H;
    *width = W;
    *bgr = buf;
    return 0;
  } catch (const JpegError &e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::exception &e) {
    std::snprintf(err, errlen, "%s", e.what());
  }
  return 1;
}

void nct_jpeg_free(uint8_t *bgr) { std::free(bgr); }

}  // extern "C"
