// Native FLAC decoder: the port's copy of the JAX package's
// native/flac_decoder.cc, with the frame CRCs checked.
//
// In-process replacement for the reference's audio loader, which shells out
// to ffmpeg per file (E/whisper/whisper_utils.py:17-54 spawns
// `ffmpeg -i file -f s16le ...`).
//
// Implements the FLAC subset sufficient for general 16/24-bit mono/stereo
// streams (constant/verbatim/fixed/LPC subframes, rice + rice2 residuals,
// all channel decorrelation modes).  Each frame's header CRC-8 and its
// CRC-16 are checked: a mismatch fails the decode.
//
// C ABI at the bottom; consumed via ctypes from python (audio/flac.py,
// which also checks STREAMINFO's MD5 of the samples).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // 0..7, MSB first
  bool error = false;

  uint32_t bit() {
    if (byte_pos >= size) { error = true; return 0; }
    uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return b;
  }

  uint64_t bits(int n) {  // n <= 64
    uint64_t v = 0;
    // fast path: byte-aligned whole bytes
    while (n >= 8 && bit_pos == 0) {
      if (byte_pos >= size) { error = true; return 0; }
      v = (v << 8) | data[byte_pos++];
      n -= 8;
    }
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  int64_t sbits(int n) {  // sign-extended
    uint64_t v = bits(n);
    if (n == 0) return 0;
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~(sign * 2 - 1)) : (int64_t)v;
  }

  uint32_t unary() {
    uint32_t q = 0;
    // scan for the terminating 1 bit
    while (true) {
      if (byte_pos >= size) { error = true; return q; }
      uint8_t cur = (uint8_t)(data[byte_pos] << bit_pos);
      if (cur == 0) {
        q += 8 - bit_pos;
        ++byte_pos; bit_pos = 0;
        continue;
      }
      int lead = __builtin_clz((uint32_t)cur) - 24;  // zeros in this byte
      q += lead;
      bit_pos += lead + 1;
      if (bit_pos >= 8) { bit_pos -= 8; ++byte_pos; }
      return q;
    }
  }

  void align() { if (bit_pos) { bit_pos = 0; ++byte_pos; } }
};

int64_t rice_read(BitReader& br, int param) {
  uint32_t q = br.unary();
  uint64_t r = param ? br.bits(param) : 0;
  uint64_t v = ((uint64_t)q << param) | r;
  return (v >> 1) ^ -(int64_t)(v & 1);  // zigzag
}

// UTF-8-style coded number (frame header sample/frame index)
bool read_coded_number(BitReader& br, uint64_t* out) {
  uint64_t b0 = br.bits(8);
  int n;
  if (b0 < 0x80) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { n = 1; b0 &= 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { n = 2; b0 &= 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { n = 3; b0 &= 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { n = 4; b0 &= 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { n = 5; b0 &= 0x01; }
  else if (b0 == 0xFE) { n = 6; b0 = 0; }
  else return false;
  uint64_t v = b0;
  for (int i = 0; i < n; ++i) {
    uint64_t c = br.bits(8);
    if ((c & 0xC0) != 0x80) return false;
    v = (v << 6) | (c & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residuals(BitReader& br, int order, int block_size,
                      std::vector<int64_t>& out) {
  int method = (int)br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  int escape = method == 0 ? 15 : 31;
  int porder = (int)br.bits(4);
  int partitions = 1 << porder;
  int samples_per = block_size >> porder;
  int idx = order;
  for (int p = 0; p < partitions; ++p) {
    int count = samples_per - (p == 0 ? order : 0);
    if (count < 0) return false;
    int param = (int)br.bits(plen);
    if (param == escape) {
      int raw = (int)br.bits(5);
      for (int i = 0; i < count; ++i) out[idx++] = br.sbits(raw);
    } else {
      for (int i = 0; i < count; ++i) out[idx++] = rice_read(br, param);
    }
    if (br.error) return false;
  }
  return true;
}

// CRC-8 (polynomial 0x07) of a frame header and CRC-16 (0x8005) of a
// frame, both from 0, MSB first, as the FLAC format defines them
uint8_t crc8(const uint8_t* p, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= p[i];
    for (int b = 0; b < 8; ++b)
      c = (uint8_t)((c & 0x80) ? (c << 1) ^ 0x07 : c << 1);
  }
  return c;
}

uint16_t crc16(const uint8_t* p, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= (uint16_t)(p[i] << 8);
    for (int b = 0; b < 8; ++b)
      c = (uint16_t)((c & 0x8000) ? (c << 1) ^ 0x8005 : c << 1);
  }
  return c;
}

const int kFixedOrders[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
  if (br.bit() != 0) return false;  // padding bit
  int type = (int)br.bits(6);
  int wasted = 0;
  if (br.bit()) wasted = 1 + (int)br.unary();
  bps -= wasted;
  out.assign(block_size, 0);
  if (type == 0) {  // constant
    int64_t v = br.sbits(bps);
    for (int i = 0; i < block_size; ++i) out[i] = v;
  } else if (type == 1) {  // verbatim
    for (int i = 0; i < block_size; ++i) out[i] = br.sbits(bps);
  } else if (type >= 8 && type <= 12) {  // fixed
    int order = type - 8;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    if (!decode_residuals(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += (int64_t)kFixedOrders[order][j] * out[i - 1 - j];
      out[i] += pred;
    }
  } else if (type >= 32) {  // LPC
    int order = type - 31;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    int precision = (int)br.bits(4) + 1;
    if (precision == 16) return false;  // invalid
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.sbits(precision);
    if (!decode_residuals(br, order, block_size, out)) return false;
    for (int i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (auto& v : out) v = (int64_t)((uint64_t)v << wasted);
  return !br.error;
}

struct StreamInfo {
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

const int kBlockSizes[16] = {0,    192,   576,   1152,  2304, 4608, -1, -2,
                             256,  512,   1024,  2048,  4096, 8192, 16384, 32768};
const int kSampleRates[16] = {0,     88200, 176400, 192000, 8000,  16000,
                              22050, 24000, 32000,  44100,  48000, 96000,
                              -1,    -2,    -3,     0};
const int kSampleSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};

}  // namespace

extern "C" {

// Decodes a FLAC file to interleaved int32 samples (native bit depth).
// Returns 0 on success.  Caller frees *samples with ewt_flac_free.
int ewt_flac_decode(const char* path, int32_t** samples, int64_t* n_samples,
                    int* sample_rate, int* channels, int* bits_per_sample) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (fsize < 8 || memcmp(buf.data(), "fLaC", 4) != 0) return -3;

  BitReader br{buf.data(), buf.size()};
  br.byte_pos = 4;

  StreamInfo si;
  bool last = false;
  while (!last) {
    last = br.bit();
    int type = (int)br.bits(7);
    uint32_t len = (uint32_t)br.bits(24);
    if (type == 0) {  // STREAMINFO
      br.bits(16);  // min block
      br.bits(16);  // max block
      br.bits(24);  // min frame
      br.bits(24);  // max frame
      si.sample_rate = (int)br.bits(20);
      si.channels = (int)br.bits(3) + 1;
      si.bps = (int)br.bits(5) + 1;
      si.total_samples = br.bits(36);
      br.bits(64); br.bits(64);  // md5
    } else {
      br.byte_pos += len;
    }
    if (br.error || br.byte_pos > buf.size()) return -4;
  }
  if (si.sample_rate == 0 || si.channels == 0) return -5;

  std::vector<int32_t> pcm;
  if (si.total_samples)
    pcm.reserve((size_t)si.total_samples * si.channels);
  std::vector<std::vector<int64_t>> ch(si.channels);

  while (br.byte_pos < buf.size()) {
    // frame sync (frames start on a byte)
    size_t frame_start = br.byte_pos;
    uint32_t sync = (uint32_t)br.bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return -6;
    br.bit();  // reserved
    br.bit();  // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_code = (int)br.bits(4);
    int ss_code = (int)br.bits(3);
    br.bit();  // reserved
    uint64_t coded;
    if (!read_coded_number(br, &coded)) return -7;
    int block_size;
    if (bs_code == 6) block_size = (int)br.bits(8) + 1;
    else if (bs_code == 7) block_size = (int)br.bits(16) + 1;
    else if (kBlockSizes[bs_code] > 0) block_size = kBlockSizes[bs_code];
    else return -8;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    int bps = ss_code ? kSampleSizes[ss_code] : si.bps;
    if (bps <= 0) return -9;
    if (br.error) return -12;
    uint8_t header_crc = crc8(buf.data() + frame_start,
                              br.byte_pos - frame_start);
    if (br.bits(8) != header_crc) return -14;

    int nch = si.channels;
    if (ch_code >= 8 && ch_code <= 10) nch = 2;  // stereo decorrelation
    else if (ch_code <= 7) nch = ch_code + 1;
    else return -10;

    for (int c = 0; c < nch; ++c) {
      int sub_bps = bps;
      // side channel carries one extra bit
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;
      if (!decode_subframe(br, block_size, sub_bps, ch[c])) return -11;
    }
    br.align();
    if (br.byte_pos > buf.size()) return -12;
    uint16_t frame_crc = crc16(buf.data() + frame_start,
                               br.byte_pos - frame_start);
    if (br.bits(16) != frame_crc) return -15;
    if (br.error) return -12;

    // undo inter-channel decorrelation
    if (ch_code == 8) {  // left/side
      for (int i = 0; i < block_size; ++i)
        ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) {  // right/side: ch0 = side, ch1 = right
      for (int i = 0; i < block_size; ++i)
        ch[0][i] = ch[1][i] + ch[0][i];
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < block_size; ++i) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }
    for (int i = 0; i < block_size; ++i)
      for (int c = 0; c < si.channels; ++c)
        pcm.push_back((int32_t)ch[c][i]);
  }

  auto* out = (int32_t*)malloc(pcm.size() * sizeof(int32_t));
  if (!out) return -13;
  memcpy(out, pcm.data(), pcm.size() * sizeof(int32_t));
  *samples = out;
  *n_samples = (int64_t)(pcm.size() / si.channels);
  *sample_rate = si.sample_rate;
  *channels = si.channels;
  *bits_per_sample = si.bps;
  return 0;
}

void ewt_flac_free(int32_t* p) { free(p); }

}  // extern "C"
