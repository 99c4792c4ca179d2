// LZF for the cascade hand-off's .h5 files (utils/h5.py), on the host.
//
// The hand-off files are written by h5py's LZF filter, which bundles
// liblzf 3.x (API 1.5) built with HLOG 17, the ULTRA_FAST hash
// ((h >> 7) - h) & 0x1ffff and, after a back-reference, only the position
// before its end entered into the table.  The encoder below is that
// compressor: for the same input and output limit it gives the same bytes,
// or 0 where the output would not fit.  Its one departure is deliberate:
// liblzf leaves its hash table uninitialised (stack memory), so a stale
// entry that happens to point into the current input can, in rare cases,
// offer a match that a clean table does not; here the table starts empty,
// so the output depends on the input alone.
//
// The decoder is the format's plain definition: a control byte below 32
// copies that many plus one literals; otherwise its top three bits (plus a
// byte when they are all set) give a back-reference of length + 2 bytes at
// distance ((ctrl & 31) << 8 | next) + 1, which may overlap its own output.
//
// Built with g++ by ops/build.py (load_host) into build/torch_kernels/.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr unsigned kHlog = 17;
constexpr unsigned kHsize = 1u << kHlog;
constexpr unsigned kMaxLit = 1u << 5;
constexpr unsigned long kMaxOff = 1ul << 13;
constexpr unsigned kMaxRef = (1u << 8) + (1u << 3);

inline unsigned idx(unsigned h) { return ((h >> (3 * 8 - kHlog)) - h) & (kHsize - 1); }

}  // namespace

extern "C" {

// Compress in[0, in_len) into out[0, out_len).  Returns the compressed
// length, or 0 where it would not fit in out_len bytes (liblzf's contract).
long lzf_encode(const uint8_t* in, long in_len, uint8_t* out, long out_len) {
  if (in_len <= 0 || out_len <= 0) return 0;
  // Positions + 1; 0 is "no entry", which the match test below rejects as
  // liblzf rejects a reference to the first input byte.
  std::vector<uint32_t> htab(kHsize, 0);
  const uint8_t* ip = in;
  const uint8_t* in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* out_end = out + out_len;
  int lit = 0;
  op++;  // start run
  unsigned hval = (unsigned(ip[0]) << 8) | ip[in_len > 1 ? 1 : 0];
  while (ip < in_end - 2) {
    hval = (hval << 8) | ip[2];
    const unsigned slot = idx(hval);
    const uint32_t stored = htab[slot];
    htab[slot] = uint32_t(ip - in) + 1;
    const uint8_t* ref = stored ? in + (stored - 1) : in;
    const unsigned long off = (unsigned long)(ip - ref - 1);
    if (off < kMaxOff && ip + 4 < in_end && ref > in && ref[0] == ip[0] &&
        ref[1] == ip[1] && ref[2] == ip[2]) {
      unsigned len = 2;
      unsigned maxlen = unsigned(in_end - ip) - len;
      if (maxlen > kMaxRef) maxlen = kMaxRef;
      if (op + 3 + 1 >= out_end)
        if (op - !lit + 3 + 1 >= out_end) return 0;
      op[-lit - 1] = uint8_t(lit - 1);  // stop run
      op -= !lit;                       // undo run if length is zero
      // liblzf's unrolled first 16 compares check no bound, so a match
      // that runs past them ends up to two bytes beyond maxlen.
      bool stopped = false;
      if (maxlen > 16) {
        for (int k = 0; k < 16 && !stopped; ++k) {
          len++;
          stopped = ref[len] != ip[len];
        }
      }
      if (!stopped) {
        do len++;
        while (len < maxlen && ref[len] == ip[len]);
      }
      len -= 2;  // len is now #octets - 1
      ip++;
      if (len < 7) {
        *op++ = uint8_t((off >> 8) + (len << 5));
      } else {
        *op++ = uint8_t((off >> 8) + (7 << 5));
        *op++ = uint8_t(len - 7);
      }
      *op++ = uint8_t(off);
      lit = 0;
      op++;  // start run
      ip += len + 1;
      if (ip >= in_end - 2) break;
      --ip;
      hval = (unsigned(ip[0]) << 8) | ip[1];
      hval = (hval << 8) | ip[2];
      htab[idx(hval)] = uint32_t(ip - in) + 1;
      ip++;
    } else {
      if (op >= out_end) return 0;
      lit++;
      *op++ = *ip++;
      if (unsigned(lit) == kMaxLit) {
        op[-lit - 1] = uint8_t(lit - 1);  // stop run
        lit = 0;
        op++;  // start run
      }
    }
  }
  if (op + 3 > out_end) return 0;  // at most 3 bytes can be missing here
  while (ip < in_end) {
    lit++;
    *op++ = *ip++;
    if (unsigned(lit) == kMaxLit) {
      op[-lit - 1] = uint8_t(lit - 1);
      lit = 0;
      op++;
    }
  }
  op[-lit - 1] = uint8_t(lit - 1);  // end run
  op -= !lit;                       // undo run if length is zero
  return long(op - out);
}

// Decompress in[0, in_len) into out[0, out_len).  Returns the decompressed
// length, or -1 for a stream that is malformed or does not fit.
long lzf_decode(const uint8_t* in, long in_len, uint8_t* out, long out_len) {
  const uint8_t* ip = in;
  const uint8_t* in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* out_end = out + out_len;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < (1u << 5)) {
      ctrl++;
      if (op + ctrl > out_end || ip + ctrl > in_end) return -1;
      std::memcpy(op, ip, ctrl);
      op += ctrl;
      ip += ctrl;
    } else {
      unsigned len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -1;
        len += *ip++;
      }
      if (ip >= in_end) return -1;
      const uint8_t* ref = op - ((ctrl & 0x1f) << 8) - 1 - *ip++;
      len += 2;
      if (op + len > out_end || ref < out) return -1;
      for (unsigned i = 0; i < len; ++i) op[i] = ref[i];  // may overlap
      op += len;
    }
  }
  return long(op - out);
}

}  // extern "C"
