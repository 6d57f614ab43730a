// CRC32C (Castagnoli), slicing-by-8: the port's copy of the JAX package's
// native host CRC (native/bigdl_tpu_native.cc, btpu_crc32c), with the same
// tables and the same byte order, so both give the same value for the same
// bytes.  Exposed through a flat extern "C" ABI loaded with ctypes.
#include <cstdint>
#include <cstring>

namespace {

uint32_t kCrcTable[8][256];

bool init_crc() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    kCrcTable[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = kCrcTable[0][i];
    for (int t = 1; t < 8; ++t) {
      c = kCrcTable[0][c & 0xFF] ^ (c >> 8);
      kCrcTable[t][i] = c;
    }
  }
  return true;
}

const bool crc_inited = init_crc();

}  // namespace

extern "C" {

// The running crc32c of n bytes at data, continuing from crc (0 to start).
uint32_t bigdl_crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  crc ^= 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kCrcTable[7][lo & 0xFF] ^ kCrcTable[6][(lo >> 8) & 0xFF] ^
          kCrcTable[5][(lo >> 16) & 0xFF] ^ kCrcTable[4][lo >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = kCrcTable[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
