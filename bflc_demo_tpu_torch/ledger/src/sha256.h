// Minimal SHA-256 (FIPS 180-4) for the ledger's hash chain.
// Fresh implementation of the public standard; no external dependencies so the
// ledger shared library is self-contained.
#pragma once

#include <cstddef>
#include <cstdint>
#include <array>

namespace bflc {

using Digest = std::array<uint8_t, 32>;

class Sha256 {
 public:
  Sha256();
  void update(const void* data, size_t len);
  Digest finish();
  static Digest hash(const void* data, size_t len);

 private:
  void process_block(const uint8_t* block);
  uint32_t state_[8];
  uint64_t bitlen_;
  uint8_t buf_[64];
  size_t buflen_;
};

}  // namespace bflc
