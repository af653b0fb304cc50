// Fused murmur3 row hash -> partition id, one thread per row.
//
// Replaces the TPU kernel cylon_tpu/ops/hash_pallas.py (`_kernel`, launched
// by `_call`, entry `partition_ids_fused`): for every row, each key column's
// value is split into little-endian 32-bit words (4-byte-or-narrower types
// give one word, 8-byte types two, low word first), mixed with
// MurmurHash3_x86_32, finalized with `^ 4*nwords`, zeroed when the row is
// null in that column, and combined across columns as `h = 31*h + col_hash`;
// the output is `h % nparts` as int32.  The plain PyTorch version of the
// same function is cylon_tpu_torch/ops/hash.py; the wrapper is
// cylon_tpu_torch/ops/hash_cuda.py.  A launch takes at most
// CYLON_MAX_KEY_COLS columns (the kernel argument holds them by value);
// the wrapper hashes more columns in groups through the chained entry,
// which carries the running hash from one group to the next.
//
// Words are formed as ops/hash.py `_to_u32_words` does: integers of 4 bytes
// or fewer are sign- or zero-extended as astype(int32) would (bool -> 0/1,
// uint32 keeps its bits); floats of 4 bytes or fewer are converted to
// float32 (exactly, NaN payloads kept) and their bits taken.
//
// Bound on an H100 SXM: the pass is elementwise integer work with no reuse,
// so it is bound by bytes.  Each row reads its key bytes (plus one validity
// byte per nullable column) and writes 4 bytes.  At 16,777,216 rows of one
// int32 key that is 128 MiB, about 40 us at 3.35 TB/s.  The design does the
// one thing that matters for that bound: a single pass that reads every key
// column once and writes the ids once, with the hash chain kept in
// registers (the TPU kernel's reason to exist, too).  Vectorized loads and
// other speed work are left to a later change.
//
// Build (plain C interface, loaded with ctypes; no PyTorch headers):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libpartition_hash.so partition_hash.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define CYLON_MAX_KEY_COLS 16

// dtype codes; must match _DTYPE_CODE in ops/hash_cuda.py
enum : int32_t {
  DT_BOOL = 0, DT_I8 = 1, DT_U8 = 2, DT_I16 = 3, DT_U16 = 4, DT_I32 = 5,
  DT_U32 = 6, DT_I64 = 7, DT_U64 = 8, DT_F16 = 9, DT_F32 = 10, DT_F64 = 11,
};

struct KeyCol {
  const void* data;
  const uint8_t* valid;  // bool bytes, or nullptr when the column has no nulls
  int32_t dtype;
};

struct KeyCols {
  KeyCol c[CYLON_MAX_KEY_COLS];
  int32_t k;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix_block(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

// IEEE binary16 bits -> binary32 bits, exact for every input (subnormals
// normalized, inf kept, NaN payload shifted into place) -- the conversion
// numpy and XLA perform for astype(float32).
__device__ __forceinline__ uint32_t half_bits_to_float_bits(uint16_t hb) {
  uint32_t sign = (uint32_t)(hb & 0x8000u) << 16;
  uint32_t exp = (hb >> 10) & 0x1Fu;
  uint32_t man = hb & 0x3FFu;
  if (exp == 0x1Fu) return sign | 0x7F800000u | (man << 13);
  if (exp != 0) return sign | ((exp + 112u) << 23) | (man << 13);
  if (man == 0) return sign;
  // subnormal half: shift the mantissa up until its leading bit is the
  // implicit one
  int e = -1;
  do {
    man <<= 1;
    ++e;
  } while ((man & 0x400u) == 0);
  return sign | ((uint32_t)(112 - e) << 23) | ((man & 0x3FFu) << 13);
}

__device__ __forceinline__ uint32_t column_hash(const KeyCol& col, int64_t i) {
  uint32_t h = 0;
  uint32_t nwords = 1;
  switch (col.dtype) {
    case DT_BOOL:
      h = mix_block(h, static_cast<const uint8_t*>(col.data)[i] != 0);
      break;
    case DT_I8:
      h = mix_block(h, (uint32_t)(int32_t)static_cast<const int8_t*>(col.data)[i]);
      break;
    case DT_U8:
      h = mix_block(h, (uint32_t)static_cast<const uint8_t*>(col.data)[i]);
      break;
    case DT_I16:
      h = mix_block(h, (uint32_t)(int32_t)static_cast<const int16_t*>(col.data)[i]);
      break;
    case DT_U16:
      h = mix_block(h, (uint32_t)static_cast<const uint16_t*>(col.data)[i]);
      break;
    case DT_I32:
    case DT_U32:
    case DT_F32:
      h = mix_block(h, static_cast<const uint32_t*>(col.data)[i]);
      break;
    case DT_F16:
      h = mix_block(h, half_bits_to_float_bits(
                           static_cast<const uint16_t*>(col.data)[i]));
      break;
    default: {  // DT_I64, DT_U64, DT_F64: low word, then high word
      uint64_t v = static_cast<const uint64_t*>(col.data)[i];
      h = mix_block(h, (uint32_t)(v & 0xFFFFFFFFu));
      h = mix_block(h, (uint32_t)(v >> 32));
      nwords = 2;
    }
  }
  h = fmix32(h ^ (4u * nwords));
  if (col.valid != nullptr && col.valid[i] == 0) h = 0;
  return h;
}

__global__ void partition_hash_kernel(KeyCols cols, int64_t n,
                                      uint32_t nparts,
                                      const uint32_t* __restrict__ h_in,
                                      int finalize,
                                      int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t row_h = h_in != nullptr ? h_in[i] : 0u;
    for (int c = 0; c < cols.k; ++c) row_h = row_h * 31u + column_hash(cols.c[c], i);
    out[i] = finalize ? (int32_t)(row_h % nparts) : (int32_t)row_h;
  }
}

static int launch(const void* const* data, const void* const* valid,
                  const int32_t* dtypes, int32_t k, int64_t n, int32_t nparts,
                  const uint32_t* h_in, int finalize, int32_t* out,
                  void* stream) {
  if (k < 1 || k > CYLON_MAX_KEY_COLS || n <= 0 || nparts < 1)
    return (int)cudaErrorInvalidValue;
  KeyCols cols;
  cols.k = k;
  for (int c = 0; c < k; ++c) {
    cols.c[c].data = data[c];
    cols.c[c].valid = static_cast<const uint8_t*>(valid[c]);
    cols.c[c].dtype = dtypes[c];
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      sms = 132;
  }
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t max_blocks = (int64_t)sms * 16;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  partition_hash_kernel<<<(unsigned)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cols, n, (uint32_t)nparts, h_in, finalize, out);
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).  The caller has checked k <= CYLON_MAX_KEY_COLS, n > 0,
// nparts >= 1, and that every pointer is a device pointer to n contiguous
// elements of the stated dtype.
extern "C" int cylon_partition_hash(const void* const* data,
                                    const void* const* valid,
                                    const int32_t* dtypes, int32_t k,
                                    int64_t n, int32_t nparts, int32_t* out,
                                    void* stream) {
  return launch(data, valid, dtypes, k, n, nparts, nullptr, 1, out, stream);
}

// One group of a row hash over more than CYLON_MAX_KEY_COLS key columns.
// Each row starts from h_in[i] (the running hash of the groups before;
// nullptr for the first group) and folds this group's columns in with the
// same h = 31*h + col_hash.  With finalize == 0 it writes the raw uint32
// hash (bits in an int32) for the next group; with finalize != 0 it
// writes h % nparts.  h_in and out must not overlap (the wrapper
// alternates two buffers).  Groups launched in order on one stream give
// the single-pass kernel's ids bit for bit.
extern "C" int cylon_partition_hash_chained(const void* const* data,
                                            const void* const* valid,
                                            const int32_t* dtypes, int32_t k,
                                            int64_t n, int32_t nparts,
                                            const uint32_t* h_in,
                                            int32_t finalize, int32_t* out,
                                            void* stream) {
  return launch(data, valid, dtypes, k, n, nparts, h_in, finalize, out,
                stream);
}
