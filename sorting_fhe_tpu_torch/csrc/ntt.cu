// Negacyclic NTT kernels for Hopper (sm_90a): K1 forward, K2 inverse.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  sorting_fhe_tpu/core/pallas_ntt.py:_fwd_kernel (via ntt_fwd_pallas)
//   K2  sorting_fhe_tpu/core/pallas_ntt.py:_inv_kernel (via ntt_inv_pallas)
// and computes the same thing bit for bit: forward Cooley-Tukey DIT with psi
// merged into the twiddles (natural in, bit-reversed out), inverse
// Gentleman-Sande (bit-reversed in, natural out) with n^-1 fused as a final
// Shoup multiply, Shoup butterflies on canonical residues mod p < 2^31.
// Each limb of the [..., L, n] input picks its prime and twiddle row from
// `rows[limb % L]`, so any subset of the chain (q prefix, ext basis, special
// primes, one dynamic row) runs without slicing the [LP, n] tables.
//
// What bounds it on the H100: memory.  A butterfly is a few integer ops per
// 8 bytes moved, and a 2^17 limb is 512 KB, above the 227 KB of shared
// memory a block can hold, so the limb cannot stay on-chip for all 17
// stages the way the Pallas kernel keeps it in VMEM.  Done naively, each
// stage is one pass over L*n*4 bytes in device memory (17 passes).
//
// Design: the stages whose butterfly span 2t fits a chunk of C = 2^11
// residues (8 KB) are closed within the chunk, so they run together in one
// shared-memory pass ("tail" of the forward, "head" of the inverse).  The
// remaining log2(n) - 11 stages (6 at n = 2^17) run as radix-2 passes in
// device memory, one thread per butterfly, in place.  That is 7 passes over
// the data instead of 17.  Merging the wide stages too (a second
// shared-memory pass over strided columns) is the next step.
//
// Interface: plain C, launched on the caller's stream, no allocation, no
// synchronisation.  Each entry point returns the cudaError_t of its launches
// (0 = success); the Python wrapper raises on anything else.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogChunk = 11;       // shared-memory chunk: 2^11 residues
constexpr int kChunkThreads = 512;  // threads per chunk block
constexpr int kStageThreads = 256;  // threads per block of a global stage

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  uint32_t s = a + p - b;
  return s >= p ? s - p : s;
}

// x * w mod p with w_sh = floor(w * 2^32 / p), valid for any x < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
  uint32_t q = __umulhi(x, w_sh);
  uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ int load_row(const int32_t* rows, int L, int LP,
                                        long long limb) {
  int row = rows[limb % L];
  if (row < 0 || row >= LP) __trap();  // surfaces as a CUDA error
  return row;
}

// One forward radix-2 stage s in device memory: m = 2^s groups of span
// 2t, t = n >> (s+1); twiddle of group g is tw[row][m + g].
__global__ void fwd_stage(const uint32_t* in, uint32_t* out,
                          const int32_t* rows, const uint32_t* primes,
                          const uint32_t* tw, const uint32_t* tw_sh, int L,
                          int LP, long long limbs, int logn, int s) {
  const int logh = logn - 1;
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= (limbs << logh)) return;
  const long long limb = k >> logh;
  const uint32_t b = (uint32_t)(k & ((1ll << logh) - 1));
  const int logt = logn - 1 - s;
  const uint32_t g = b >> logt;
  const uint32_t i = (g << (logt + 1)) | (b & ((1u << logt) - 1));
  const uint32_t j = i + (1u << logt);
  const int row = load_row(rows, L, LP, limb);
  const uint32_t p = primes[row];
  const size_t ti = ((size_t)row << logn) + (1u << s) + g;
  const size_t base = (size_t)limb << logn;
  const uint32_t u = in[base + i];
  const uint32_t v = shoup_mul(in[base + j], tw[ti], tw_sh[ti], p);
  out[base + i] = add_mod(u, v, p);
  out[base + j] = sub_mod(u, v, p);
}

// One inverse radix-2 stage s in device memory: h = n >> (s+1) groups of
// span 2t, t = 2^s; twiddle of group g is tw[row][h + g].  On the last
// stage both outputs also take the n^-1 factor.
__global__ void inv_stage(const uint32_t* in, uint32_t* out,
                          const int32_t* rows, const uint32_t* primes,
                          const uint32_t* tw, const uint32_t* tw_sh,
                          const uint32_t* ninv, const uint32_t* ninv_sh,
                          int L, int LP, long long limbs, int logn, int s) {
  const int logh = logn - 1;
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= (limbs << logh)) return;
  const long long limb = k >> logh;
  const uint32_t b = (uint32_t)(k & ((1ll << logh) - 1));
  const uint32_t g = b >> s;
  const uint32_t i = (g << (s + 1)) | (b & ((1u << s) - 1));
  const uint32_t j = i + (1u << s);
  const int row = load_row(rows, L, LP, limb);
  const uint32_t p = primes[row];
  const size_t ti = ((size_t)row << logn) + (1u << (logn - 1 - s)) + g;
  const size_t base = (size_t)limb << logn;
  const uint32_t u = in[base + i];
  const uint32_t v = in[base + j];
  uint32_t lo = add_mod(u, v, p);
  uint32_t hi = shoup_mul(sub_mod(u, v, p), tw[ti], tw_sh[ti], p);
  if (s == logn - 1) {
    lo = shoup_mul(lo, ninv[row], ninv_sh[row], p);
    hi = shoup_mul(hi, ninv[row], ninv_sh[row], p);
  }
  out[base + i] = lo;
  out[base + j] = hi;
}

// The forward stages s = logn - logc .. logn - 1 (t <= C/2) of one chunk
// of C = 2^logc residues, in shared memory.
__global__ void fwd_tail(const uint32_t* in, uint32_t* out,
                         const int32_t* rows, const uint32_t* primes,
                         const uint32_t* tw, const uint32_t* tw_sh, int L,
                         int LP, int logn, int logc) {
  extern __shared__ uint32_t sh[];
  const uint32_t C = 1u << logc;
  const int logchunks = logn - logc;
  const long long limb = (long long)blockIdx.x >> logchunks;
  const uint32_t c = blockIdx.x & ((1u << logchunks) - 1);
  const int row = load_row(rows, L, LP, limb);
  const uint32_t p = primes[row];
  const size_t off = ((size_t)limb << logn) + ((size_t)c << logc);
  const uint32_t* twr = tw + ((size_t)row << logn);
  const uint32_t* twsr = tw_sh + ((size_t)row << logn);
  for (uint32_t e = threadIdx.x; e < C; e += blockDim.x) sh[e] = in[off + e];
  __syncthreads();
  for (int s = logn - logc; s < logn; ++s) {
    const int logt = logn - 1 - s;
    // global group index of this chunk's first group: c * C / (2t)
    const uint32_t g0 = c << (logc - 1 - logt);
    for (uint32_t b = threadIdx.x; b < C / 2; b += blockDim.x) {
      const uint32_t gl = b >> logt;
      const uint32_t i = (gl << (logt + 1)) | (b & ((1u << logt) - 1));
      const uint32_t j = i + (1u << logt);
      const uint32_t ti = (1u << s) + g0 + gl;
      const uint32_t u = sh[i];
      const uint32_t v = shoup_mul(sh[j], twr[ti], twsr[ti], p);
      sh[i] = add_mod(u, v, p);
      sh[j] = sub_mod(u, v, p);
    }
    __syncthreads();
  }
  for (uint32_t e = threadIdx.x; e < C; e += blockDim.x) out[off + e] = sh[e];
}

// The inverse stages s = 0 .. logc - 1 (t <= C/2) of one chunk, in shared
// memory; when the chunk is the whole limb, n^-1 is applied on the way out.
__global__ void inv_head(const uint32_t* in, uint32_t* out,
                         const int32_t* rows, const uint32_t* primes,
                         const uint32_t* tw, const uint32_t* tw_sh,
                         const uint32_t* ninv, const uint32_t* ninv_sh, int L,
                         int LP, int logn, int logc) {
  extern __shared__ uint32_t sh[];
  const uint32_t C = 1u << logc;
  const int logchunks = logn - logc;
  const long long limb = (long long)blockIdx.x >> logchunks;
  const uint32_t c = blockIdx.x & ((1u << logchunks) - 1);
  const int row = load_row(rows, L, LP, limb);
  const uint32_t p = primes[row];
  const size_t off = ((size_t)limb << logn) + ((size_t)c << logc);
  const uint32_t* twr = tw + ((size_t)row << logn);
  const uint32_t* twsr = tw_sh + ((size_t)row << logn);
  for (uint32_t e = threadIdx.x; e < C; e += blockDim.x) sh[e] = in[off + e];
  __syncthreads();
  for (int s = 0; s < logc; ++s) {
    const uint32_t h = 1u << (logn - 1 - s);
    const uint32_t g0 = c << (logc - 1 - s);
    for (uint32_t b = threadIdx.x; b < C / 2; b += blockDim.x) {
      const uint32_t gl = b >> s;
      const uint32_t i = (gl << (s + 1)) | (b & ((1u << s) - 1));
      const uint32_t j = i + (1u << s);
      const uint32_t ti = h + g0 + gl;
      const uint32_t u = sh[i];
      const uint32_t v = sh[j];
      sh[i] = add_mod(u, v, p);
      sh[j] = shoup_mul(sub_mod(u, v, p), twr[ti], twsr[ti], p);
    }
    __syncthreads();
  }
  if (logc == logn) {
    const uint32_t w = ninv[row], wsh = ninv_sh[row];
    for (uint32_t e = threadIdx.x; e < C; e += blockDim.x)
      out[off + e] = shoup_mul(sh[e], w, wsh, p);
  } else {
    for (uint32_t e = threadIdx.x; e < C; e += blockDim.x)
      out[off + e] = sh[e];
  }
}

inline unsigned int stage_blocks(long long limbs, int logn) {
  long long total = limbs << (logn - 1);
  return (unsigned int)((total + kStageThreads - 1) / kStageThreads);
}

}  // namespace

// K1: out[..., L, n] = forward NTT of in[..., L, n]; limbs = prod(lead) * L.
extern "C" int ntt_fwd_launch(const void* in, void* out, const void* rows,
                              const void* primes, const void* tw,
                              const void* tw_sh, int L, int LP,
                              long long limbs, int logn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const uint32_t* pr = static_cast<const uint32_t*>(primes);
  const uint32_t* w = static_cast<const uint32_t*>(tw);
  const uint32_t* ws = static_cast<const uint32_t*>(tw_sh);
  if (limbs <= 0 || logn < 1 || logn > 30) return (int)cudaErrorInvalidValue;
  const int logc = logn < kLogChunk ? logn : kLogChunk;
  for (int s = 0; s < logn - logc; ++s) {
    fwd_stage<<<stage_blocks(limbs, logn), kStageThreads, 0, st>>>(
        src, dst, r, pr, w, ws, L, LP, limbs, logn, s);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  const long long blocks = limbs << (logn - logc);
  fwd_tail<<<(unsigned int)blocks, kChunkThreads, sizeof(uint32_t) << logc,
             st>>>(src, dst, r, pr, w, ws, L, LP, logn, logc);
  return (int)cudaGetLastError();
}

// K2: out[..., L, n] = inverse NTT (with n^-1) of in[..., L, n].
extern "C" int ntt_inv_launch(const void* in, void* out, const void* rows,
                              const void* primes, const void* tw,
                              const void* tw_sh, const void* ninv,
                              const void* ninv_sh, int L, int LP,
                              long long limbs, int logn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const uint32_t* pr = static_cast<const uint32_t*>(primes);
  const uint32_t* w = static_cast<const uint32_t*>(tw);
  const uint32_t* ws = static_cast<const uint32_t*>(tw_sh);
  const uint32_t* ni = static_cast<const uint32_t*>(ninv);
  const uint32_t* nis = static_cast<const uint32_t*>(ninv_sh);
  if (limbs <= 0 || logn < 1 || logn > 30) return (int)cudaErrorInvalidValue;
  const int logc = logn < kLogChunk ? logn : kLogChunk;
  const long long blocks = limbs << (logn - logc);
  inv_head<<<(unsigned int)blocks, kChunkThreads, sizeof(uint32_t) << logc,
             st>>>(src, dst, r, pr, w, ws, ni, nis, L, LP, logn, logc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int s = logc; s < logn; ++s) {
    inv_stage<<<stage_blocks(limbs, logn), kStageThreads, 0, st>>>(
        dst, dst, r, pr, w, ws, ni, nis, L, LP, limbs, logn, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
