// RNS fast base conversion for Hopper (sm_90a): the key switch's ModUp and
// ModDown.
//
//   out[b, j, r, :] = (sum_{a in digit j} xhat[b, a, :] * conv[a, r]) mod p_r
//
// Digit j is the source rows [j * alpha, min((j + 1) * alpha, L)) of the
// int32 [K, L, n] input; `conv` is int64 [L, R], the target primes int64
// [R].  With a pre-scale (w, q: int64 [L]) each source residue first
// becomes xhat = x * w_a mod q_a, the digit's plain residue of a Montgomery
// coefficient; without one xhat is the input.  The output is int32 [K,
// ndig, R, n], canonical.  With `keep_own` (ModUp, whose first L target
// primes are the source primes) digit j's own target rows [j * alpha,
// j * alpha + m) are not converted: they take the digit's input rows as
// they came, before any pre-scale.
//
// It replaces no TPU kernel.  The JAX package's _k_decompose and _k_moddown
// (sorting_fhe_tpu/core/ckks.py) are jnp that XLA fuses.  The port ran the
// same sum as one multiply, one remainder and one add over a whole [R, n]
// int64 tensor per source prime, writing every partial product to device
// memory and reading it back: in the benchmark's profiler traces those
// three kernels took 78-81% of the card's busy time.
//
// What bounds it on the H100.  Each output residue takes m multiply-adds of
// two 31-bit residues (m the digit width, 24-39 on the registry's chains);
// each input residue is read once and each output residue written once, as
// int32.  At the main path's top-level ModUp ([95, 2^17] in, [4, 119, 2^17]
// out, digits of 24, each digit's own 24 rows copied): 1.19 G multiply-adds
// of two IMADs each (the third instruction, the carry add, issues on the
// other integer pipe), 0.14 ms at 132 SMs x 64 IMADs a clock x 1.98 GHz,
// against 300 MB, 0.09 ms at 3.35 TB/s.  The multiplier bounds it.
//
// Design.  A thread owns COLS consecutive columns (16- or 8-byte loads and
// stores along n) of one (poly, digit) and keeps the digit's residues of
// those columns in registers: M of them, M a compile-time bucket >= m whose
// rows past m are zero.  The block's rows of `conv` (as [R][M], zero past
// m), the target primes and their reduction constants sit in shared memory.
// The thread walks the R target rows; for each it sums its m products per
// column in a 96-bit accumulator (mad.lo.cc, madc.hi.cc, addc: three
// instructions a term, no reduction in the loop) and reduces once: the
// three words fold to a 64-bit value with 2^32 mod p and 2^64 mod p, and
// one Barrett step (mu = floor(2^64 / p), made per block) leaves the
// canonical residue.  The exact sum mod p does not depend on the order of
// its terms, so the output equals the plain loop's bit for bit.
//
// Interface: plain C, one launch on the caller's stream, no allocation, no
// synchronisation; returns the launch's cudaError_t (0 = success), which
// the Python wrapper (core/cuda_basis.py) raises on.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 40;            // the widest digit the buckets take
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

// Shared-memory bytes of a block: conv [R][M], mu [R] and [M], then p,
// 2^32 mod p and 2^64 mod p [R] and the pre-scale's q and w [M].
size_t smem_bytes(int M, int R) {
  return sizeof(uint32_t) * ((size_t)R * M + 3 * (size_t)R + 2 * (size_t)M) +
         sizeof(uint64_t) * ((size_t)R + M);
}

// t mod p for t < 2^64, p < 2^31, mu = floor(2^64 / p): the quotient
// estimate is at most one short, so t - q p < 2p < 2^32.
__device__ __forceinline__ uint32_t barrett(uint64_t t, uint32_t p,
                                            uint64_t mu) {
  const uint64_t q = __umul64hi(t, mu);
  const uint32_t r = (uint32_t)(t - q * p);
  return min(r, r - p);
}

// (hi:mid:lo) += a * b, a 96-bit sum of 64-bit products.
__device__ __forceinline__ void mac(uint32_t& lo, uint32_t& mid,
                                    uint32_t& hi, uint32_t a, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(lo), "+r"(mid), "+r"(hi)
      : "r"(a), "r"(b));
}

template <int COLS>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&v)[COLS]) {
  if constexpr (COLS == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
}

template <int COLS>
__device__ __forceinline__ void store(uint32_t* p,
                                      const uint32_t (&v)[COLS]) {
  if constexpr (COLS == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
}

// Grid: (column tiles of kThreads * COLS, digits, polys).
template <int M, int COLS>
__global__ void __launch_bounds__(kThreads)
base_conv(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
          const int64_t* __restrict__ conv, const int64_t* __restrict__ primes,
          const int64_t* __restrict__ w, const int64_t* __restrict__ src,
          int L, int alpha, int R, int n, bool keep_own) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cs = smem;                                     // [R][M]
  uint64_t* mu = reinterpret_cast<uint64_t*>(cs + R * M);  // [R]
  uint64_t* smu = mu + R;                                  // [M]
  uint32_t* pr = reinterpret_cast<uint32_t*>(smu + M);     // [R]
  uint32_t* f32 = pr + R;                                  // [R]
  uint32_t* f64 = f32 + R;                                 // [R]
  uint32_t* sq = f64 + R;                                  // [M]
  uint32_t* sw = sq + M;                                   // [M]

  const int j = blockIdx.y, b = blockIdx.z;
  const int lo = j * alpha;
  const int m = min(alpha, L - lo);
  for (int i = threadIdx.x; i < M * R; i += kThreads) {
    const int a = i / R, r = i - a * R;   // r fastest: coalesced reads
    cs[r * M + a] = a < m ? (uint32_t)conv[(size_t)(lo + a) * R + r] : 0u;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const uint32_t p = (uint32_t)primes[r];
    const uint32_t f = (uint32_t)((1ull << 32) % p);
    pr[r] = p;
    mu[r] = ~0ull / p;
    f32[r] = f;
    f64[r] = (uint32_t)((uint64_t)f * f % p);
  }
  if (w != nullptr)
    for (int a = threadIdx.x; a < m; a += kThreads) {
      const uint32_t q = (uint32_t)src[lo + a];
      sq[a] = q;
      sw[a] = (uint32_t)w[lo + a];
      smu[a] = ~0ull / q;
    }
  __syncthreads();

  const int col = (blockIdx.x * kThreads + threadIdx.x) * COLS;
  if (col >= n) return;
  uint32_t xs[M][COLS];
  const uint32_t* xb = x + ((size_t)b * L + lo) * n + col;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    if (a < m) {
      load<COLS>(xb + (size_t)a * n, xs[a]);
      if (w != nullptr) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          xs[a][c] = barrett((uint64_t)xs[a][c] * sw[a], sq[a], smu[a]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) xs[a][c] = 0u;
    }
  }

  uint32_t* ob = out + (size_t)(b * gridDim.y + j) * R * n + col;
  for (int r = 0; r < R; ++r) {
    if (keep_own && r >= lo && r < lo + m) continue;   // copied below
    uint32_t s0[COLS], s1[COLS], s2[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) s0[c] = s1[c] = s2[c] = 0u;
    const uint4* c4 = reinterpret_cast<const uint4*>(cs + r * M);
#pragma unroll
    for (int a = 0; a < M; a += 4) {
      const uint4 k = c4[a / 4];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        mac(s0[c], s1[c], s2[c], xs[a][c], k.x);
        mac(s0[c], s1[c], s2[c], xs[a + 1][c], k.y);
        mac(s0[c], s1[c], s2[c], xs[a + 2][c], k.z);
        mac(s0[c], s1[c], s2[c], xs[a + 3][c], k.w);
      }
    }
    // s < M 2^62 <= 2^68, so s2 < 16: the fold stays below 2^64
    const uint32_t p = pr[r], g32 = f32[r], g64 = f64[r];
    const uint64_t u = mu[r];
    uint32_t res[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      res[c] = barrett((uint64_t)s1[c] * g32 + (uint64_t)s2[c] * g64 + s0[c],
                       p, u);
    store<COLS>(ob + (size_t)r * n, res);
  }
  if (keep_own)   // the digit's own rows: its input again, from the cache
    for (int a = 0; a < m; ++a) {
      uint32_t v[COLS];
      load<COLS>(xb + (size_t)a * n, v);
      store<COLS>(ob + (size_t)(lo + a) * n, v);
    }
}

template <int M>
int launch(const uint32_t* x, uint32_t* out, const int64_t* conv,
           const int64_t* primes, const int64_t* w, const int64_t* src, int K,
           int L, int alpha, int R, int n, bool keep_own,
           cudaStream_t st) {
  constexpr int COLS = M <= 24 ? 4 : 2;   // registers: M x COLS residues
  const size_t smem = smem_bytes(M, R);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        base_conv<M, COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int per_block = kThreads * COLS;
  const dim3 grid((n + per_block - 1) / per_block, (L + alpha - 1) / alpha,
                  K);
  base_conv<M, COLS><<<grid, kThreads, smem, st>>>(x, out, conv, primes, w,
                                                    src, L, alpha, R, n,
                                                    keep_own);
  return (int)cudaGetLastError();
}

}  // namespace

// out[K, ceil(L / alpha), R, n] = the base conversion of x[K, L, n] (see
// the top of this file); w and src both null (no pre-scale) or both [L];
// keep_own 0 or 1, and 1 only where R >= L.
extern "C" int base_conv_launch(const void* x, void* out, const void* conv,
                                const void* primes, const void* w,
                                const void* src, int K, int L, int alpha,
                                int R, int n, int keep_own, void* stream) {
  if (K < 1 || K > 65535 || L < 1 || alpha < 1 || R < 1 || n < 4 || n % 4 ||
      (L + alpha - 1) / alpha > 65535 || (w == nullptr) != (src == nullptr) ||
      (keep_own != 0 && keep_own != 1) || (keep_own && R < L))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const int m = alpha < L ? alpha : L;
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int64_t* c = static_cast<const int64_t*>(conv);
  const int64_t* p = static_cast<const int64_t*>(primes);
  const int64_t* wi = static_cast<const int64_t*>(w);
  const int64_t* s = static_cast<const int64_t*>(src);
  const bool k = keep_own != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 8) return launch<8>(xi, o, c, p, wi, s, K, L, alpha, R, n, k, st);
  if (m <= 16)
    return launch<16>(xi, o, c, p, wi, s, K, L, alpha, R, n, k, st);
  if (m <= 24)
    return launch<24>(xi, o, c, p, wi, s, K, L, alpha, R, n, k, st);
  if (m <= 32)
    return launch<32>(xi, o, c, p, wi, s, K, L, alpha, R, n, k, st);
  if (m <= kMaxM)
    return launch<kMaxM>(xi, o, c, p, wi, s, K, L, alpha, R, n, k, st);
  return (int)cudaErrorInvalidValue;
}
