// The key switch's second half for Hopper (sm_90a): the inner product of
// the hoisted digits with the key-switching key, and ModDown's tail.
//
// ks_inner:
//   acc[c, r, :] = (sum_j e_j[r, perm(:)] * key[j, c, kr(r), :]) * 2^-32
//                  mod p_r
// over the E ext rows r of a level (lq q rows, then E - lq special rows),
// the key's two components c and the ndig digits j.  The digits are int32
// [ndig, E, n]; the key is int32 [>= ndig, 2, KR, n] as the context keeps
// it, and ext row r reads its row kr(r) = r for a q row, kq + (r - lq) for
// a special one, so its rows are never copied out.  `perm` (int64 [n], or
// null) is the Galois automorphism the digits are read through (rotations
// and conjugation).  The q rows go to out_q [2, lq, n] and the special
// rows to out_sp [2, E - lq, n], each contiguous: K2 reads out_sp as it
// is, the tail reads out_q.
//
// moddown_tail:
//   out[b, r, :] = (a[b, r, :] - c[b, r, :]) * pinv_r mod p_r
// over int32 [K, l, n]: the inner product's q rows less the forward NTT of
// ModDown's base conversion, times P^-1 mod q_r.  `a` may be the first l
// rows of a [K, la, n] tensor (la >= l), read in place: the composite
// rescale (csrc/rescale.cu) passes a ciphertext's kept rows and its lift,
// with pinv the dropped primes' product inverted.
//
// They replace no TPU kernel.  The JAX package's _k_ks_inner and
// _k_moddown (sorting_fhe_tpu/core/ckks.py) are jnp that XLA fuses.  The
// port ran them as int64 torch ops: per digit a torch.cat of the key's
// rows, a cast, a product, a remainder and an add over [2, E, n] int64,
// three more passes over the sum, an index_select copy of the digits for
// an automorphism, and for the tail a subtraction (four launches), a
// product and a remainder over [2, l, n] int64.  In the benchmark's
// traces those int64 element-wise kernels led every cell.
//
// What bounds them on the H100: bytes.  ks_inner reads each digit residue
// once (4 B) and each digit's two key residues once (8 B), and writes two
// int32 per ext column: at the main path's top level (4 digits, 119 ext
// rows, n = 2^17) 0.25 + 0.50 + 0.12 GB, 0.26 ms at 3.35 TB/s.  A digit
// costs a thread two 96-bit multiply-adds per column (six instructions)
// and the reduction about 40 per output, a few instructions per byte
// against the card's ten.  moddown_tail reads 8 B and writes 4 B an
// output residue with one Barrett reduction.
//
// Design.  A thread owns kCols = 4 consecutive columns of one ext row and
// both key components: 16-byte loads of the digit and of the two key
// rows, 16-byte stores.  The grid is (column tiles, rows), so the blocks
// of one row run together and the row's digits stay in the 50 MB L2.  The
// thread sums each digit's two products per column in registers in a
// 96-bit accumulator (mad.lo.cc, madc.hi.cc, addc, as csrc/basis.cu), with
// no reduction in the digit loop, then folds the three words with 2^32 and
// 2^64 mod p, takes one Barrett step (mu = floor(2^64 / p), made by each
// thread) and a second for the factor 2^-32.  The exact sum mod p does not
// depend on the order of its terms, so the output equals the plain
// version's bit for bit.  The automorphism maps each aligned group of four
// columns onto an aligned group of four (in the bit-reversed evaluation
// order a group is the coset of the subgroup of order 4 that g's powers
// keep), so a thread reads its digit columns with one 16-byte load and
// picks the lanes; a permutation without that property takes scalar loads.
// moddown_tail: the same thread layout over [K, l, n].
//
// Interface: plain C, one launch on the caller's stream, no allocation, no
// synchronisation; returns the launch's cudaError_t (0 = success), which
// the Python wrapper (core/cuda_keyswitch.py) raises on.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;
constexpr int kTile = kThreads * kCols;   // columns of a block

// t mod p for t < 2^64 - 2^64 / p, p < 2^31, mu = floor((2^64 - 1) / p):
// the quotient estimate is at most one short, so t - q p < 2p < 2^32.
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

__device__ __forceinline__ void load4(const uint32_t* p, uint32_t (&v)[4]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void store4(uint32_t* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4],
                                         uint32_t i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Grid: (column tiles, ext rows).
template <bool kPerm>
__global__ void __launch_bounds__(kThreads)
ks_inner(const uint32_t* __restrict__ ext, const uint32_t* __restrict__ key,
         const int64_t* __restrict__ primes, const int64_t* __restrict__ rinv,
         const int64_t* __restrict__ perm, uint32_t* __restrict__ out_q,
         uint32_t* __restrict__ out_sp, int ndig, int E, int lq, int kq,
         int KR, int n) {
  const int r = blockIdx.y;
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= n) return;
  const uint32_t p = (uint32_t)primes[r];
  const uint64_t mu = ~0ull / p;
  const uint32_t f32 = barrett(1ull << 32, p, mu);
  const uint32_t f64 = barrett((uint64_t)f32 * f32, p, mu);
  const uint32_t ri = (uint32_t)rinv[r];

  // the digit columns this thread reads: [src, src + 4) picked by sel,
  // or, for a permutation that splits the group, one column each
  int src = col;
  uint32_t sel[kCols] = {0u, 1u, 2u, 3u};
  int64_t pc[kCols] = {col, col + 1, col + 2, col + 3};
  bool grouped = true;
  if (kPerm) {
    const longlong2* pp = reinterpret_cast<const longlong2*>(perm + col);
    const longlong2 p01 = __ldg(pp), p23 = __ldg(pp + 1);
    pc[0] = p01.x & (n - 1);   // n is a power of two: reads stay in the row
    pc[1] = p01.y & (n - 1);
    pc[2] = p23.x & (n - 1);
    pc[3] = p23.y & (n - 1);
    src = (int)(pc[0] & ~3ll);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      sel[c] = (uint32_t)(pc[c] & 3);
      grouped = grouped && (pc[c] & ~3ll) == src;
    }
  }

  uint32_t a0[kCols], a1[kCols], a2[kCols];   // component 0
  uint32_t b0[kCols], b1[kCols], b2[kCols];   // component 1
#pragma unroll
  for (int c = 0; c < kCols; ++c) a0[c] = a1[c] = a2[c] = b0[c] = b1[c] =
      b2[c] = 0u;
  const uint32_t* e = ext + (size_t)r * n;
  const int kr = r < lq ? r : kq + (r - lq);
  const uint32_t* k = key + (size_t)kr * n + col;
  const size_t e_step = (size_t)E * n, k_comp = (size_t)KR * n,
               k_step = 2 * k_comp;
#pragma unroll 2
  for (int j = 0; j < ndig; ++j) {
    uint32_t v[kCols], k0[kCols], k1[kCols];
    if (!kPerm) {
      load4(e + col, v);
    } else if (grouped) {
      uint32_t t[kCols];
      load4(e + src, t);
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = pick(t, sel[c]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = __ldg(e + pc[c]);
    }
    load4(k, k0);
    load4(k + k_comp, k1);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      mac(a0[c], a1[c], a2[c], v[c], k0[c]);
      mac(b0[c], b1[c], b2[c], v[c], k1[c]);
    }
    e += e_step;
    k += k_step;
  }

  // a sum of ndig terms below 2^62 each: the top word is below ndig / 4, so
  // the fold stays below 2^63 + ndig 2^29 + 2^32
  uint32_t ra[kCols], rb[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const uint32_t sa = barrett(
        (uint64_t)a1[c] * f32 + (uint64_t)a2[c] * f64 + a0[c], p, mu);
    const uint32_t sb = barrett(
        (uint64_t)b1[c] * f32 + (uint64_t)b2[c] * f64 + b0[c], p, mu);
    ra[c] = barrett((uint64_t)sa * ri, p, mu);
    rb[c] = barrett((uint64_t)sb * ri, p, mu);
  }
  const int ks = E - lq;
  uint32_t* o0 = r < lq ? out_q + (size_t)r * n
                        : out_sp + (size_t)(r - lq) * n;
  const size_t o_comp = (size_t)(r < lq ? lq : ks) * n;
  store4(o0 + col, ra);
  store4(o0 + o_comp + col, rb);
}

// Grid: (column tiles, rows, polys).
__global__ void __launch_bounds__(kThreads)
moddown_tail(const uint32_t* __restrict__ a, const uint32_t* __restrict__ c,
             const int64_t* __restrict__ primes,
             const int64_t* __restrict__ pinv, uint32_t* __restrict__ out,
             int l, int la, int n) {
  const int r = blockIdx.y, b = blockIdx.z;
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= n) return;
  const uint32_t p = (uint32_t)primes[r];
  const uint64_t mu = ~0ull / p;
  const uint32_t w = (uint32_t)pinv[r];
  const size_t off = ((size_t)b * l + r) * n + col;
  uint32_t x[kCols], y[kCols], o[kCols];
  load4(a + ((size_t)b * la + r) * n + col, x);
  load4(c + off, y);
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const uint32_t d = x[i] >= y[i] ? x[i] - y[i] : x[i] + (p - y[i]);
    o[i] = barrett((uint64_t)d * w, p, mu);
  }
  store4(out + off, o);
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// out_q[2, lq, n], out_sp[2, E - lq, n] = the inner product of ext[ndig,
// E, n] with key[>= ndig, 2, KR, n] (see the top of this file); perm null
// or int64 [n]; n a power of two, at least 4.
extern "C" int ks_inner_launch(const void* ext, const void* key,
                               const void* primes, const void* rinv,
                               const void* perm, void* out_q, void* out_sp,
                               int ndig, int E, int lq, int kq, int KR, int n,
                               void* stream) {
  if (ndig < 1 || E < 1 || E > 65535 || lq < 0 || lq > E || kq < lq ||
      kq + (E - lq) > KR || n < kCols || (n & (n - 1)))
    return (int)cudaErrorInvalidValue;
  if (!aligned(ext) || !aligned(key) || (lq && !aligned(out_q)) ||
      (lq < E && !aligned(out_sp)) || (perm != nullptr && !aligned(perm)))
    return (int)cudaErrorInvalidValue;
  const uint32_t* e = static_cast<const uint32_t*>(ext);
  const uint32_t* k = static_cast<const uint32_t*>(key);
  const int64_t* p = static_cast<const int64_t*>(primes);
  const int64_t* ri = static_cast<const int64_t*>(rinv);
  const int64_t* pm = static_cast<const int64_t*>(perm);
  uint32_t* oq = static_cast<uint32_t*>(out_q);
  uint32_t* os = static_cast<uint32_t*>(out_sp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTile - 1) / kTile, E);
  if (pm != nullptr)
    ks_inner<true><<<grid, kThreads, 0, st>>>(e, k, p, ri, pm, oq, os, ndig,
                                              E, lq, kq, KR, n);
  else
    ks_inner<false><<<grid, kThreads, 0, st>>>(e, k, p, ri, pm, oq, os, ndig,
                                               E, lq, kq, KR, n);
  return (int)cudaGetLastError();
}

// out[K, l, n] = (a - c) * pinv mod p, row by row (see the top of this
// file), a's rows la apart per poly (la >= l); n a multiple of 4.
extern "C" int moddown_tail_launch(const void* a, const void* c,
                                   const void* primes, const void* pinv,
                                   void* out, int K, int l, int la, int n,
                                   void* stream) {
  if (K < 1 || K > 65535 || l < 1 || l > 65535 || la < l || n < kCols ||
      n % kCols)
    return (int)cudaErrorInvalidValue;
  if (!aligned(a) || !aligned(c) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  const uint32_t* x = static_cast<const uint32_t*>(a);
  const uint32_t* y = static_cast<const uint32_t*>(c);
  const int64_t* p = static_cast<const int64_t*>(primes);
  const int64_t* w = static_cast<const int64_t*>(pinv);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTile - 1) / kTile, l, K);
  moddown_tail<<<grid, kThreads, 0, st>>>(x, y, p, w, o, l, la, n);
  return (int)cudaGetLastError();
}
