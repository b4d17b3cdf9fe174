// The composite rescale's lift for Hopper (sm_90a): the dropped rows'
// centred lifts, combined and written on every kept row.
//
//   out[b, r, :] = (sum_s a_s[b, :] * q_0 ... q_{s-1}) * R  mod p_r
//
// A composite rescale drops `comp` primes q_0 = q_{l-1}, q_1 = q_{l-2},
// ... in turn; step s subtracts the centred lift a_s of the row it drops
// and divides by q_s.  Every step is exact modular arithmetic, so the comp
// steps are one: (x - (a_0 + a_1 q_0 + ...)) (q_0 q_1 ...)^-1 mod p.  This
// kernel writes the combined lift in Montgomery form (R = 2^32) on every
// kept row; the caller forward-NTTs it (K1) and ModDown's tail
// (csrc/keyswitch.cu) subtracts it and multiplies by (q_0 q_1 ...)^-1.
//
// Input: int32 [K, comp, n], the dropped rows in the coefficient and
// Montgomery domain, in chain order (row j is chain row l - comp + j, so
// step s drops row comp - 1 - s).  `drop` is int64 [comp, 4 + 2 comp], per
// step s: q_s, q_s // 2, 2^-32 mod q_s and its Shoup companion, then for
// each step t, w = q_s^-1 mod q_t and its companion (read for t > s).
// `keep` is int64 [L, 1 + 3 comp], per kept row: p, then per step s
// c_s = q_0 ... q_{s-1} R mod p, its companion and e_s = q_s c_s mod p.
// Output: int32 [K, L, n], canonical.
//
// Per column: each dropped row becomes plain, u = x 2^-32 mod q.  Step s
// takes v = u of its row, big = v > q_s // 2 (the lift is v - q_s), and
// updates the rows still to drop, u_t <- (u_t - a_s) q_s^-1 mod q_t =
// u_t w - v w + big (q_s w = 1 mod q_t), as the mesh's rescale did in
// coefficient form.  On kept row p the lift is sum_s v_s c_s - big_s e_s
// mod p.  The arithmetic is 32-bit: Shoup products (x w - umulhi(x, w')
// p, then one conditional subtraction; any x < 2^32, p < 2^31), no
// division.  The output equals the int64 plain version (core/
// cuda_rescale.py rescale_lift_t) bit for bit: both are the canonical
// residue of the same integer.
//
// It replaces no TPU kernel.  The JAX package's _k_rescale
// (sorting_fhe_tpu/core/ckks.py) is jnp that XLA fuses, one step per
// dropped prime.  The port ran each step as int64 torch ops over [k, l, n]
// (a remainder, sub_mod and `where` to lift the row onto every kept row, a
// product and remainder into Montgomery form, casts, K1, sub_mod, a product
// and a remainder): about 20 kernels and 9 GB of traffic a step at the
// main path's top level.
//
// What bounds it on the H100: bytes.  It reads K comp rows and writes K L
// rows of int32; at l = 95 (K = 2, comp = 2, L = 93, n = 2^17) 97.5 MB
// written, 0.03 ms at 3.35 TB/s.  An output costs comp Shoup products
// (three IMADs each) and a few adds and selects: about 6 IMADs a residue
// against 16 bytes of store per four residues, inside the card's integer
// rate at that byte rate.
//
// Design.  A thread owns kCols = 4 consecutive columns of one poly: it
// reads its comp dropped values with 16-byte loads, computes the v and big
// of every step in registers, then walks kRows kept rows, writing each
// with one 16-byte store.  The grid is (column tiles, row chunks, polys):
// row chunks give the card several waves of blocks (at the top level 12
// chunks of 8 rows); each chunk reads the dropped rows again, 2 MB at the
// top level, from L2.  The block's rows of `keep` sit in shared memory.
//
// Interface: plain C, one launch on the caller's stream, no allocation, no
// synchronisation; returns the launch's cudaError_t (0 = success), which
// the Python wrapper (core/cuda_rescale.py) raises on.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;
constexpr int kTile = kThreads * kCols;   // columns of a block
constexpr int kRows = 8;                  // kept rows of a block
constexpr int kMaxComp = 4;

// x w mod p for x < 2^32, w < p < 2^31, w_sh = floor(w 2^32 / p).
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w,
                                          uint32_t w_sh, uint32_t p) {
  const uint32_t r = x * w - __umulhi(x, w_sh) * p;   // in [0, 2p)
  return min(r, r - p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;                           // < 2p < 2^32
  return min(s, s - p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t d = a - b;
  return a >= b ? d : d + p;
}

// Grid: (column tiles, row chunks, polys).
template <int kComp>
__global__ void __launch_bounds__(kThreads)
rescale_lift(const uint32_t* __restrict__ in, const int64_t* __restrict__ drop,
             const int64_t* __restrict__ keep, uint32_t* __restrict__ out,
             int L, int n) {
  constexpr int kDrop = 4 + 2 * kComp, kKeep = 1 + 3 * kComp;
  __shared__ uint32_t sk[kRows][kKeep];
  const int r0 = blockIdx.y * kRows, b = blockIdx.z;
  const int rows = min(kRows, L - r0);
  for (int i = threadIdx.x; i < rows * kKeep; i += kThreads)
    sk[i / kKeep][i % kKeep] = (uint32_t)keep[(size_t)r0 * kKeep + i];
  __syncthreads();
  const int col = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col >= n) return;

  // the dropped rows, plain: u = x 2^-32 mod q
  uint32_t u[kComp][kCols];
#pragma unroll
  for (int s = 0; s < kComp; ++s) {
    const int64_t* d = drop + s * kDrop;
    const uint32_t q = (uint32_t)d[0], ri = (uint32_t)d[2],
                   ri_sh = (uint32_t)d[3];
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(
        in + ((size_t)b * kComp + (kComp - 1 - s)) * n + col));
    u[s][0] = shoup(x.x, ri, ri_sh, q);
    u[s][1] = shoup(x.y, ri, ri_sh, q);
    u[s][2] = shoup(x.z, ri, ri_sh, q);
    u[s][3] = shoup(x.w, ri, ri_sh, q);
  }
  // step s: v = u[s], big = v > q_s // 2; the later rows lose the lift
  bool big[kComp][kCols];
#pragma unroll
  for (int s = 0; s < kComp; ++s) {
    const int64_t* d = drop + s * kDrop;
    const uint32_t half = (uint32_t)d[1];
#pragma unroll
    for (int c = 0; c < kCols; ++c) big[s][c] = u[s][c] > half;
#pragma unroll
    for (int t = s + 1; t < kComp; ++t) {
      const uint32_t qt = (uint32_t)drop[t * kDrop];
      const uint32_t w = (uint32_t)d[4 + 2 * t], w_sh = (uint32_t)d[5 + 2 * t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const uint32_t y = sub_mod(shoup(u[t][c], w, w_sh, qt),
                                   shoup(u[s][c], w, w_sh, qt), qt);
        u[t][c] = add_mod(y, big[s][c] ? 1u : 0u, qt);
      }
    }
  }

  uint32_t* o = out + ((size_t)b * L + r0) * n + col;
  for (int r = 0; r < rows; ++r, o += n) {
    const uint32_t p = sk[r][0];
    uint32_t acc[kCols] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < kComp; ++s) {
      const uint32_t cs = sk[r][1 + 3 * s], cs_sh = sk[r][2 + 3 * s],
                     es = sk[r][3 + 3 * s];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[c] = add_mod(acc[c], shoup(u[s][c], cs, cs_sh, p), p);
        if (big[s][c]) acc[c] = sub_mod(acc[c], es, p);
      }
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  }
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int kComp>
void launch(const uint32_t* in, const int64_t* drop, const int64_t* keep,
            uint32_t* out, int K, int L, int n, cudaStream_t st) {
  const dim3 grid((n + kTile - 1) / kTile, (L + kRows - 1) / kRows, K);
  rescale_lift<kComp><<<grid, kThreads, 0, st>>>(in, drop, keep, out, L, n);
}

}  // namespace

// out[K, L, n] = the combined lift of the comp dropped rows in[K, comp, n]
// on the L kept rows (see the top of this file); n a multiple of 4.
extern "C" int rescale_lift_launch(const void* in, const void* drop,
                                   const void* keep, void* out, int K,
                                   int comp, int L, int n, void* stream) {
  if (K < 1 || K > 65535 || comp < 1 || comp > kMaxComp || L < 1 ||
      (L + kRows - 1) / kRows > 65535 || n < kCols || n % kCols)
    return (int)cudaErrorInvalidValue;
  if (!aligned(in) || !aligned(out)) return (int)cudaErrorInvalidValue;
  const uint32_t* x = static_cast<const uint32_t*>(in);
  const int64_t* d = static_cast<const int64_t*>(drop);
  const int64_t* k = static_cast<const int64_t*>(keep);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (comp) {
    case 1: launch<1>(x, d, k, o, K, L, n, st); break;
    case 2: launch<2>(x, d, k, o, K, L, n, st); break;
    case 3: launch<3>(x, d, k, o, K, L, n, st); break;
    default: launch<4>(x, d, k, o, K, L, n, st); break;
  }
  return (int)cudaGetLastError();
}
