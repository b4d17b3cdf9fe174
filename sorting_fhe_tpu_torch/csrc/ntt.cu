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
// What bounds it on the H100.  A 2^17 limb is 512 KB, above the 227 KB of
// shared memory a block can hold, so the limb cannot stay on-chip for all
// 17 stages the way the Pallas kernel keeps it in VMEM.  Each pass over
// device memory reads and writes the data once; the least the card can do
// is one read and one write (plus the twiddle rows) at 3.35 TB/s.  The
// arithmetic needs 8 integer instructions per Shoup butterfly (umulhi, mul
// and mad plus one add-min for the product, an add and an add-min each for
// the sum and the difference), issued at most 4 x 32 per clock per SM: at
// [4, 119, 2^17] that is 530 M butterflies, 0.13 ms on 132 SMs at 1980 MHz
// against 0.19 ms for the bytes, so memory bounds the work.  Seven passes
// moved the data seven times; two passes move it twice.
//
// Design: two passes over device memory, the GPU counterpart of the Pallas
// kernel's two phases (stages across rows, then stages across lanes).  View
// a limb as [R, C] with C = 2^logc (2^11, or 2^10 for calls too small to
// fill the card) and R = n / C:
//   column pass  the log2(R) stages whose butterfly span is >= C pair
//                elements of one column.  A block loads a tile of R rows x
//                W consecutive columns (W = 8..64, 16-byte loads along each
//                row), runs those stages in shared memory with the R - 1
//                twiddles of the row staged in shared memory, and writes
//                the tile back.
//   chunk pass   the logc stages whose span is < C stay within one chunk
//                of C consecutive residues: one block per chunk, 16-byte
//                loads and stores.
// Both passes run their stages as radix-2^K steps (K <= 3): a thread loads
// 2^K elements of the tile into registers, runs K stages on them, and
// writes them back, so a tile is exchanged through shared memory only
// ceil(stages / 3) times.  For the integer pipe, each modular correction
// is an unsigned min (one fused add-min instruction on sm_90), and the
// tuple's shared-memory offsets and twiddle pointers are computed once per
// step or stage, not per element.  Lazy (Harvey) butterflies would save
// more but need 4p < 2^32, and the chain has primes up to 2^31.  K1 runs
// columns then chunks; K2 runs chunks then columns, with n^-1 applied
// after the last stage (in the chunk pass when there is no column pass).
// Blocks are numbered with the leading index fastest, so the blocks that
// share a twiddle row (the same chain row across the leading dim, e.g. the
// digits of the key-switch decompose) run next to each other and find its
// twiddles in L2.
//
// Interface: plain C, launched on the caller's stream, no allocation, no
// synchronisation, at most two kernel launches per call.  Each entry point
// returns the cudaError_t of its launches (0 = success); the Python wrapper
// raises on anything else.  `ntt_plan` reports the launch plan, for the
// wrapper's `launch_plan` and the card-only tests.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads per block, both passes
constexpr int kLogChunk = 11;     // chunk of 2^11 residues ...
constexpr int kMinBlocks = 132;   // ... unless that leaves SMs without one
constexpr int kMaxLogN = 18;      // the ring-2^18 tier: 7 column stages
constexpr int kMaxLogW = 6;       // column tiles of up to 64 columns
constexpr int kMinLogW = 3;       // ... and at least 8 (32-byte rows)

struct Plan {
  int logc;               // chunk of 2^logc residues; R = 2^(logn - logc)
  int logw;               // column tile width (0 without a column pass)
  long long col_blocks;   // 0 without a column pass
  long long chunk_blocks;
  int col_smem, chunk_smem;  // dynamic shared memory, bytes
};

// Shared-memory word of chunk element i: one pad word per 8 keeps the
// strided tuples of the late steps off a single bank.
__device__ __forceinline__ uint32_t pad(uint32_t i) { return i + (i >> 3); }

Plan make_plan(long long limbs, int logn) {
  Plan pl{};
  pl.logc = logn < kLogChunk ? logn : kLogChunk;
  if (logn > kLogChunk && (limbs << (logn - kLogChunk)) < kMinBlocks)
    pl.logc = kLogChunk - 1;
  const int logr = logn - pl.logc;
  const long long C = 1ll << pl.logc;
  pl.chunk_blocks = limbs << logr;
  pl.chunk_smem = (int)(sizeof(uint32_t) * (C + C / 8));
  if (logr > 0) {
    int logw = kMaxLogW;
    while (logw > kMinLogW && (limbs << (pl.logc - logw)) < kMinBlocks)
      --logw;
    pl.logw = logw;
    pl.col_blocks = limbs << (pl.logc - logw);
    pl.col_smem = (int)(sizeof(uint32_t) * ((1ll << (logr + logw)) +
                                            (2ll << logr)));
  }
  return pl;
}

// s mod p for s < 2p: when s < p, s - p wraps above s, so the unsigned
// minimum picks s; one fused add-min instruction (VIADDMNMX), where
// s >= p ? s - p : s takes a compare and a select besides the subtract.
__device__ __forceinline__ uint32_t reduce_2p(uint32_t s, uint32_t p) {
  return min(s, s - p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return reduce_2p(a + b, p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return reduce_2p(a + p - b, p);
}

// x * w mod p with w_sh = floor(w * 2^32 / p), valid for any x < 2^32.
__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
  return reduce_2p(x * w - __umulhi(x, w_sh) * p, p);
}

__device__ __forceinline__ int load_row(const int32_t* rows, int L, int LP,
                                        long long limb) {
  int row = rows[limb % L];
  if (row < 0 || row >= LP) __trap();  // surfaces as a CUDA error
  return row;
}

// Block b -> (limb, part of the limb), with the leading index fastest:
// b = ((l << logparts) + part) * lead + k, limb = k * L + l.
__device__ __forceinline__ long long block_limb(int L, long long lead,
                                                int logparts,
                                                uint32_t* part) {
  const long long b = blockIdx.x;
  const long long rest = b / lead;
  *part = (uint32_t)(rest & ((1ll << logparts) - 1));
  return (b - rest * lead) * L + (rest >> logparts);
}

// Word of element e, lane w of a tile: chunk tiles have one lane and are
// padded; column tiles are [rows][2^logw] plain.
template <bool kChunk>
__device__ __forceinline__ uint32_t at(uint32_t e, uint32_t w, int logw) {
  return kChunk ? pad(e) : (e << logw) + w;
}

// Word distance from a tuple's first element to the element d further
// on, inside the aligned block of elements that holds the tuple: a chunk
// tile's pad then adds d >> 3 wherever the tuple starts (a block of 8 or
// more elements holds whole pad groups, a smaller one lies in one).
template <bool kChunk>
__device__ __forceinline__ uint32_t at_delta(uint32_t d, int logw) {
  return kChunk ? d + (d >> 3) : d << logw;
}

// Twiddle i: the chunk pass reads the row in device memory through the
// read-only cache, the column pass its copy in shared memory.
template <bool kChunk>
__device__ __forceinline__ uint32_t twiddle(const uint32_t* t, int i) {
  return kChunk ? __ldg(t + i) : t[i];
}

// K consecutive stages, j .. j+K-1, of the 2^loge-element transform in
// shared memory, each of 2^logw lanes.  A thread takes 2^K elements
// e[k] = x[base + k*q] (a tuple closed under these K stages) into
// registers.  Twiddle of global group g at global stage s:
//   forward  tw[2^s + g],          s = s0 + local stage, g = c*2^local + gl
//   inverse  tw[2^(logtot-1-s) + g], g = c*2^(loge-1-s) + gl
// (chunk pass: s0 = logn - logc, logtot = logn, c = the chunk; column
// pass: s0 = 0, logtot = loge, c = 0).  With `scale`, every output also
// takes the n^-1 factor.
template <int K, bool kFwd, bool kChunk>
__device__ __forceinline__ void step(uint32_t* sh, int logw, int loge, int j,
                                     const uint32_t* twr,
                                     const uint32_t* twsr, int tw_shift,
                                     uint32_t c, uint32_t p, bool scale,
                                     uint32_t ninv, uint32_t ninv_sh) {
  // forward: spans t0 = 2^(loge-1-j) down to q; inverse: q = 2^j upwards
  const int logt0 = loge - 1 - j;
  const int logq = kFwd ? logt0 - (K - 1) : j;
  const uint32_t qmask = (1u << logq) - 1;
  const uint32_t wmask = (1u << logw) - 1;
  const uint32_t items = 1u << (loge - K + logw);
  // the tuple spans an aligned block of 2^(logq+K) elements
  uint32_t off[1 << K];
#pragma unroll
  for (int k = 0; k < (1 << K); ++k)
    off[k] = at_delta<kChunk>((uint32_t)k << logq, logw);
  for (uint32_t it = threadIdx.x; it < items; it += blockDim.x) {
    const uint32_t w = it & wmask;
    const uint32_t tup = it >> logw;
    const uint32_t G = tup >> logq;
    const uint32_t base = (G << (kFwd ? logt0 + 1 : j + K)) + (tup & qmask);
    uint32_t* const t0 = sh + at<kChunk>(base, w, logw);
    uint32_t e[1 << K];
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) e[k] = t0[off[k]];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (kFwd) {
        const int half = 1 << (K - 1 - m);
        const uint32_t tw0 =
            (1u << (tw_shift + j + m)) + (c << (j + m)) + (G << m);
        const uint32_t* const w0 = twr + tw0;
        const uint32_t* const ws0 = twsr + tw0;
#pragma unroll
        for (int k = 0; k < (1 << K); ++k) {
          if (k & half) continue;
          const int ti = k >> (K - m);
          const uint32_t u = e[k];
          const uint32_t v = shoup_mul(e[k + half], twiddle<kChunk>(w0, ti),
                                       twiddle<kChunk>(ws0, ti), p);
          e[k] = add_mod(u, v, p);
          e[k + half] = sub_mod(u, v, p);
        }
      } else {
        const int half = 1 << m;
        const int s = j + m;
        const uint32_t tw0 = (1u << (tw_shift - 1 - s)) +
                             (c << (loge - 1 - s)) + (G << (K - 1 - m));
        const uint32_t* const w0 = twr + tw0;
        const uint32_t* const ws0 = twsr + tw0;
#pragma unroll
        for (int k = 0; k < (1 << K); ++k) {
          if (k & half) continue;
          const int ti = k >> (m + 1);
          const uint32_t u = e[k];
          const uint32_t v = e[k + half];
          e[k] = add_mod(u, v, p);
          e[k + half] = shoup_mul(sub_mod(u, v, p), twiddle<kChunk>(w0, ti),
                                  twiddle<kChunk>(ws0, ti), p);
        }
      }
    }
    if (scale) {
#pragma unroll
      for (int k = 0; k < (1 << K); ++k)
        e[k] = shoup_mul(e[k], ninv, ninv_sh, p);
    }
#pragma unroll
    for (int k = 0; k < (1 << K); ++k) t0[off[k]] = e[k];
  }
}

// All loge stages of the tile as steps of K = 3 (the last 1 or 2), with
// n^-1 on the last step when `scale`.
template <bool kFwd, bool kChunk>
__device__ __forceinline__ void run_steps(uint32_t* sh, int logw, int loge,
                                          const uint32_t* twr,
                                          const uint32_t* twsr,
                                          int tw_shift, uint32_t c,
                                          uint32_t p, bool scale,
                                          uint32_t ninv, uint32_t ninv_sh) {
  for (int j = 0; j < loge;) {
    const int K = loge - j < 3 ? loge - j : 3;
    const bool sc = scale && j + K == loge;
    if (K == 3)
      step<3, kFwd, kChunk>(sh, logw, loge, j, twr, twsr, tw_shift, c, p, sc,
                            ninv, ninv_sh);
    else if (K == 2)
      step<2, kFwd, kChunk>(sh, logw, loge, j, twr, twsr, tw_shift, c, p, sc,
                            ninv, ninv_sh);
    else
      step<1, kFwd, kChunk>(sh, logw, loge, j, twr, twsr, tw_shift, c, p, sc,
                            ninv, ninv_sh);
    __syncthreads();
    j += K;
  }
}

// The logc short-span stages of one chunk of C = 2^logc residues: forward
// stages logn-logc .. logn-1, inverse stages 0 .. logc-1.  `vec`: the data
// pointers are 16-byte aligned and C >= 4, so it moves as uint4.
template <bool kFwd>
__global__ void __launch_bounds__(kThreads)
chunk_pass(const uint32_t* in, uint32_t* out, const int32_t* rows,
           const uint32_t* primes, const uint32_t* tw, const uint32_t* tw_sh,
           const uint32_t* ninv, const uint32_t* ninv_sh, int L, int LP,
           long long lead, int logn, int logc, bool scale, bool vec) {
  extern __shared__ uint32_t sh[];
  const uint32_t C = 1u << logc;
  uint32_t c;
  const long long limb = block_limb(L, lead, logn - logc, &c);
  const int row = load_row(rows, L, LP, limb);
  const uint32_t p = primes[row];
  const size_t off = ((size_t)limb << logn) + ((size_t)c << logc);
  const uint32_t* twr = tw + ((size_t)row << logn);
  const uint32_t* twsr = tw_sh + ((size_t)row << logn);
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(in + off);
    for (uint32_t v = threadIdx.x; v < C / 4; v += blockDim.x) {
      const uint4 x = src[v];
      const uint32_t a = pad(4 * v);   // 4 words of one pad group
      sh[a] = x.x;
      sh[a + 1] = x.y;
      sh[a + 2] = x.z;
      sh[a + 3] = x.w;
    }
  } else {
    for (uint32_t e = threadIdx.x; e < C; e += blockDim.x)
      sh[pad(e)] = in[off + e];
  }
  __syncthreads();
  run_steps<kFwd, true>(sh, 0, logc, twr, twsr, kFwd ? logn - logc : logn,
                        c, p, scale, scale ? ninv[row] : 0,
                        scale ? ninv_sh[row] : 0);
  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(out + off);
    for (uint32_t v = threadIdx.x; v < C / 4; v += blockDim.x) {
      const uint32_t a = pad(4 * v);
      dst[v] = make_uint4(sh[a], sh[a + 1], sh[a + 2], sh[a + 3]);
    }
  } else {
    for (uint32_t e = threadIdx.x; e < C; e += blockDim.x)
      out[off + e] = sh[pad(e)];
  }
}

// The log2(R) wide-span stages on a tile of R = 2^(logn-logc) rows x
// W = 2^logw columns of the [R, C] view of one limb: forward stages
// 0 .. log2(R)-1, inverse stages logc .. logn-1.  The R - 1 twiddles these
// stages use (tw[row][1 .. R-1]) are staged in shared memory.
template <bool kFwd>
__global__ void __launch_bounds__(kThreads)
col_pass(const uint32_t* in, uint32_t* out, const int32_t* rows,
         const uint32_t* primes, const uint32_t* tw, const uint32_t* tw_sh,
         const uint32_t* ninv, const uint32_t* ninv_sh, int L, int LP,
         long long lead, int logn, int logc, int logw, bool scale,
         bool vec) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int logr = logn - logc;
  const uint32_t R = 1u << logr, W = 1u << logw;
  uint32_t* tile = sm;                  // [R][W]
  uint32_t* tws = sm + (R << logw);     // [R]
  uint32_t* twss = tws + R;             // [R]
  uint32_t cb;
  const long long limb = block_limb(L, lead, logc - logw, &cb);
  const int row = load_row(rows, L, LP, limb);
  const uint32_t p = primes[row];
  const size_t off = ((size_t)limb << logn) + ((size_t)cb << logw);
  const uint32_t* twr = tw + ((size_t)row << logn);
  const uint32_t* twsr = tw_sh + ((size_t)row << logn);
  for (uint32_t i = threadIdx.x; i < R; i += blockDim.x) {
    tws[i] = __ldg(twr + i);
    twss[i] = __ldg(twsr + i);
  }
  const uint32_t words = R << logw;
  if (vec) {
    for (uint32_t e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x)
      *reinterpret_cast<uint4*>(tile + e) = *reinterpret_cast<const uint4*>(
          in + off + ((size_t)(e >> logw) << logc) + (e & (W - 1)));
  } else {
    for (uint32_t e = threadIdx.x; e < words; e += blockDim.x)
      tile[e] = in[off + ((size_t)(e >> logw) << logc) + (e & (W - 1))];
  }
  __syncthreads();
  run_steps<kFwd, false>(tile, logw, logr, tws, twss, kFwd ? 0 : logr, 0, p,
                         scale, scale ? ninv[row] : 0,
                         scale ? ninv_sh[row] : 0);
  if (vec) {
    for (uint32_t e = 4 * threadIdx.x; e < words; e += 4 * blockDim.x)
      *reinterpret_cast<uint4*>(out + off + ((size_t)(e >> logw) << logc) +
                                (e & (W - 1))) =
          *reinterpret_cast<const uint4*>(tile + e);
  } else {
    for (uint32_t e = threadIdx.x; e < words; e += blockDim.x)
      out[off + ((size_t)(e >> logw) << logc) + (e & (W - 1))] = tile[e];
  }
}

// The checks both entry points share; 0 when the call can be planned.
int check_args(const void* in, const void* out, int L, int LP,
               long long limbs, int logn, Plan* pl, bool* vec) {
  if (L <= 0 || LP <= 0 || limbs <= 0 || limbs % L || logn < 1 ||
      logn > kMaxLogN)
    return (int)cudaErrorInvalidValue;
  *pl = make_plan(limbs, logn);
  if (pl->chunk_blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = (uintptr_t)in | (uintptr_t)out;
  *vec = (addr & 15) == 0 && logn >= 2;
  return 0;
}

}  // namespace

// The launch plan of a call on `limbs` limbs of 2^logn residues:
// out = {logc, logw, col_blocks, chunk_blocks, col_smem, chunk_smem}.
extern "C" int ntt_plan(long long limbs, int logn, long long* out) {
  if (limbs <= 0 || logn < 1 || logn > kMaxLogN)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(limbs, logn);
  out[0] = pl.logc;
  out[1] = pl.logw;
  out[2] = pl.col_blocks;
  out[3] = pl.chunk_blocks;
  out[4] = pl.col_smem;
  out[5] = pl.chunk_smem;
  return 0;
}

// K1: out[..., L, n] = forward NTT of in[..., L, n]; limbs = prod(lead) * L.
// Launches the column pass (when logn > logc), then the chunk pass.
extern "C" int ntt_fwd_launch(const void* in, void* out, const void* rows,
                              const void* primes, const void* tw,
                              const void* tw_sh, int L, int LP,
                              long long limbs, int logn, void* stream) {
  Plan pl;
  bool vec;
  int err = check_args(in, out, L, LP, limbs, logn, &pl, &vec);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const uint32_t* pr = static_cast<const uint32_t*>(primes);
  const uint32_t* w = static_cast<const uint32_t*>(tw);
  const uint32_t* ws = static_cast<const uint32_t*>(tw_sh);
  const long long lead = limbs / L;
  if (pl.col_blocks) {
    col_pass<true><<<(unsigned int)pl.col_blocks, kThreads, pl.col_smem,
                     st>>>(src, dst, r, pr, w, ws, nullptr, nullptr, L, LP,
                           lead, logn, pl.logc, pl.logw, false, vec);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  chunk_pass<true><<<(unsigned int)pl.chunk_blocks, kThreads, pl.chunk_smem,
                     st>>>(src, dst, r, pr, w, ws, nullptr, nullptr, L, LP,
                           lead, logn, pl.logc, false, vec);
  return (int)cudaGetLastError();
}

// K2: out[..., L, n] = inverse NTT (with n^-1) of in[..., L, n].
// Launches the chunk pass, then the column pass (when logn > logc) in
// place on `out`; n^-1 goes with whichever pass runs last.
extern "C" int ntt_inv_launch(const void* in, void* out, const void* rows,
                              const void* primes, const void* tw,
                              const void* tw_sh, const void* ninv,
                              const void* ninv_sh, int L, int LP,
                              long long limbs, int logn, void* stream) {
  Plan pl;
  bool vec;
  int err = check_args(in, out, L, LP, limbs, logn, &pl, &vec);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const uint32_t* pr = static_cast<const uint32_t*>(primes);
  const uint32_t* w = static_cast<const uint32_t*>(tw);
  const uint32_t* ws = static_cast<const uint32_t*>(tw_sh);
  const uint32_t* ni = static_cast<const uint32_t*>(ninv);
  const uint32_t* nis = static_cast<const uint32_t*>(ninv_sh);
  const long long lead = limbs / L;
  chunk_pass<false><<<(unsigned int)pl.chunk_blocks, kThreads,
                      pl.chunk_smem, st>>>(src, dst, r, pr, w, ws, ni, nis,
                                           L, LP, lead, logn, pl.logc,
                                           pl.col_blocks == 0, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !pl.col_blocks) return (int)e;
  col_pass<false><<<(unsigned int)pl.col_blocks, kThreads, pl.col_smem,
                    st>>>(dst, dst, r, pr, w, ws, ni, nis, L, LP, lead, logn,
                          pl.logc, pl.logw, true, vec);
  return (int)cudaGetLastError();
}
