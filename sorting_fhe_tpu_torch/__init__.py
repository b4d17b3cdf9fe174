"""PyTorch + CUDA port of sorting_fhe_tpu: RNS-CKKS encrypted sorting.

Same module layout and names as the JAX package, which stays the
reference each part is checked against:

  core/    CKKS runtime: number theory, RNS arithmetic (rns), NTT tables
           and plain versions (ntt), the hand-written CUDA NTT kernels
           (cuda_ntt + csrc/ntt.cu), params, keys (host and device
           keygen), keystore (rotation-key streaming), ckks, poly_eval,
           bootstrap (EvalBootstrap), interop (JAX-side arrays <-> this
           package's tensors)
  ops/     sign / compare / rotation machinery / Chebyshev coefficients
  models/  direct_sort, mehp24, bitonic, kway
  utils/   testvec, debug (recrypt_hook: CPU tests only), plain
           (PlainContext), memory (MemoryMonitor)
  serial.py, driver.py, __main__.py   the client/server file protocol and
           the blind-sort CLI (python -m sorting_fhe_tpu_torch)
  experiments.py, characterize.py     the reference's report harness and
           sign characterizer
  bench.py sort_bench on one CUDA device
  parallel/ mesh (row-block placement, the logged all_gather),
           collective (the key switch with two explicit gathers) and
           evaluator (shard_context: the context's ops on a mesh)

Imports torch and numpy only, never jax.  The CUDA kernels build at first
use on a CUDA device (core/cuda_ntt.py).
"""
