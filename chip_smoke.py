"""Smoke run of the torch port on one CUDA GPU: build, check, sort, shard.

    python3 chip_smoke.py

1. Environment: Python/torch/CUDA versions and the card's name and power
   limit (nvidia-smi).  Exits non-zero without a CUDA device: nothing here
   runs on the CPU instead.
2. Build: compiles the six kernels (sorting_fhe_tpu_torch/csrc/ntt.cu,
   K1/K2; csrc/basis.cu, the base conversion; csrc/keyswitch.cu, the key
   inner product and ModDown's tail; csrc/rescale.cu, the composite
   rescale's lift) with nvcc from this checkout's
   sources and prints the build time and the registers of each kernel.
   When a copy of an earlier version of the NTT kernels sits at
   _chip/prev/ntt.cu (gitignored; e.g. `git show
   <commit>:sorting_fhe_tpu_torch/csrc/ntt.cu`), it is built beside them,
   in parallel, for the timing comparison of step 3 only.
3. Kernels vs plain versions, on the card, at ring 2^17 on the real
   prime chain of each path of steps 4, 6 and 7 (step 7 runs on hybrid1
   N=128's chain).  On the 119-row chain of hybrid1
   N=128: its shape classes ([4, 119, n] decompose, [2, 95, n]
   moddown/rescale forward, [95, n] decompose inverse, [2, 24, n] special
   primes, [2, 1, n] rescale row) plus the full prefix and rows
   [4, 1, 5].  On the 119-row chain of mehp24 N=128 (89 q primes, 30
   special, 3 digits): [3, 119, n], [2, 89, n], [89, n], [2, 30, n],
   [2, 1, n].  On every other chain its largest class, the top-level
   decompose ([10, 120, n] for hybrid1 N=512, [8, 121, n] for bitonic
   N=4, [3, 111, n] for kway N=16, [3, 116, n] for the CLI's direct
   N=128 at depth 42, [8, 119, n] for mehp24 N=512, whose chain also
   gets the device keygen's class [119, n]); on the two bootstrapping
   chains also
   the mod-raise's inverse NTT of the 3 base rows, [2, 3, n], and its
   forward NTT over the whole chain ([2, 107, n], [2, 83, n]).  On step
   8's chain, one slot's blocks of a 4-slot mesh (slot 1's rows): [4, 30,
   n] ext digits, [24, n] decompose, [2, 6, n] special rows and [2, 24,
   n] ModDown.  On the hybrid1 N=128 chain also step 9's ragged classes:
   slot 3's [4, 29, n] ext digits (23 q + 6 special rows) and a [2, 1, n]
   rescale row on one slot; on the two bootstrapping chains step 10's
   fullest slot class, slot 0's ext digits ([8, 31, n]: 27 q + 4 special
   rows of bitonic's chain; [3, 28, n]: 21 + 7 of k-way's), and so on the
   mehp24 N=512 chain for step 7b (c) ([8, 31, n]: 27 q + 4 special
   rows).  On step 4d's ring-2^18 chain (n = 2^18, 115 q + 39 special
   primes, dnum 3): its largest class, the top-level decompose [3, 154,
   n], and its composite rescale's two, [2, 115, n] forward and the [2,
   1, n] dropped row.  K1/K2 must be
   bit-equal
   to ntt_fwd_t/ntt_inv_t and inv(fwd(x)) == x.  Prints for each kernel
   and class its launch plan, its time (CUDA events over CUDA-graph
   replays, cycling through enough copies of the input that they do not
   fit the 50 MB L2), its bound (bytes over 3.35 TB/s, integer
   instructions over 132 SMs x 128 per clock x the SM's maximum clock)
   and share of it, the plain version's time and the earlier kernels'
   time in the same call (in turns: earlier, new, new, earlier; null
   without the copy).
   Then the base conversion (core/cuda_basis.py) on the level tables of
   the hybrid1 N=128 chain (ModUp and ModDown at the top level, 95 q +
   24 special rows in digits of 24, and at l = 3), the mehp24 N=128
   chain (top level, digits of 30) and step 4d's ring-2^18 chain (top
   level, digits of 39), ModUp with each digit's own rows copied
   (keep_own); and as the mesh calls it, without pre-scale, onto one
   slot's rows (_extend: every digit onto the slot's ext rows; _phase3:
   the special rows onto its q rows) at the slots whose K1/K2 classes
   are checked above: slot 3 of step 9, slot 1 of step 8, slot 0 of
   step 10's two chains and of 7b (c)'s.  The kernel must be bit-equal
   to base_conv_t; printed are its time (raw launches into preallocated
   outputs, as K1/K2's), its bound (the input read and the output
   written once over 3.35 TB/s; the multiply-adds whose sums the caller
   uses, at two IMADs each, over 132 SMs x 64 a clock x the SM's
   maximum clock) and share of it, and the plain version's time.
   Then the key inner product and ModDown's tail (core/cuda_keyswitch.py)
   at the top level of each benchmark cell's chain (hybrid1 N=128: 4
   digits of 24 rows over 119 ext rows; mehp24 N=128: 3 of 30; mehp24
   N=512: 8 of 14) and at one digit (hybrid1 at l = 20), for
   relinearisation and for the rotation by 1 (the digits read through
   its automorphism), on random digits and keys: each bit-equal to its
   plain version; printed are their times (raw launches, as above), their
   bounds (each input read once and each output written once over 3.35
   TB/s) and shares of them, and the plain versions' times.
   Then the composite rescale (core/cuda_rescale.py, comp = 2) from the
   top level of the hybrid1 N=128 (95 q rows), mehp24 N=128 (89),
   mehp24 N=512 (105) and ring-2^18 (115) chains, for 2 and 3 polys:
   rescale_lift bit-equal to rescale_lift_t, and the composed rescale
   (K2 of the dropped rows, the lift, K1, moddown_tail on the kept rows
   in place) bit-equal to the two-step int64 chain it replaced; printed
   are the lift's time (raw launches), its bound (the dropped rows read
   and the kept rows written once over 3.35 TB/s) and share, its plain
   version's time, and the whole rescale's time against the chain's.
4. The sorts, in this order, each through bench.sort_bench at ring 2^17,
   HEStd-128, on cuda:0, with the kernel launch counters reset just
   before it and read just after: hybrid1 N=128 (2 trials), mehp24 N=128
   (2 trials; sort_fg with all 35 rotation keys resident), direct,
   hybrid and hybrid2 N=128 (1 trial each), hybrid1 N=512 (the two-block
   path, 1 trial), bitonic N=4 (1 trial) and the k-way network k=2 N=16
   (1 trial), both bootstrapping mid-sort (EvalBootstrap, a sparse
   secret of Hamming weight 64).  Each requires its gate (max_err < 0.01;
   bitonic: its fixture's max error < 1.0 with no slot off by more than
   0.1 on the 0..255 scale), the HEStd-128 security check, launches of
   the six kernels in every trial, as many rescale_lift launches as the
   trial's census counts rescales (one a rescale) and, for bitonic and
   k-way, at least one bootstrap in every trial; it prints its trials,
   op census, plaintext encodes, kernel launches and bootstraps per
   trial, the peak device memory
   of each phase and the resident key set.
4c. On step 4's hybrid1 N=128 context, right after its trials (its
   chain: 95 q + 24 special rows, dnum 4): bench.micro_bench at the top
   level (per-op ms of mult_relin, rescale, the hoisting precompute and
   composed and hoisted rotation chains of 1 and 4 steps, CUDA events
   around chained repetitions, differenced; the host sinc's ns per
   evaluation), then bench.ntt_bench(17) (K1 on one [1, 64, 2^17] poly,
   4 and 24 calls differenced), each with the launch counters reset
   just before and read just after, printed on a line of its own with
   the card's name and power limit.  Requires every value finite and >
   0, rot_hoisted_1 within 1.1x of rot_composed_1 (at one step both do
   the same work), launches of the six kernels in the
   table and of K1 in ntt_bench; prints the rescale's ms beside the
   two-step int64 chain's 5.57 ms at the same level (an H100 at 700 W).
4d. The ring-2^18 tier: the registry's hybrid1 N=1024 (depth 56, 115 q
   + 39 special primes, dnum 3, 131072 slots, the 11 minimal rotation
   keys {1, 2, 4, ..., 1024} and relin, each [3, 2, 154, 2^18]) through
   bench.sort_bench at the ring of its registry entry, which must be
   2^18, one trial, with step 4's gates and prints; then the chain, the
   keys' shape and bytes and the plaintext cache's cap and entries, with
   the card's name and power limit.  No fallback: no other ring, no
   smaller N.
4b. Bootstrap phase, on the k-way N=16 chain (83 q primes, 28 special):
   one ciphertext at 128 slots, reduced to the raise point, is
   bootstrapped three times back to back, with a level_reduce to the
   raise point between them; each decrypts within 1e-3 of the input
   (tests/test_bootstrap.py's gate), and the phase launches all three
   kernels.  Prints the error after each
   bootstrap, its seconds by phase, its plaintext encodes, the device
   memory still allocated after it and the plaintext cache's bytes, and
   then (cache_bytes) the bytes reachable from each of the context's
   caches and the Bootstrapper, the bytes that only reference cycles
   still held (freed by the collection it runs), and the largest tensors
   outside the caches with their holders.
6. The CLI's blind sort in the reference's deployment shape (main.cpp:36:
   DirectSort N=128, CompositeSign(4, 3, 3)) at ring 2^17, HEStd-128: the
   client here makes the context (the registry's direct N=128 chain
   raised by the 12 levels that (4, 3, 3) spends over (3, 3, 2)), its 30
   rotation keys (DIRECT_SORT_ROTATIONS[128]) from a seed drawn from OS
   entropy, writes them with serial.save_eval_material into a temporary
   directory (printing the free space, the bytes and the seconds),
   encrypts and writes the input, and frees its keys on the card; the
   server, `python -m sorting_fhe_tpu_torch` in a separate process,
   loads the files, sorts blind on the card and writes the output; the
   client decrypts it.  Requires that the files hold public material
   only (the .npz members are keys, and the context file names no seed:
   the secret that a client built from it draws differs from the
   client's), max_err < 0.01, the security check and launches of K1,
   K2 and the base conversion in the server's sort (as the server prints
   them).
7. The experiment harness: experiments.main for hybrid1 N=128, 2 trials
   with --reuse-context, in this process.  Prints its N128_summary.txt
   and each trial's device memory by phase (utils/memory.py) beside
   sort_bench's for the same cell in step 4; requires max_err < 0.01 in
   each trial and launches of the six kernels.
7b. Rotation-key streaming with device keygen, on the mehp24 N=512
   chain (depth 51, dnum 8; 41 rotation keys of 0.998 GB).  (a) For
   rotations 1, 32640 and 65280 (= -256, a split stride): the device
   keygen's key made twice must be bit-equal, and under another seed its
   uniform halves must differ; the device and host keygens' seconds per
   key (device synchronised); a fresh ciphertext rotated with the
   streamed key and with the host key must decrypt within 1e-5 of
   np.roll.  (b) experiments.main for mehp24 N=512 (sort_large_array_fg,
   one trial, a fresh context) with SORTING_FHE_KEY_BUDGET_MB=5120, which
   holds 5 keys, with the launch counters reset just before and read just
   after: requires max_err < 0.01, HEStd-128, launches of the six
   kernels in the sort, more regenerations than keys and the resident
   keys within the budget; prints setup seconds and exec
   ms, the regenerations and the seconds in the key store's hook
   (synchronised), the K1 launches of the keygen apart from the sort's,
   the device memory per phase, the bytes allocated after the sort and
   the caches' bytes (cache_bytes).
   (c) Right after (b), before its context is released: the same sort on
   that context and input on shard_context(ctx, a virtual mesh of 4
   slots on cuda:0) under the same budget (the key store keeps each
   streamed key as its slot blocks), its sorter from bench.build_sorter,
   the launch counters and the op census reset just before it.  Requires
   torch.equal to (b)'s output, (b)'s census, the 0.01 gate, as many
   regenerations as (b), the store's bytes within the budget at every
   regeneration of (b) and (c) and at the end, no streamed key's blocks
   kept by the mesh, and launches of the six kernels; prints both runs'
   seconds and their ratio, the regenerations, the seconds in the hook
   and each peak.
8. The limb-sharded key switch (sorting_fhe_tpu_torch/parallel/) on a
   virtual mesh of 4 slots on cuda:0, at ring 2^17 on a comp-1 chain
   whose rows divide the mesh (96 q + 24 special primes, dnum 4, scale
   2^28, logQP 3476; the JAX multichip dryrun's kind of chain at full
   width), with the relin key and rotation keys {1, 3} from the host
   keygen (the JAX package's bits).  With the launch counters reset just
   before its ops and read just after: mult_relin of two fresh 128-slot
   ciphertexts, their rotations by 1 and 3, and the product's rotations by
   1 and 3, each torch.equal to the single-device op on the same data;
   the product and its rotations, rescaled and decrypted, within 1e-2 of
   v*w and np.roll(v*w, -k) (the fresh rotations' error, about 0.13 at
   this scale in both paths, is printed); exactly two gathers per op of
   (D-1)/D of the [96, n] digit residues and of the [2, 24, n] special
   residues (37,748,736 and 18,874,368 bytes per slot, as
   collective_bytes(k=2) counts them); launches of the five kernels that
   key-switch (the ops do not rescale).  Prints
   the launches per op, best-of-5 ms of each op on the mesh and on one
   device (synchronised, warm), the step's peak device memory and
   comm_budget of step 4's hybrid1 N=128 census; with two cards or
   more, the same ops on a mesh of distinct cards (bit-equality and
   times), else that it was not run.
9. The row-sharded evaluator (parallel/evaluator.py): hybrid1 N=128 at
   ring 2^17 on its registry chain (95 q + 24 special primes, dnum 4,
   HEStd-128), one context with host-keygen keys (the 11 minimal keys
   and relin) and one input from a fixed seed.  (a) The single-device
   sort_hybrid1; (b) the same call on shard_context(ctx, a virtual mesh
   of 4 slots on cuda:0), the input sharded, with the launch counters,
   the op census and the mesh's gathers reset just before it and read
   just after; (c) with two cards or more, the same on a mesh of up to 4
   distinct cards, else a line that it was not run.  Requires (b), and
   (c) where it runs, torch.equal to (a) once gathered; (b)'s op census
   equal to (a)'s; max_err < 0.01; launches of the six kernels in (b); the
   gathers per tag that the census implies (digit: key switches -
   fast_rotate + decompose; moddown: key switches; rescale: rescales);
   their summed bytes per slot at or below comm_budget of the census
   (every op at the full level).  Prints the trials' seconds, the rows
   each slot held at each level, the slowest slot's rows over a balanced
   share summed over the digit gathers, the step's peak device memory
   and the launches.
10. Step 4's bootstrapping sorts on the row-sharded evaluator: bitonic
   N=4 and k-way k=2 N=16, each run right after its step-4 path, on that
   path's context (host-keygen keys), input (step 4's data from seed 42)
   and first trial's output, which bench.sort_bench hands over (`keep`);
   the other contexts of step 4 are freed as before.  (a) Is that
   single-device trial; (b) the same call, its sorter built by
   bench.build_sorter on shard_context(ctx, a virtual mesh of 4 slots on
   cuda:0) with a counting BootstrapHook of its own, after what (a) no
   longer needs is released, the launch counters, the op census, the
   gathers and the hook's calls reset just before it; (c) with two cards
   or more, the same on up to 4 distinct cards, else a line that it was
   not run.  Requires (b), and (c) where it runs, torch.equal to (a);
   the same census; step 4's gate; a bootstrap in (b), as many as in
   (a); the gathers per tag that the census and the bootstraps imply
   (step 9's, and a "raise" gather per bootstrap of (D-1)/D of the [2,
   3, n] base rows); their bytes per slot at or below comm_budget of the
   census plus the raise gathers' bytes; launches of the six kernels
   in (b).
   Prints (a)'s and (b)'s seconds and their ratio, each bootstrap's
   seconds by phase on the mesh beside one device, the gathers and bytes
   per tag, the slots' rows at each level and the slowest slot over a
   balanced share, the launches and the peak device memory.
11. Prints the kernel record (one JSON line: each kernel's time and
   bound at the largest class of the mehp24 chain and its launches on
   the mehp24 path, and under "paths" the same for every path, the
   bootstrap phase and steps 6, 7, 7b, 8, 9 and 10 (the largest class of
   the CLI's chain, the hybrid1 N=128 chain's, the mehp24 N=512 chain's,
   for step 4d the ring-2^18 chain's with every class checked on it,
   for the device keygen the [119, n] class with its K1 launches in 7b's
   sort, for the mesh a slot's [4, 30, n] class, for the sharded sort
   slot 3's [4, 29, n] and for step 10's sorts and 7b (c) slot 0's ext
   digits), the launches of step 4c's micro table and ntt_bench, and
   ntt_bench's limb NTTs per second under K1; then the base
   conversion's time and bound at the hybrid1 N=128 chain's top-level
   ModUp, every class of step 3, its launches on hybrid1 N=128 and in
   step 4c's table, and under "paths" its launches on every path and
   phase that key-switches; the same for the key inner product and
   ModDown's tail, at the hybrid1 N=128 chain's top level), the card's
   name and power limit, and as the last
   line {"ok": true, "device": {...}}.  Any failed check raises, so the
   script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import platform
import re
import secrets
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from pathlib import Path

import numpy as np
import torch

from sorting_fhe_tpu_torch.core import cuda_lib

RING_LOG = 17
# (label, algo, N, trials), in the order they run; MAIN is this slice's
# main path.  hybrid1 N=512 and bitonic N=4 run one trial each (two until
# step 10 came), which keeps the script within 1000 s
PATHS = (("hybrid1 N=128", "hybrid1", 128, 2),
         ("mehp24 N=128", "mehp24", 128, 2),
         ("direct N=128", "direct", 128, 1),
         ("hybrid N=128", "hybrid", 128, 1),
         ("hybrid2 N=128", "hybrid2", 128, 1),
         ("hybrid1 N=512", "hybrid1", 512, 1),
         ("bitonic N=4", "bitonic", 4, 1),
         ("kway k=2 N=16", "kway", 16, 1))
MAIN = "mehp24 N=128"
BOOT_PATHS = ("bitonic N=4", "kway k=2 N=16")
# step 4b: bootstraps of one 128-slot ciphertext on the k-way chain
BOOT_PHASE = "bootstrap x3 slots=128"
BOOT_CHAIN = "kway k=2 N=16"
BOOT_SLOTS, BOOT_ROUNDS, BOOT_GATE = 128, 3, 1e-3
# step 6: the reference's deployment (main.cpp:36): the CLI's blind
# DirectSort of N=128 with its fixed CompositeSign(4, 3, 3), which spends
# 27 levels against the registry ladder's (3, 3, 2) 15 (characterize.py,
# the same in both packages); the chain is the registry's direct N=128
# (depth 30) raised by those 12: the sort then spends 41 levels and ends
# on a product not yet rescaled (the port on the CPU at ring 2^10)
CLI_PATH = "cli direct N=128"
CLI_ALGO, CLI_N, CLI_EXTRA_DEPTH, CLI_SEED = "direct", 128, 12, 7
CLI_TIMEOUT_S = 600
# step 7: the experiment harness on the main path's chain
EXP_PATH = "experiments hybrid1 N=128"
EXP_ALGO, EXP_N, EXP_TRIALS = "hybrid1", 128, 2
EXP_CHAIN = "hybrid1 N=128"
# step 7b: rotation-key streaming on the mehp24 N=512 chain
# (sort_large_array_fg: two 256-blocks, 41 rotation keys of 0.998 GB,
# 40.9 GB in all) under the JAX harness's budget (experiments.py:90-99),
# which holds 5 of them; device keygen checked on three of its rotations,
# 65280 = -256 being a split stride
STREAM_PATH = "mehp24 N=512 streamed"
STREAM_KEYGEN = "mehp24 N=512 device keygen"
STREAM_ALGO, STREAM_N, STREAM_BUDGET_MB = "mehp24", 512, 5120
STREAM_ROTS, STREAM_ROT_GATE = (1, 32640, 65280), 1e-5
# step 7b (c): 7b's streamed sort, right after it, on its context and
# input, on the row-sharded evaluator over 4 virtual slots (105 q + 14
# special rows in blocks of 27/27/27/24 and 4/4/4/2) under the same budget
STREAM_MESH = "mesh mehp24 N=512 streamed"
STREAM_MESH_SLOTS = 4
# step 4c: the micro table and K1's throughput (bench.micro_bench at the
# top level of the main path's chain, 95 q + 24 special rows, dnum 4, on
# step 4's hybrid1 N=128 context; bench.ntt_bench on 64 limbs)
MICRO_PATH = "micro hybrid1 N=128"
MICRO_CHAIN = "hybrid1 N=128"
NTT_PATH = "ntt_bench"
MICRO_HOIST_SLACK = 1.1      # rot_hoisted_1 within 10% of rot_composed_1
# step 4d: the ring-2^18 tier, which registry._ring_for gives every depth
# that does not fit HEStd-128 at ring 2^17: the registry's hybrid1 N=1024
# (depth 56, 115 q + 39 special primes, dnum 3), its ring taken from the
# registry entry, not from RING_LOG
R18_PATH = "hybrid1 N=1024 ring 2^18"
R18_ALGO, R18_N, R18_TRIALS, R18_RING_LOG = "hybrid1", 1024, 1, 18
# step 8: the limb-sharded key switch (parallel/) on a chain whose q and
# special rows divide the mesh.  The registry's comp-2 chains have an odd
# nq = 3 + 2 * depth, so comp 1, as the JAX package's multichip dryrun
# takes (__graft_entry__.py:77-80), at full width: 96 q + 24 special
# primes, dnum 4 (the relin key [4, 2, 120, n], 0.503 GB), logQP 3476.
# Scale 2^28, the most that keeps 96 q rows under HEStd-128: a product
# of two fresh ciphertexts decrypts 0.0133 off at 2^27 on an H100
MESH_PATH = "mesh keyswitch"
MESH_CFG = dict(comp=1, mult_depth=94, scale_bits=28, dnum=4,
                num_special_primes=24)
MESH_SLOTS, MESH_N, MESH_ROTS, MESH_GATE, MESH_REPS = 4, 128, (1, 3), 1e-2, 5
MESH_CENSUS = "hybrid1 N=128"        # step 4's census for comm_budget
# step 9: the main path's sort, unchanged, on the row-sharded evaluator
# (4 slots on the registry's comp-2 chain: ragged blocks of 24/24/24/23 q
# and 6 special rows)
SHARD_PATH = "mesh hybrid1 N=128"
SHARD_ALGO, SHARD_N, SHARD_SLOTS, SHARD_SEED = "hybrid1", 128, 4, 9
SHARD_CHAIN = "hybrid1 N=128"
# step 10: step 4's bootstrapping sorts, unchanged, on the row-sharded
# evaluator (4 slots: bitonic N=4's 107 q + 14 special rows in blocks of
# 27/27/27/26 and 4/4/4/2, k-way k=2 N=16's 83 q + 28 special in blocks of
# 21/21/21/20 and 7), each keyed by its step-4 path, right after which it
# runs on that path's context, input and output
BOOT_MESH = {"bitonic N=4": "mesh bitonic N=4",
             "kway k=2 N=16": "mesh kway k=2 N=16"}
BOOT_MESH_SLOTS = 4
PREV_SRC = Path("_chip/prev/ntt.cu")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
L2_BYTES = 50 * 2**20              # H100 SXM L2
ISSUE_PER_CLOCK = 132 * 4 * 32     # SMs x schedulers x lanes: instructions
IMAD_PER_CLOCK = 132 * 64          # SMs x 32-bit multiply-adds a clock
# step 3's base conversions (core/cuda_basis.py): on each chain (keyed by
# its first path), (kind, level, slot, slots) of the classes checked,
# level None for the chain's top level.  ModUp and ModDown on one card;
# the mesh's _extend and _phase3 (no pre-scale, one slot's target rows)
# on the slot of each mesh path whose K1/K2 classes step 3 checks
BASIS_CLASSES = {
    "hybrid1 N=128": (("modup", None, None, None),
                      ("moddown", None, None, None),
                      ("modup", 3, None, None), ("moddown", 3, None, None),
                      ("extend", None, 3, SHARD_SLOTS),
                      ("phase3", None, 3, SHARD_SLOTS)),
    "mehp24 N=128": (("modup", None, None, None),
                     ("moddown", None, None, None)),
    "bitonic N=4": (("extend", None, 0, BOOT_MESH_SLOTS),
                    ("phase3", None, 0, BOOT_MESH_SLOTS)),
    "kway k=2 N=16": (("extend", None, 0, BOOT_MESH_SLOTS),
                      ("phase3", None, 0, BOOT_MESH_SLOTS)),
    STREAM_PATH: (("extend", None, 0, STREAM_MESH_SLOTS),
                  ("phase3", None, 0, STREAM_MESH_SLOTS)),
    MESH_PATH: (("extend", None, 1, MESH_SLOTS),
                ("phase3", None, 1, MESH_SLOTS)),
    R18_PATH: (("modup", None, None, None), ("moddown", None, None, None))}
# step 3's key inner product and ModDown tail (core/cuda_keyswitch.py): on
# each chain (keyed by its first path), (level, key) of the classes
# checked, level None for the chain's top level, key "relin" (no
# automorphism) or a rotation index: the top level of each benchmark
# cell's chain (hybrid1 N=128: 4 digits of 24 rows; mehp24 N=128: 3 of 30;
# mehp24 N=512: 8 of 14) and one digit (hybrid1 at l = 20)
KS_CLASSES = {
    "hybrid1 N=128": ((None, "relin"), (None, 1), (20, "relin"), (20, 1)),
    "mehp24 N=128": ((None, "relin"), (None, 1)),
    STREAM_PATH: ((None, "relin"), (None, 1))}
KS_KERNELS = ("ks_inner", "moddown_tail")
# step 3's composite rescale (core/cuda_rescale.py): the chains (keyed by
# their first path) whose top level it checks, at comp = 2: hybrid1 N=128
# (95 q rows), mehp24 N=128 (89), mehp24 N=512 (105), ring 2^18 (115)
RESCALE_CHAINS = ("hybrid1 N=128", "mehp24 N=128", STREAM_PATH, R18_PATH)
# the micro table's rescale at l = 95 with the two-step int64 chain the
# lift kernel replaced (an H100 at 700 W), printed beside step 4c's
RESCALE_CHAIN_MS = 5.57
# what step 8's mesh ops launch: every kernel but the rescale's
KS_PATH_KERNELS = tuple(k for k in cuda_lib.KERNELS if k != "rescale_lift")


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _nvidia_smi_clock_mhz() -> float:
    """The SM's maximum clock (MHz), for the integer-pipe bound."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0])


def _time_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(launches, replays: int = 5) -> float:
    """Device time of one launch: max(10, len(launches)) launches, taken
    in turn from `launches` (one per copy of the input), captured in a
    CUDA graph (so the host's enqueue time does not hide in the number),
    replayed once to warm up, then CUDA events around `replays` replays;
    the mean over all the launches replayed."""
    for launch in launches:
        launch()
    torch.cuda.synchronize()
    per_graph = max(10, len(launches))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            launches[i % len(launches)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def _launch_counts() -> dict:
    """Every kernel's launches since the last cuda_lib.reset()."""
    return {k: cuda_lib.launches[k] for k in cuda_lib.KERNELS}


def _residues(rng, primes, lead, n, device) -> torch.Tensor:
    p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=lead + (len(primes), n),
                     dtype=np.uint64) % p
    return torch.from_numpy(x.astype(np.uint32).view(np.int32)).to(device)


def _start_prev_build():
    """Start nvcc on the earlier kernels' source (PREV_SRC), when a copy
    is there, beside the build of this checkout's kernels."""
    if not PREV_SRC.exists():
        return None
    so = PREV_SRC.parent / "_build" / "libntt_prev.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so),
           str(PREV_SRC)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def _load_prev(started):
    """The earlier kernels' library (same C interface), or None."""
    if started is None:
        return None
    proc, so = started
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {PREV_SRC} failed:\n{err}")
    return cuda_lib.load(so)


def _launches(lib, fwd: bool, pairs, tabs, rows) -> list:
    """Raw launches of K1 (fwd) or K2 of `lib`, one for each (input,
    preallocated output) pair: no wrapper, no allocation, no launch
    count."""
    from sorting_fhe_tpu_torch.core import cuda_ntt
    if fwd:
        fn, tables = lib.ntt_fwd_launch, (tabs.psi, tabs.psi_sh)
    else:
        fn, tables = lib.ntt_inv_launch, (tabs.ipsi, tabs.ipsi_sh,
                                          tabs.n_inv, tabs.n_inv_sh)

    def launcher(x, out):
        def launch():
            err = fn(x.data_ptr(), out.data_ptr(), rows.data_ptr(),
                     tabs.p.data_ptr(), *(t.data_ptr() for t in tables),
                     *cuda_ntt._dims(x, tabs),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{fn.__name__} failed: cudaError {err}")
        return launch
    return [launcher(x, out) for x, out in pairs]


def _bound(x, rows, n: int, fwd: bool, int_rate: float) -> dict:
    """Least time of one call: the bytes it must move (input read once,
    output written once, the twiddle and Shoup rows of each distinct
    chain row once) over 3.35 TB/s, and its integer instructions over
    int_rate.  A Shoup butterfly needs 8: umulhi, mul, mad and an add-min
    for the product, an add and an add-min each for the sum and the
    difference (as in the kernels' SASS); K2's n^-1 multiply needs 4."""
    limbs = x.numel() // n
    logn = n.bit_length() - 1
    nbytes = 2 * x.numel() * 4 + 2 * len(set(rows.tolist())) * n * 4
    ops = 8 * limbs * (n // 2) * logn + (0 if fwd else 4 * limbs * n)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / int_rate * 1e3
    return {"bytes": nbytes, "int_ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _chain_classes(P, label: str) -> list:
    """(name, chain rows, leading dims) of the classes checked on P's
    chain: the hybrid1 N=128 chain's seven, the mehp24 chain's five
    (MAIN), or the largest, the top-level decompose, on any other, with
    the mod-raise's two on the bootstrapping chains."""
    nq, LP = P.nq, len(P.all_primes)
    digits = -(-nq // P.alpha)
    big = (f"[{digits}, {LP}, n] decompose fwd", list(range(LP)), (digits,))
    classes = [big,
               (f"[2, {nq}, n] moddown/rescale fwd", list(range(nq)), (2,)),
               (f"[{nq}, n] decompose inv", list(range(nq)), ()),
               (f"[2, {LP - nq}, n] special primes", list(range(nq, LP)),
                (2,)),
               ("[2, 1, n] rescale row", [nq - 1], (2,))]
    if label == SHARD_CHAIN:     # and step 9's slot 3, ragged
        from sorting_fhe_tpu_torch.parallel.mesh import row_blocks
        (lo, hi), (slo, shi) = (row_blocks(c, SHARD_SLOTS)[-1]
                                for c in (nq, LP - nq))
        ext = list(range(lo, hi)) + list(range(nq + slo, nq + shi))
        return classes + [(f"[{LP}, n] full prefix", list(range(LP)), ()),
                          ("[3, n] rows [4, 1, 5]", [4, 1, 5], ()),
                          (f"[{digits}, {len(ext)}, n] slot 3 ext digits",
                           ext, (digits,)),
                          ("[2, 1, n] slot rescale row", [lo], (2,))]
    if label in BOOT_PATHS:      # and step 10's slot 0, the fullest
        from sorting_fhe_tpu_torch.parallel.mesh import row_blocks
        (lo, hi), (slo, shi) = (row_blocks(c, BOOT_MESH_SLOTS)[0]
                                for c in (nq, LP - nq))
        ext = list(range(lo, hi)) + list(range(nq + slo, nq + shi))
        return [big, ("[2, 3, n] mod-raise inv", [0, 1, 2], (2,)),
                (f"[2, {nq}, n] mod-raise fwd", list(range(nq)), (2,)),
                (f"[{digits}, {len(ext)}, n] slot 0 ext digits", ext,
                 (digits,))]
    if label == STREAM_PATH:     # the device keygen's NTTs: every row;
        # 7b (c)'s slot 0, the fullest
        from sorting_fhe_tpu_torch.parallel.mesh import row_blocks
        (lo, hi), (slo, shi) = (row_blocks(c, STREAM_MESH_SLOTS)[0]
                                for c in (nq, LP - nq))
        ext = list(range(lo, hi)) + list(range(nq + slo, nq + shi))
        return [big, (f"[{LP}, n] keygen", list(range(LP)), ()),
                (f"[{digits}, {len(ext)}, n] slot 0 ext digits", ext,
                 (digits,))]
    if label == R18_PATH:        # and its composite rescale's two
        return classes[:2] + [classes[4]]
    if label == MESH_PATH:       # one slot's blocks: slot 1's rows
        bq, bs = nq // MESH_SLOTS, (LP - nq) // MESH_SLOTS
        q, s = list(range(bq, 2 * bq)), list(range(nq + bs, nq + 2 * bs))
        return [(f"[{digits}, {bq + bs}, n] slot ext digits", q + s,
                 (digits,)),
                (f"[{bq}, n] slot decompose", q, ()),
                (f"[2, {bs}, n] slot special rows", s, (2,)),
                (f"[2, {bq}, n] slot moddown", q, (2,))]
    return classes if label == MAIN else [big]


def _check_class(lib, prev, P, name, sel, lead, rng, int_rate) -> tuple:
    """One shape class on chain P: bit-equality of K1/K2 with the plain
    versions and inv(fwd(x)) == x, then times and bounds.  Returns the
    table row and the largest fwd / inv errors (0 when bit-equal)."""
    from sorting_fhe_tpu_torch.core import cuda_ntt
    from sorting_fhe_tpu_torch.core.ntt import ntt_fwd_t, ntt_inv_t
    tabs, n, device = P.ntt, P.n, P.device
    rows = torch.tensor(sel, dtype=torch.int32, device=device)
    r = rows.long()
    x = _residues(rng, [P.all_primes[i] for i in sel], lead, n, device)
    fwd_k = cuda_ntt.ntt_fwd(x, tabs, rows)
    fwd_p = ntt_fwd_t(x, tabs.p[r], tabs.psi[r])
    inv_k = cuda_ntt.ntt_inv(fwd_k, tabs, rows)
    inv_p = ntt_inv_t(fwd_p, tabs.p[r], tabs.ipsi[r], tabs.n_inv[r])
    torch.cuda.synchronize()
    e_f = int((fwd_k.long() - fwd_p.long()).abs().max())
    e_i = int((inv_k.long() - inv_p.long()).abs().max())
    if e_f or e_i or not torch.equal(inv_k, x):
        raise AssertionError(f"{name}: kernel != plain (fwd err {e_f}, "
                             f"inv err {e_i}, round trip "
                             f"{torch.equal(inv_k, x)})")
    del fwd_p, inv_p
    # copies of the input, so that the timed launches read and write
    # at least twice the L2 and find nothing of their data there
    copies = min(64, -(-L2_BYTES // (x.numel() * 4)))
    row = {"case": name, "shape": list(x.shape[:-1]) + [n],
           "plan": cuda_ntt.launch_plan(x.numel() // n, tabs.logn),
           "copies": copies}
    outs = [torch.empty_like(x) for _ in range(copies)]
    for tag, fwd, src in (("fwd", True, x), ("inv", False, fwd_k)):
        pairs = list(zip([src] + [src.clone()
                                  for _ in range(copies - 1)], outs))
        new = _launches(lib, fwd, pairs, tabs, rows)
        if prev is not None:
            old = _launches(prev, fwd, pairs, tabs, rows)
            old[0]()
            if not torch.equal(outs[0], fwd_k if fwd else x):
                raise AssertionError(f"{name}: earlier {tag} kernel "
                                     "disagrees")
            # in turns: old, new, new, old
            t_old = _kernel_ms(old)
            t_new = _kernel_ms(new) + _kernel_ms(new)
            t_old = (t_old + _kernel_ms(old)) / 2
            t_new /= 2
        else:
            t_old, t_new = None, _kernel_ms(new)
        if fwd:
            plain = _time_ms(lambda: ntt_fwd_t(src, tabs.p[r],
                                               tabs.psi[r]), 2)
        else:
            plain = _time_ms(lambda: ntt_inv_t(src, tabs.p[r],
                                               tabs.ipsi[r],
                                               tabs.n_inv[r]), 2)
        b = _bound(src, rows, n, fwd, int_rate)
        row[tag] = {"ms": t_new, "prev_ms": t_old, "plain_ms": plain,
                    **b, "share": b["bound_ms"] / t_new}
        del pairs, new
    return row, e_f, e_i


def _basis_case(P, kind, l, slot, slots, rng) -> tuple:
    """The input, base_conv's arguments after it and, per digit, the
    target rows whose sums the caller does not use, of one class on chain
    P at limb count l.  ModUp: the q rows' Montgomery coefficients, every
    digit onto the l + special ext rows, the pre-scale fused and each
    digit's own rows copied (keep_own); ModDown: both polys' special rows
    onto the q rows, pre-scaled.  On a mesh slot (row_blocks of `slots`)
    without pre-scale: _extend, the gathered [l, n] digit residues onto
    the slot's ext rows, of which torch.where then replaces the slot's q
    rows in each digit; _phase3, the gathered [2, special, n] residues
    onto the slot's q rows."""
    from sorting_fhe_tpu_torch.core.ckks import _LevelTables
    from sorting_fhe_tpu_torch.parallel.mesh import SlotTables, row_blocks
    T = _LevelTables(P, l)
    ndig = -(-l // T.alpha)
    if kind == "modup":
        x = _residues(rng, P.q[:l], (1,), P.n, P.device)
        return x, (T.dig_conv, T.ext_p, T.alpha, T.dig_in, T.q_p, True), \
            [len(d) for d in T.digits]
    if kind == "moddown":
        x = _residues(rng, list(P.p_special), (2,), P.n, P.device)
        return x, (T.md_conv, T.q_p, T.ksp, T.md_in, T.sp_p, False), [0]
    (lo, hi), (slo, shi) = (row_blocks(c, slots)[slot]
                            for c in (P.nq, P.num_special))
    S = SlotTables(P, T, torch.arange(lo, max(lo, min(hi, l))),
                   torch.arange(slo, shi), hi - lo, P.device, P.ntt)
    if kind == "extend":
        x = _residues(rng, P.q[:l], (1,), P.n, P.device)
        return x, (S.dig_conv, S.ext_p, S.alpha, None, None, False), \
            [int(S.in_digit[j].sum()) for j in range(ndig)]
    x = _residues(rng, list(P.p_special), (2,), P.n, P.device)
    return x, (S.md_conv, S.q_p, T.ksp, None, None, False), [0]


def _check_basis(lib, P, kind, l, slot, slots, rng, imad_rate) -> dict:
    """One base-conversion class (_basis_case): the kernel bit-equal to
    base_conv_t, then its time (raw launches into preallocated outputs,
    _kernel_ms), the plain version's, and the bound: input read and
    output written once, the conversion table read once, over 3.35 TB/s;
    the multiply-adds the caller uses (none for the rows it copies or
    replaces) at two IMADs each (mad.lo.cc, madc.hi.cc) over imad_rate."""
    from sorting_fhe_tpu_torch.core.cuda_basis import base_conv, base_conv_t
    x, args, unused = _basis_case(P, kind, l, slot, slots, rng)
    conv, p, alpha, w, q, keep = args
    got = base_conv(x, conv, p, alpha, w, q, keep_own=keep)
    want = base_conv_t(x, conv, p, alpha, w, q, keep_own=keep)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    case = f"{kind} l={l}" + ("" if slot is None else
                              f" slot {slot} of {slots}")
    if err:
        raise AssertionError(f"base_conv {case}: kernel != plain "
                             f"(max err {err})")
    del want
    K, L, n = x.shape
    R = p.numel()
    copies = min(64, -(-L2_BYTES // (x.numel() * 4 + got.numel() * 4)))
    pairs = [(x if i == 0 else x.clone(), torch.empty_like(got))
             for i in range(copies)]

    def launcher(xi, out):
        def launch():
            e = lib.base_conv_launch(
                xi.data_ptr(), out.data_ptr(), conv.data_ptr(),
                p.data_ptr(), None if w is None else w.data_ptr(),
                None if q is None else q.data_ptr(), K, L, alpha, R, n,
                int(keep), torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"base_conv_launch failed: cudaError {e}")
        return launch
    ms = _kernel_ms([launcher(xi, out) for xi, out in pairs])
    if not torch.equal(pairs[0][1], got):
        raise AssertionError(f"base_conv {case}: raw launch differs")
    plain = _time_ms(lambda: base_conv_t(x, *args[:5], keep_own=keep), 2)
    nbytes = 4 * (x.numel() + got.numel()) + 8 * conv.numel()
    widths = [min(alpha, L - lo) for lo in range(0, L, alpha)]
    macs = K * n * sum(d * (R - u) for d, u in zip(widths, unused))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * macs / imad_rate * 1e3
    bound = max(bytes_ms, ops_ms)
    return {"case": case, "shape": list(x.shape), "out": list(got.shape),
            "keep_own": keep, "pre_scale": w is not None,
            "copies": copies, "ms": ms, "plain_ms": plain, "bytes": nbytes,
            "multiply_adds": macs,
            "kernel_multiply_adds": K * n * L * R - (
                K * n * sum(d * d for d in widths) if keep else 0),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "share": bound / ms, "max_abs_err": err}


def _check_ks(lib, P, l, tag, rng) -> dict:
    """One class of the key switch's second half on chain P at limb count
    l: ks_inner of random digits [ndig, l + special, n] with a random key
    as the context keeps it ([dnum, 2, nq + special, n]), read through
    the automorphism of rotation `tag` (none for "relin"), and
    moddown_tail of its q rows with random converted rows, each bit-equal
    to its plain version; then their times (raw launches into
    preallocated outputs, _kernel_ms), the plain versions' and the
    bounds: each input read once and each output written once over 3.35
    TB/s (for ks_inner the digits, the key's rows of the level, the
    permutation and the two outputs; for the tail two inputs and one
    output)."""
    from sorting_fhe_tpu_torch.core import cuda_keyswitch as ck
    from sorting_fhe_tpu_torch.core import encoding
    from sorting_fhe_tpu_torch.core.ckks import _LevelTables
    T = _LevelTables(P, l)
    n, E = P.n, l + T.ksp
    exts = _residues(rng, T.q_host + list(P.p_special), (T.ndig,), n,
                     P.device)
    key = _residues(rng, P.all_primes, (P.cfg.dnum, 2), n, P.device)
    perm = None if tag == "relin" else torch.from_numpy(
        encoding.automorphism_eval_perm(
            n, encoding.galois_element_for_rotation(n, tag)).astype(
                np.int64)).to(P.device)
    args = (T.ext_p, T.ext_rinv, l, T.nq, perm)
    q, sp = ck.ks_inner(exts, key, *args)
    wq, wsp = ck.ks_inner_t(exts, key, *args)
    conv = _residues(rng, T.q_host, (2,), n, P.device)
    tail = ck.moddown_tail(q, conv, T.q_p, T.md_pinv)
    want = ck.moddown_tail_t(q, conv, T.q_p, T.md_pinv)
    torch.cuda.synchronize()
    case = f"l={l}, digits {T.ndig} x {T.alpha}, key {tag}"
    for name, got, ref in (("ks_inner q", q, wq),
                           ("ks_inner special", sp, wsp),
                           ("moddown_tail", tail, want)):
        if not torch.equal(got, ref):
            err = int((got.long() - ref.long()).abs().max())
            raise AssertionError(f"{name} {case}: kernel != plain (max err "
                                 f"{err})")
    del wq, wsp, want
    in_bytes = 4 * exts.numel() + 8 * T.ndig * E * n
    out_bytes = 8 * E * n
    copies = min(8, -(-L2_BYTES // (in_bytes + out_bytes)))
    sets = [(exts if i == 0 else exts.clone(), torch.empty_like(q),
             torch.empty_like(sp)) for i in range(copies)]

    def inner(x, oq, osp):
        def launch():
            e = lib.ks_inner_launch(
                x.data_ptr(), key.data_ptr(), T.ext_p.data_ptr(),
                T.ext_rinv.data_ptr(), None if perm is None else
                perm.data_ptr(), oq.data_ptr(), osp.data_ptr(), T.ndig, E,
                l, T.nq, key.shape[2], n,
                torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"ks_inner_launch failed: cudaError {e}")
        return launch
    ks_ms = _kernel_ms([inner(*t) for t in sets])
    if not (torch.equal(sets[0][1], q) and torch.equal(sets[0][2], sp)):
        raise AssertionError(f"ks_inner {case}: raw launch differs")
    tails = [(q if i == 0 else q.clone(), torch.empty_like(q))
             for i in range(min(8, -(-L2_BYTES // (12 * q.numel()))))]

    def down(x, out):
        def launch():
            e = lib.moddown_tail_launch(
                x.data_ptr(), conv.data_ptr(), T.q_p.data_ptr(),
                T.md_pinv.data_ptr(), out.data_ptr(), 2, l, l, n,
                torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"moddown_tail_launch failed: cudaError "
                                   f"{e}")
        return launch
    tail_ms = _kernel_ms([down(*t) for t in tails])
    if not torch.equal(tails[0][1], tail):
        raise AssertionError(f"moddown_tail {case}: raw launch differs")
    ks_plain = _time_ms(lambda: ck.ks_inner_t(exts, key, *args), 2)
    tail_plain = _time_ms(lambda: ck.moddown_tail_t(q, conv, T.q_p,
                                                    T.md_pinv), 2)
    ks_bytes = in_bytes + out_bytes + (0 if perm is None else 8 * n)
    tail_bytes = 12 * q.numel()
    rows = {}
    for name, nbytes, ms, plain, runs in (
            ("ks_inner", ks_bytes, ks_ms, ks_plain, sets),
            ("moddown_tail", tail_bytes, tail_ms, tail_plain, tails)):
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"case": case, "digits": T.ndig, "ext_rows": E,
                      "automorphism": perm is not None, "ms": ms,
                      "plain_ms": plain, "bytes": nbytes, "bound_ms": bound,
                      "bound_by": "bytes", "share": bound / ms,
                      "copies": len(runs), "max_abs_err": 0}
    return rows


def _check_rescale(lib, P, l, rng) -> dict:
    """The composite rescale from limb count l of chain P (comp = 2), for
    2 and 3 polys of random residues: rescale_lift of the dropped rows
    bit-equal to rescale_lift_t, and the composed rescale
    (core/ckks._kj_rescale) bit-equal to the same steps' plain versions
    (ntt_inv_t, rescale_lift_t, ntt_fwd_t, moddown_tail_t) on the card.
    Then, for 2 polys, the lift's time (raw launches into a preallocated
    output, _kernel_ms), its plain version's, its bound (the dropped rows
    read and the kept rows written once over 3.35 TB/s) and the whole
    rescale's time (_time_ms: K2, the lift, K1, the tail, as the context
    issues them)."""
    from sorting_fhe_tpu_torch.core import cuda_keyswitch as ck
    from sorting_fhe_tpu_torch.core import cuda_rescale as cr
    from sorting_fhe_tpu_torch.core.ckks import _LevelTables, _kj_rescale
    from sorting_fhe_tpu_torch.core.ntt import ntt_fwd_t, ntt_inv_t
    T, n, comp, tabs = _LevelTables(P, l), P.n, P.comp, P.ntt
    lo = l - comp
    consts = cr.rescale_tables(P.q[lo:l][::-1], P.q[:lo], P.device)
    drop, keep, pinv = consts
    up = torch.arange(lo, l, device=P.device)
    down = torch.arange(lo, device=P.device)
    case = f"l={l}, comp={comp}"
    for k in (3, 2):
        x = _residues(rng, T.q_host, (k,), n, P.device)
        c = x[:, lo:].contiguous()
        lift = cr.rescale_lift(c, drop, keep)
        got = _kj_rescale(x, consts, T)
        coeffs = ntt_inv_t(c, tabs.p[up], tabs.ipsi[up], tabs.n_inv[up])
        want = ck.moddown_tail_t(
            x[:, :lo], ntt_fwd_t(cr.rescale_lift_t(coeffs, drop, keep),
                                 tabs.p[down], tabs.psi[down]),
            T.q_p[:lo], pinv)
        torch.cuda.synchronize()
        for name, a, b in (("rescale_lift", lift,
                            cr.rescale_lift_t(c, drop, keep)),
                           ("rescale", got, want)):
            if not torch.equal(a, b):
                err = int((a.long() - b.long()).abs().max())
                raise AssertionError(f"{name} {case}, k={k}: kernel != "
                                     f"plain (max err {err})")
        del want, coeffs
    out = torch.empty_like(lift)

    def launch():
        e = lib.rescale_lift_launch(
            c.data_ptr(), drop.data_ptr(), keep.data_ptr(), out.data_ptr(),
            2, comp, lo, n, torch.cuda.current_stream().cuda_stream)
        if e:
            raise RuntimeError(f"rescale_lift_launch failed: cudaError {e}")
    ms = _kernel_ms([launch])
    if not torch.equal(out, lift):
        raise AssertionError(f"rescale_lift {case}: raw launch differs")
    nbytes = 4 * 2 * (comp + lo) * n
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"case": case, "polys": 2, "ms": ms,
            "plain_ms": _time_ms(lambda: cr.rescale_lift_t(c, drop, keep),
                                 2),
            "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
            "share": bound / ms, "max_abs_err": 0,
            "rescale_ms": _time_ms(lambda: _kj_rescale(x, consts, T), 10)}


def _cli_config():
    """Step 6's chain: the registry's direct N=128 config at the depth the
    CLI's sign needs, through full_config (so dnum follows the port's
    one-bit-per-level rule)."""
    from sorting_fhe_tpu_torch.registry import get_params, full_config
    p = get_params(CLI_ALGO, CLI_N)
    return full_config(dataclasses.replace(
        p, mult_depth=p.mult_depth + CLI_EXTRA_DEPTH), ring_dim=1 << RING_LOG)


def _stream_config(**overrides):
    """Step 7b's chain: the registry's mehp24 N=512 config."""
    from sorting_fhe_tpu_torch.registry import get_params, full_config
    return full_config(get_params(STREAM_ALGO, STREAM_N),
                       ring_dim=1 << RING_LOG, **overrides)


def _mesh_config():
    """Step 8's chain (MESH_CFG at ring 2^RING_LOG)."""
    from sorting_fhe_tpu_torch.core.params import CkksConfig
    return CkksConfig(ring_dim=1 << RING_LOG, **MESH_CFG)


def _chain_configs() -> list:
    """(label, config) of every path's chain, in the order they run."""
    from sorting_fhe_tpu_torch.registry import get_params, full_config
    out = [(label, full_config(get_params(algo, N), ring_dim=1 << RING_LOG))
           for label, algo, N, _ in PATHS]
    chain = dict(out)
    return out + [(CLI_PATH, _cli_config()), (EXP_PATH, chain[EXP_CHAIN]),
                  (STREAM_PATH, _stream_config()),
                  (STREAM_MESH, _stream_config()),
                  (MESH_PATH, _mesh_config()),
                  (SHARD_PATH, chain[SHARD_CHAIN])] + [
                      (mesh, chain[label])
                      for label, mesh in BOOT_MESH.items()] + [
                      (R18_PATH, full_config(get_params(R18_ALGO, R18_N)))]


def check_kernels(device, int_rate: float, imad_rate: float,
                  prev) -> tuple[dict, list, list, list, list]:
    """Step 3: bit-equality and times of K1/K2 against the plain versions
    (and the earlier kernels, when built) on the chain of every path, of
    the base conversion on the chains of BASIS_CLASSES, of the key inner
    product and ModDown's tail on those of KS_CLASSES and of the
    composite rescale at the top level of RESCALE_CHAINS.  Returns, per
    path label, the row of its chain's largest class, the whole table,
    the base conversion's rows, the key switch's (one dict of the two
    kernels' rows per class) and the rescale's."""
    from sorting_fhe_tpu_torch.core.params import CkksParams

    rng = np.random.default_rng(17)
    lib = cuda_lib.build()
    chains = {}           # config -> (its first path, config, paths)
    for label, cfg in _chain_configs():
        chains.setdefault(repr(cfg), (label, cfg, []))[2].append(label)
    table, largest, basis, keyswitch, rescale = [], {}, [], [], []
    for label, cfg, paths in chains.values():
        P = CkksParams(cfg, device)
        for kind, l, slot, slots in BASIS_CLASSES.get(label, ()):
            row = _check_basis(lib, P, kind, l or P.nq, slot, slots, rng,
                               imad_rate)
            basis.append({"chain": label, **row})
        for l, tag in KS_CLASSES.get(label, ()):
            rows = _check_ks(lib, P, l or P.nq, tag, rng)
            keyswitch.append({k: {"chain": label, **v}
                              for k, v in rows.items()})
        if label in RESCALE_CHAINS:
            rescale.append({"chain": label,
                            **_check_rescale(lib, P, P.nq, rng)})
        for i, (name, sel, lead) in enumerate(_chain_classes(P, label)):
            row, e_f, e_i = _check_class(lib, prev, P, name, sel, lead, rng,
                                         int_rate)
            row["chain"] = " / ".join(paths)
            row["max_abs_err"] = {"ntt_fwd": e_f, "ntt_inv": e_i}
            table.append(row)
            if i == 0:
                largest.update({p: row for p in paths})
                if BOOT_CHAIN in paths:
                    largest[BOOT_PHASE] = row
            if label == STREAM_PATH and name.endswith("keygen"):
                largest[STREAM_KEYGEN] = row
            if name.endswith("slot 3 ext digits"):
                largest[SHARD_PATH] = row
            if name.endswith("slot 0 ext digits"):
                largest.update({p: row for p in paths
                                if p in BOOT_MESH.values()
                                or p == STREAM_MESH})
        del P
        gc.collect()
        torch.cuda.empty_cache()
    return largest, table, basis, keyswitch, rescale


def kernel_records(largest: dict, table: list, basis: list,
                   keyswitch: list, rescale: list, launches: dict,
                   ntt_rate: float) -> list:
    """The JSON record of K1 and K2: time, bound and launches on MAIN at
    top level, and the same for every path under "paths"; the launches
    of the micro table and of ntt_bench, and for K1 ntt_bench's limb
    transforms per second (`ntt_rate`).  Then the base conversion's: its
    time and bound at the top-level ModUp of the hybrid1 N=128 chain,
    every class checked under "classes", its launches on the hybrid1
    N=128 path and in the micro table.  Then the same for the key inner
    product and ModDown's tail, their time and bound at the hybrid1 N=128
    chain's top level (relinearisation), and their launches on every path
    and phase that key-switches; the same for the rescale's lift at the
    hybrid1 N=128 chain's top level, and its launches on every path."""
    recs = []
    for key, tag, label, line in (("ntt_fwd", "fwd", "ntt_fwd (K1)", 119),
                                  ("ntt_inv", "inv", "ntt_inv (K2)", 151)):
        def timing(row):
            t = row[tag]
            return {"shape": _shape_str(row["shape"]), "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"]}
        main = timing(largest[MAIN])
        # every class checked on the ring-2^18 chain, rescale's too
        r18 = [timing(row) for row in table if row["chain"] == R18_PATH]
        recs.append({
            "name": label, "route": "cuda",
            "source": "sorting_fhe_tpu_torch/csrc/ntt.cu",
            "replaces": f"sorting_fhe_tpu/core/pallas_ntt.py:{line}",
            "launches": launches[MAIN][key],
            "max_abs_err": max(r["max_abs_err"][key] for r in table),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "prev_ms": largest[MAIN][tag]["prev_ms"],
            "shape": main["shape"],
            "micro_launches": launches[MICRO_PATH][key],
            "ntt_bench_launches": launches[NTT_PATH][key],
            **({"ntt_bench_limb_transforms_per_s": ntt_rate}
               if key == "ntt_fwd" else {}),
            "paths": [{"path": p, "launches": launches[p][key],
                       **timing(largest[p]), **({"classes": r18}
                                                if p == R18_PATH else {})}
                      for p in [p for p, *_ in PATHS] + [
                          R18_PATH, BOOT_PHASE, CLI_PATH, EXP_PATH,
                          STREAM_PATH, STREAM_KEYGEN, STREAM_MESH, MESH_PATH,
                          SHARD_PATH, *BOOT_MESH.values()]]})
    top = basis[0]
    recs.append({
        "name": "base_conv", "route": "cuda",
        "source": "sorting_fhe_tpu_torch/csrc/basis.cu",
        "replaces": None, "launches": launches[MICRO_CHAIN]["base_conv"],
        "micro_launches": launches[MICRO_PATH]["base_conv"],
        "max_abs_err": max(r["max_abs_err"] for r in basis),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "shape": f"{top['chain']} {top['case']}",
        "classes": basis,
        "paths": [{"path": p, "launches": launches[p]["base_conv"]}
                  for p in [p for p, *_ in PATHS] + [
                      R18_PATH, BOOT_PHASE, CLI_PATH, EXP_PATH,
                      STREAM_PATH, STREAM_MESH, MESH_PATH, SHARD_PATH,
                      *BOOT_MESH.values()]]})
    for name in KS_KERNELS:
        rows = [r[name] for r in keyswitch]
        top = rows[0]
        recs.append({
            "name": name, "route": "cuda",
            "source": "sorting_fhe_tpu_torch/csrc/keyswitch.cu",
            "replaces": None, "launches": launches[MICRO_CHAIN][name],
            "micro_launches": launches[MICRO_PATH][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "shape": f"{top['chain']} {top['case']}",
            "classes": rows,
            "paths": [{"path": p, "launches": launches[p][name]}
                      for p in [p for p, *_ in PATHS] + [
                          R18_PATH, BOOT_PHASE, CLI_PATH, EXP_PATH,
                          STREAM_PATH, STREAM_MESH, MESH_PATH, SHARD_PATH,
                          *BOOT_MESH.values()]]})
    top = rescale[0]
    recs.append({
        "name": "rescale_lift", "route": "cuda",
        "source": "sorting_fhe_tpu_torch/csrc/rescale.cu",
        "replaces": None, "launches": launches[MICRO_CHAIN]["rescale_lift"],
        "micro_launches": launches[MICRO_PATH]["rescale_lift"],
        "max_abs_err": max(r["max_abs_err"] for r in rescale),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "shape": f"{top['chain']} {top['case']}",
        "classes": rescale,
        "paths": [{"path": p, "launches": launches[p]["rescale_lift"]}
                  for p in [p for p, *_ in PATHS] + [
                      R18_PATH, BOOT_PHASE, CLI_PATH, EXP_PATH,
                      STREAM_PATH, STREAM_MESH, SHARD_PATH,
                      *BOOT_MESH.values()]]})
    return recs


def _shape_str(shape) -> str:
    return "[" + ", ".join(str(d) for d in shape[:-1]) + \
        f", 2^{shape[-1].bit_length() - 1}]"


def run_path(label, algo, N, trials, device, keep: dict | None = None,
             ring_log: int = RING_LOG) -> tuple[dict, dict, dict]:
    """Step 4 for one path: its sort at ring 2^ring_log with the launch
    counters reset just before and read just after, the gates, and its
    printed record.  Returns the kernel launches of the run, the peak device
    memory of each phase (bench.sort_bench's device_mem) and the last
    trial's op census.  `keep` receives sort_bench's `keep` and the record
    ("rec"), for steps 4c, 4d and 10."""
    from sorting_fhe_tpu_torch import bench
    gc.collect()
    torch.cuda.empty_cache()
    cuda_lib.reset()
    rec = bench.sort_bench(algo, N, ring_log, trials=trials, device=device,
                           keep=keep)
    launches = _launch_counts()
    brief = {k: rec[k] for k in ("metric", "value", "trials", "max_err",
                                 "gate", "security_logqp", "security_ok",
                                 "device_mem", "resident_gb", "rot_keys",
                                 "phase_s", "op_census", "pt_encode",
                                 "kernel_launches", "bootstraps", "device")
             if k in rec}
    print(f"[sort {label}] " + json.dumps(brief), flush=True)
    peaks = {k: round(v["peak_gb"], 2) for k, v in rec["device_mem"].items()}
    print(f"[sort {label}] trials {rec['trials']} s, max_err "
          f"{rec['max_err']:.3e} (log2 "
          f"{np.log2(max(rec['max_err'], 1e-300)):.2f}), launches "
          f"{launches}, pt encodes {[e['count'] for e in rec['pt_encode']]}"
          f", keys {rec['rot_keys']} "
          f"({rec['resident_gb']['rot_keys_gb']:.2f} GB), peak GB {peaks}",
          flush=True)
    if label in BOOT_PATHS:
        for t, boots in enumerate(rec["bootstraps"]):
            print(f"[sort {label}] trial {t}: {len(boots)} bootstraps: " +
                  "; ".join(f"{b['s']:.3f}s limbs {b['limbs_in']}->"
                            f"{b['limbs_out']}" for b in boots), flush=True)
        if min(len(b) for b in rec["bootstraps"]) < 1:
            raise AssertionError(f"{label}: a trial ran no bootstrap")
    if not rec["gate"]["ok"]:
        raise AssertionError(f"{label}: sort outside its gate "
                             f"{rec['gate']} (max_err {rec['max_err']})")
    if not rec["security_ok"]:
        raise AssertionError(f"{label}: security check failed: {brief}")
    for name, count in launches.items():
        if count <= 0 or min(t[name] for t in rec["kernel_launches"]) <= 0:
            raise AssertionError(f"{label} never launched {name} "
                                 f"(per trial {rec['kernel_launches']})")
    lifts = [t["rescale_lift"] for t in rec["kernel_launches"]]
    rescales = [c.get("rescale", 0) for c in rec["op_census"]]
    print(f"[sort {label}] rescale_lift launches {lifts}, rescales "
          f"{rescales} per trial", flush=True)
    if lifts != rescales:
        raise AssertionError(f"{label}: rescale_lift launches {lifts} != "
                             f"rescales {rescales} per trial")
    if keep is not None:
        keep["rec"] = rec
    return launches, rec["device_mem"], rec["op_census"][-1]


def micro_phase(device, card: str, run: dict) -> tuple[dict, dict, float]:
    """Step 4c, on step 4's hybrid1 N=128 context (`run`: sort_bench's
    `keep`): bench.micro_bench at its top level (95 q rows) and then
    bench.ntt_bench(RING_LOG), the launch counters reset just before each
    and read just after.  Requires every value finite and > 0,
    rot_hoisted_1 within MICRO_HOIST_SLACK of rot_composed_1 (at one step
    the two do the same work), launches of the six kernels
    in the table and of K1 in ntt_bench.  Prints each on a line of its
    own with the card's name and power limit.  Returns both runs'
    launches and ntt_bench's rate."""
    from sorting_fhe_tpu_torch import bench

    ctx = run["ctx"]
    run.clear()
    ctx._pt_cache.clear()      # the sort's plaintexts: the table needs none
    ctx._pt_cache_bytes = 0
    gc.collect()
    cuda_lib.reset()
    t0 = time.perf_counter()
    micro = bench.micro_bench(ctx)
    micro_s, micro_launches = time.perf_counter() - t0, _launch_counts()
    print(f"[{MICRO_PATH}] " + json.dumps({
        "card": card, "limbs": ctx.params.nq,
        "special": ctx.params.num_special, "dnum": ctx.cfg.dnum,
        "micro": micro, "launches": micro_launches, "s": micro_s}),
        flush=True)
    print(f"[{MICRO_PATH}] rescale at l={ctx.params.nq}: "
          f"{micro['rescale_ms']} ms (the two-step int64 chain: "
          f"{RESCALE_CHAIN_MS} ms); card {card}", flush=True)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    cuda_lib.reset()
    t0 = time.perf_counter()
    ntt = bench.ntt_bench(RING_LOG, device)
    ntt_s, ntt_launches = time.perf_counter() - t0, _launch_counts()
    print(f"[{NTT_PATH}] " + json.dumps({
        "card": card, **ntt, "launches": ntt_launches, "s": ntt_s}),
        flush=True)
    bad = {k: v for k, v in {**micro, "ntt": ntt["value"]}.items()
           if not (np.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"{MICRO_PATH}: not finite and > 0: {bad}")
    if not micro["rot_hoisted_1_ms"] <= \
            micro["rot_composed_1_ms"] * MICRO_HOIST_SLACK:
        raise AssertionError(f"{MICRO_PATH}: rot_hoisted_1 "
                             f"{micro['rot_hoisted_1_ms']} ms over "
                             f"{MICRO_HOIST_SLACK} x rot_composed_1 "
                             f"{micro['rot_composed_1_ms']} ms")
    if min(micro_launches.values()) <= 0 or ntt_launches["ntt_fwd"] <= 0:
        raise AssertionError(f"{MICRO_PATH}: launches {micro_launches}, "
                             f"ntt_bench {ntt_launches}")
    return micro_launches, ntt_launches, ntt["value"]


def ring18_phase(device, card: str) -> dict:
    """Step 4d: the registry's hybrid1 N=1024 through bench.sort_bench at
    the ring of its registry entry, which must be 2^R18_RING_LOG (depth
    56 does not fit HEStd-128 at 2^17), with step 4's gates (run_path:
    max_err < 0.01, security_ok, launches of the six kernels).  Prints the
    chain, the rotation keys' shape and bytes, the plaintext cache's cap
    and entries after the sort, the card's name and power limit.  Returns
    the run's launches."""
    from sorting_fhe_tpu_torch.registry import get_params
    ring_log = get_params(R18_ALGO, R18_N).ring_dim_full.bit_length() - 1
    if ring_log != R18_RING_LOG:
        raise AssertionError(f"{R18_PATH}: the registry gives ring "
                             f"2^{ring_log}")
    kept = {}
    launches, _, _ = run_path(R18_PATH, R18_ALGO, R18_N, R18_TRIALS, device,
                              kept, ring_log=ring_log)
    ctx, rec = kept["ctx"], kept["rec"]
    P = ctx.params
    rots = sorted(ctx.rot_keys)
    key = ctx.rot_keys[rots[0]]
    print(f"[{R18_PATH}] " + json.dumps({
        "card": card, "chain": P.describe(), "ring_dim": P.n,
        "slots": kept["slots"], "depth": ctx.cfg.mult_depth, "nq": P.nq,
        "special": P.num_special, "dnum": ctx.cfg.dnum, "alpha": P.alpha,
        "logqp": rec["security_logqp"], "security_ok": rec["security_ok"],
        "rot_keys": rots,
        "key_shape": list(key.shape), "key_gb": key.nbytes / 1e9,
        "resident_gb": rec["resident_gb"],
        "pt_cache_cap_mb": ctx._pt_cache_cap >> 20,
        "pt_cache_entries": len(ctx._pt_cache)}), flush=True)
    kept.clear()
    del ctx, rec, key
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _storages(obj, device, skip: set, depth: int = 0) -> dict:
    """{storage address: bytes} of the tensors on `device` reachable from
    obj through dicts, lists, tuples, sets and object attributes, not
    entering the objects whose ids are in `skip`."""
    if isinstance(obj, torch.Tensor):
        if obj.device != device:
            return {}
        st = obj.untyped_storage()
        return {st.data_ptr(): st.nbytes()}
    if depth > 6 or id(obj) in skip:
        return {}
    skip.add(id(obj))
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return {}
    out = {}
    for x in items:
        out.update(_storages(x, device, skip, depth + 1))
    return out


def _live_tensors(device) -> dict:
    """{storage address: (bytes, weak reference to one of its tensors)}
    of every tensor on `device` that the garbage collector tracks."""
    live = {}
    with warnings.catch_warnings():    # isinstance on deprecated aliases
        warnings.simplefilter("ignore", FutureWarning)
        for o in gc.get_objects():
            if isinstance(o, torch.Tensor) and o.device == device:
                st = o.untyped_storage()
                live.setdefault(st.data_ptr(),
                                (st.nbytes(), weakref.ref(o)))
    return live


def cache_bytes(ctx, device, **holders) -> dict:
    """GB of device memory reachable from ctx's caches, each storage
    counted once, in the first part that reaches it: the rotation keys
    (pinned, LRU), the relinearisation and conjugation keys, the
    plaintext LRU's tensors, _tables, _perm_cache, _rs_cache, the
    params' tables, the keygen's, and `holders` (e.g. a Bootstrapper);
    then the GB allocated on the device, the GB that only reference
    cycles still hold (freed by a collection, which this runs), the GB
    of every tensor on the device that Python holds after it (a scan of
    the garbage collector's objects), and the five largest tensors that
    no part reaches, with the types of the objects that hold them."""
    parts = {"rot_keys_pinned": ctx.rot_keys._pinned,
             "rot_keys_lru": ctx.rot_keys._lru,
             "relin_conj": (ctx.relin_key, ctx.conj_key),
             "pt_cache": ctx._pt_cache, "tables": ctx._tables,
             "perm_cache": ctx._perm_cache, "rs_cache": ctx._rs_cache,
             "params": ctx.params, "keygen": ctx.keygen, **holders}
    counted, out = set(), {}
    for name, obj in parts.items():
        st = _storages(obj, device, {id(ctx)})
        out[name] = sum(b for p, b in st.items() if p not in counted) / 1e9
        counted |= st.keys()
    out["caches_gb"] = sum(out.values())
    cuda = device.type == "cuda"
    if cuda:
        out["allocated_gb"] = torch.cuda.memory_allocated(device) / 1e9
    # tensors held only by reference cycles that the collector has not
    # freed yet: what the scan finds before a collection and not after
    before = sum(b for b, _ in _live_tensors(device).values())
    gc.collect()
    live = _live_tensors(device)
    out["python_tensors_gb"] = sum(b for b, _ in live.values()) / 1e9
    out["cyclic_garbage_gb"] = before / 1e9 - out["python_tensors_gb"]
    if cuda:
        out["allocated_after_gc_gb"] = \
            torch.cuda.memory_allocated(device) / 1e9
    others = sorted((v for p, v in live.items() if p not in counted),
                    key=lambda v: -v[0])
    out["outside_caches_gb"] = sum(b for b, _ in others) / 1e9
    here, largest = sys._getframe(), []
    for b, ref in others[:5]:
        t = ref()
        if t is not None:
            largest.append({"gb": b / 1e9, "shape": list(t.shape),
                            "dtype": str(t.dtype), "held_by": sorted(
                                {type(r).__name__ for r in
                                 gc.get_referrers(t) if r is not here})})
        t = None
    out["largest_outside"] = largest
    return out


def bootstrap_phase(device) -> dict:
    """Step 4b: BOOT_ROUNDS bootstraps of one BOOT_SLOTS-slot ciphertext
    on BOOT_CHAIN's chain, with the launch counters reset just before and
    read just after.  Returns the kernel launches of the phase."""
    from sorting_fhe_tpu_torch.core.bootstrap import Bootstrapper
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.registry import get_params, full_config
    gc.collect()
    torch.cuda.empty_cache()
    algo, N = next((a, n) for lb, a, n, _ in PATHS if lb == BOOT_CHAIN)
    cfg = full_config(get_params(algo, N), ring_dim=1 << RING_LOG,
                      secret_hw=64)
    cuda_lib.reset()
    t0 = time.perf_counter()
    ctx = CkksContext(cfg, device=device)
    bs = Bootstrapper(ctx, BOOT_SLOTS).setup_keys()
    torch.cuda.synchronize()
    keys_gb = (ctx.rot_keys.resident_bytes + ctx.conj_key.nbytes
               + ctx.relin_key.nbytes) / 1e9
    print(f"[{BOOT_PHASE}] {ctx.params.describe()}; context and "
          f"{len(ctx.rot_keys)} rotation keys + conjugation key "
          f"({keys_gb:.2f} GB with relin) in "
          f"{time.perf_counter() - t0:.1f}s; raise to {bs.raise_limbs} "
          f"limbs, K {bs.K}, sine degree {bs._sine_deg}, BSGS {bs.G} x "
          f"{bs.n_giant}", flush=True)
    v = np.random.default_rng(5).uniform(-1, 1, BOOT_SLOTS)
    ct = ctx.level_reduce(ctx.encrypt(v, slots=BOOT_SLOTS), bs.raise_limbs)
    errs = []
    for i in range(BOOT_ROUNDS):
        enc0, enc_s0 = ctx.pt_encode_count, ctx.pt_encode_s
        ctx.op_counts.clear()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = bs.bootstrap(ct)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        err = float(np.abs(ctx.decrypt(out)[:BOOT_SLOTS] - v).max())
        errs.append(err)
        # live bytes (input and output ciphertexts, keys, caches) against
        # the allocator's peak: does what stays allocated grow?
        print(f"[{BOOT_PHASE}] " + json.dumps({
            "bootstrap": i + 1, "max_err": err,
            "log2_err": float(np.log2(max(err, 1e-300))), "s": dt,
            "phase_s": bs.phase_s, "limbs": [ct.limbs, out.limbs],
            "pt_encodes": ctx.pt_encode_count - enc0,
            "pt_encode_s": ctx.pt_encode_s - enc_s0,
            "op_census": dict(ctx.op_counts),
            "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "in_use_gb": torch.cuda.memory_allocated(device) / 1e9,
            "pt_cache_gb": ctx._pt_cache_bytes / 1e9}),
            flush=True)
        print(f"[{BOOT_PHASE}] caches after bootstrap {i + 1}: "
              + json.dumps(cache_bytes(ctx, device, bootstrapper=bs)),
              flush=True)
        ct = ctx.level_reduce(out, bs.raise_limbs)
    launches = _launch_counts()
    print(f"[{BOOT_PHASE}] errors {errs}, launches {launches}", flush=True)
    del ctx, bs, ct, out
    if not all(e < BOOT_GATE for e in errs):
        raise AssertionError(f"{BOOT_PHASE}: an error is not below "
                             f"{BOOT_GATE}: {errs}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{BOOT_PHASE} never launched a kernel: "
                             f"{launches}")
    return launches


def _npz_members(path) -> list:
    with np.load(path) as z:
        return list(z.files)


def cli_phase(device) -> dict:
    """Step 6: the client here (keys, files, encryption, decryption) and
    the server in a separate process through the CLI, with no secret
    key.  Returns the kernel launches of the server's sort, as it prints
    them."""
    from sorting_fhe_tpu_torch import serial
    from sorting_fhe_tpu_torch.bench import GATE
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.core.host_poly import sample_ternary
    from sorting_fhe_tpu_torch.models.direct_sort import DIRECT_SORT_ROTATIONS
    from sorting_fhe_tpu_torch.registry import security_check
    from sorting_fhe_tpu_torch.utils.memory import host_rss_gb
    from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff
    gc.collect()
    torch.cuda.empty_cache()
    # the client's secret comes from its seed: one the server cannot know
    cfg = dataclasses.replace(_cli_config(), seed=secrets.randbits(63))
    cuda_lib.reset()
    t0 = time.perf_counter()
    ctx = CkksContext(cfg, device=device)
    ctx.gen_rotation_keys(DIRECT_SORT_ROTATIONS[CLI_N])
    ctx.sync()
    logqp, limit, sec_ok = security_check(cfg, ctx.params)
    key_bytes = ctx.rot_keys.resident_bytes + ctx.relin_key.nbytes
    print(f"[{CLI_PATH}] client: {ctx.params.describe()}, depth "
          f"{cfg.mult_depth}, security logQP {logqp} <= {limit}: {sec_ok}; "
          f"{len(ctx.rot_keys)} rotation keys + relin "
          f"({key_bytes / 1e9:.3f} GB) in {time.perf_counter() - t0:.3f}s, "
          f"client launches {_launch_counts()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="cli_blind_sort_")
    try:
        print(f"[{CLI_PATH}] {tmp}: {shutil.disk_usage(tmp).free / 1e9:.2f}"
              f" GB free, host RSS before writing "
              f"{host_rss_gb():.2f} GB", flush=True)
        t0 = time.perf_counter()
        paths = serial.save_eval_material(tmp, ctx)
        write_s = time.perf_counter() - t0
        v = vector_with_min_diff(CLI_N, 0, 1, 1.0 / CLI_N,
                                 np.random.default_rng(CLI_SEED))
        ct_in = os.path.join(tmp, "in.npz")
        ct_out = os.path.join(tmp, "out.npz")
        serial.save_ciphertext(ct_in, ctx.encrypt(v, slots=CLI_N))
        sizes = {k: os.path.getsize(p) for k, p in paths.items()}
        print(f"[{CLI_PATH}] wrote {sum(sizes.values()) / 1e9:.3f} GB "
              f"({ {k: b / 1e9 for k, b in sizes.items()} } GB) in "
              f"{write_s:.3f}s ({sum(sizes.values()) / 1e9 / write_s:.3f} "
              f"GB/s); input ciphertext {os.path.getsize(ct_in) / 1e6:.3f}"
              f" MB", flush=True)
        members = {k: _npz_members(paths[k])
                   for k in ("key_pub", "key_mult", "key_rot")}
        if (sorted(members["key_pub"]) != ["a", "b"]
                or members["key_mult"] != ["k"]
                or not all(re.fullmatch(r"r\d+|conj", m)
                           for m in members["key_rot"])):
            raise AssertionError(f"{CLI_PATH}: unexpected members {members}")
        # a server that builds a client from the context file (as
        # KeyGenerator draws the secret) must not get the client's secret
        loaded = serial.load_config(paths["cc"])
        rebuilt = sample_ternary(loaded.ring_dim,
                                 np.random.default_rng(loaded.seed),
                                 loaded.secret_hw)
        if ("seed" in json.loads(Path(paths["cc"]).read_text())
                or np.array_equal(rebuilt, ctx.keygen.sk.s_coeffs)):
            raise AssertionError(f"{CLI_PATH}: the context file gives "
                                 "the client's secret away")
        print(f"[{CLI_PATH}] files: members {members}; the context file "
              f"names no seed, and a secret rebuilt from it differs from "
              f"the client's in "
              f"{int((rebuilt != ctx.keygen.sk.s_coeffs).sum())} of "
              f"{loaded.ring_dim} coefficients", flush=True)
        # the client keeps its secret; its keys leave the card
        ctx.rot_keys.clear()
        ctx.relin_key = None
        gc.collect()
        torch.cuda.empty_cache()

        cmd = [sys.executable, "-m", "sorting_fhe_tpu_torch",
               "--cc", paths["cc"], "--key_pub", paths["key_pub"],
               "--key_mult", paths["key_mult"], "--key_rot", paths["key_rot"],
               "--input", ct_in, "--output", ct_out,
               "--algo", CLI_ALGO, "--N", str(CLI_N)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S,
                             cwd=Path(__file__).resolve().parent)
        server_s = time.perf_counter() - t0
        for line in res.stderr.splitlines():
            print(f"[{CLI_PATH}] server: {line}", flush=True)
        if res.returncode != 0:
            raise AssertionError(f"{CLI_PATH}: the server exited "
                                 f"{res.returncode}")
        load = re.search(r"deserialized in ([\d.]+)s", res.stderr)
        sort = re.search(r"sort N=\d+: ([\d.]+)s \(mults=(\d+) rots=(\d+)\)"
                         r" launches ((?:\w+=\d+ )+)peak ([\d.]+) GB",
                         res.stderr)
        if load is None or sort is None:
            raise AssertionError(f"{CLI_PATH}: no timing lines from the "
                                 "server")
        t0 = time.perf_counter()
        out = serial.load_ciphertext(ct_out, device=device)
        read_s = time.perf_counter() - t0
        got = ctx.decrypt(out)[:CLI_N]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err = float(np.abs(got - np.sort(v)).max())
    spent = (ctx.params.nq - out.limbs) / ctx.params.comp
    launches = {k: int(c) for k, c in re.findall(r"(\w+)=(\d+)",
                                                  sort.group(4))}
    print(f"[{CLI_PATH}] " + json.dumps({
        "max_err": err, "log2_err": float(np.log2(max(err, 1e-300))),
        "gate": GATE, "security_logqp": logqp, "security_ok": sec_ok,
        "depth": cfg.mult_depth, "levels_spent": spent,
        "limbs_out": out.limbs, "server_s": server_s,
        "server_load_s": float(load.group(1)),
        "server_sort_s": float(sort.group(1)),
        "mults": int(sort.group(2)), "rots": int(sort.group(3)),
        "server_launches": launches,
        "server_sort_peak_gb": float(sort.group(5)), "files_bytes": sizes,
        "write_s": write_s, "output_read_s": read_s}), flush=True)
    if not err < GATE:
        raise AssertionError(f"{CLI_PATH}: max_err {err} not below {GATE}")
    if not sec_ok:
        raise AssertionError(f"{CLI_PATH}: logQP {logqp} over {limit}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{CLI_PATH}: the server's sort launched no "
                             f"kernel: {launches}")
    return launches


def experiments_phase(device, bench_mem: dict) -> dict:
    """Step 7: experiments.main in this process on the main path's chain.
    Prints its summary and each trial's device memory by phase beside
    bench.sort_bench's for the same cell (step 4).  Returns the kernel
    launches of the run."""
    from sorting_fhe_tpu_torch import experiments
    from sorting_fhe_tpu_torch.bench import GATE
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="experiments_")
    try:
        cuda_lib.reset()
        (trials,) = experiments.main([
            "--algo", EXP_ALGO, "--sizes", str(EXP_N), "--trials",
            str(EXP_TRIALS), "--ring", str(RING_LOG), "--reuse-context",
            "--outdir", tmp])
        launches = _launch_counts()
        summary = Path(tmp, f"N{EXP_N}_summary.txt").read_text()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for line in summary.splitlines():
        print(f"[{EXP_PATH}] summary: {line}", flush=True)
    gb = 2 ** 30 / 1e9           # the monitor's GiB -> GB
    for i, t in enumerate(trials):
        print(f"[{EXP_PATH}] trial {i + 1}: " + json.dumps({
            "exec_ms": t["exec_ms"], "setup_s": t["setup_s"],
            "max_err": t["max_err"], "mults": t["mults"], "rots": t["rots"],
            "device_gb": {k: t[k] * gb for k in t
                          if k.startswith("device_")},
            "host_gb": {k: t[k] for k in ("idle_gb", "setup_gb", "peak_gb",
                                          "average_gb")}}), flush=True)
    print(f"[{EXP_PATH}] sort_bench's device GB for the same cell (step 4): "
          + json.dumps({k: v["peak_gb"] for k, v in bench_mem.items()})
          + f"; launches {launches}", flush=True)
    bad = [t["max_err"] for t in trials if not t["max_err"] < GATE]
    if bad or len(trials) != EXP_TRIALS:
        raise AssertionError(f"{EXP_PATH}: max_err {bad} not below {GATE}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{EXP_PATH} never launched a kernel: "
                             f"{launches}")
    return launches


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _timed(fn, *args):
    """(fn(*args), seconds), every device synchronised before and after."""
    _sync_all()
    t0 = time.perf_counter()
    out = fn(*args)
    _sync_all()
    return out, time.perf_counter() - t0


def keygen_phase(device):
    """Step 7b (a): the device keygen on the mehp24 N=512 chain, for each
    rotation of STREAM_ROTS: a key made twice must be equal bit for bit,
    and the key of the same rotation under another seed must differ (its
    uniform halves); the device keygen's and the host keygen's seconds
    per key; a fresh ciphertext rotated with the streamed key and with
    the host key must both decrypt within STREAM_ROT_GATE of np.roll."""
    from sorting_fhe_tpu_torch.core import encoding
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    gc.collect()
    torch.cuda.empty_cache()
    cfg = _stream_config(rot_key_budget_mb=STREAM_BUDGET_MB)
    t0 = time.perf_counter()
    ctx = CkksContext(cfg, device=device)
    other = CkksContext(dataclasses.replace(cfg, seed=cfg.seed + 1),
                        device=device)
    torch.cuda.synchronize()
    print(f"[{STREAM_KEYGEN}] {ctx.params.describe()}; two contexts "
          f"(seeds {cfg.seed}, {cfg.seed + 1}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    slots = ctx.params.num_slots
    v = np.random.default_rng(9).uniform(-1, 1, slots)
    ct = ctx.encrypt(v, slots=slots)
    rows, k1 = [], 0
    for k in (r % slots for r in STREAM_ROTS):
        g = encoding.galois_element_for_rotation(ctx.n, k)
        n0 = cuda_lib.launches["ntt_fwd"]
        first, dev_s = _timed(ctx.keygen.gen_rotation_key_dev, g)
        again, dev2_s = _timed(ctx.keygen.gen_rotation_key_dev, g)
        k1 += cuda_lib.launches["ntt_fwd"] - n0
        seeded = other.keygen.gen_rotation_key_dev(g)
        host, host_s = _timed(ctx.keygen.gen_rotation_key, g)
        if not torch.equal(first, again):
            raise AssertionError(f"{STREAM_KEYGEN}: rotation {k}: the key "
                                 "made again differs")
        if torch.equal(first[:, 1], seeded[:, 1]):
            raise AssertionError(f"{STREAM_KEYGEN}: rotation {k}: another "
                                 "seed gives the same key")
        del again, seeded
        want = np.roll(v, -k)
        ctx.gen_rotation_keys([k])                 # registered only
        regens = ctx.rot_keys.regen_count
        err_dev = float(np.abs(ctx.decrypt(ctx.rotate(ct, k)) - want).max())
        if ctx.rot_keys.regen_count != regens + 1 or not torch.equal(
                ctx.rot_keys[k], first):
            raise AssertionError(f"{STREAM_KEYGEN}: rotation {k} did not "
                                 "go through the store's device key")
        ctx.rot_keys[k] = host                     # pinned for one rotation
        err_host = float(np.abs(ctx.decrypt(ctx.rotate(ct, k)) - want).max())
        rows.append({"rotation": k, "galois": g, "device_s": dev_s,
                     "device_again_s": dev2_s, "host_s": host_s,
                     "max_err_streamed": err_dev, "max_err_host": err_host,
                     "key_gb": first.nbytes / 1e9})
        del ctx.rot_keys[k], first, host
        print(f"[{STREAM_KEYGEN}] " + json.dumps(rows[-1]), flush=True)
    del ctx, other, ct
    print(f"[{STREAM_KEYGEN}] K1 launches of the device keygen: {k1} "
          f"({len(STREAM_ROTS) * 2} keys)", flush=True)
    bad = [r for r in rows if not max(r["max_err_streamed"],
                                      r["max_err_host"]) < STREAM_ROT_GATE]
    if bad:
        raise AssertionError(f"{STREAM_KEYGEN}: rotation error not below "
                             f"{STREAM_ROT_GATE}: {bad}")
    if k1 <= 0 and device.type == "cuda":
        raise AssertionError(f"{STREAM_KEYGEN}: the device keygen never "
                             "launched K1")


def stream_phase(device) -> tuple[dict, dict, dict]:
    """Step 7b (b): experiments.main for mehp24 N=512 (one trial, a fresh
    context) with SORTING_FHE_KEY_BUDGET_MB=STREAM_BUDGET_MB, with the
    launch counters reset just before and read just after, the context's
    key-store hook timed (device synchronised) and its caches' bytes read
    when the trial ends; then (c), stream_mesh_phase on that context and
    input, before the context is released.  Requires the 0.01 gate,
    HEStd-128, launches of the six kernels in the sort,
    more regenerations than keys and the keys' resident bytes within the
    budget.  Returns the kernel launches of the run, the K1 launches of
    its keygen and (c)'s."""
    from sorting_fhe_tpu_torch import experiments
    from sorting_fhe_tpu_torch.bench import GATE, KEY_BUDGET_ENV
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    gc.collect()
    torch.cuda.empty_cache()
    budget = STREAM_BUDGET_MB << 20
    hook = {"calls": 0, "s": 0.0, "ntt_fwd": 0, "resident_max": 0}
    kept = {}
    regen, release = CkksContext._regen_rot_key, experiments._release
    build_sorter = experiments.build_sorter

    def timed_regen(ctx, kk):
        # what the store holds when it asks for a key: within the budget,
        # the key in flight apart; a mesh's blocks only in the store
        held = ctx.rot_keys.resident_bytes
        hook["resident_max"] = max(hook["resident_max"], held)
        tables = getattr(ctx, "mesh_tables", None)
        if held > budget or (tables is not None and set(tables.keys) - {
                "relin", "conj"}):
            raise AssertionError(f"{STREAM_PATH}: at a regeneration the "
                                 f"store holds {held} B (budget {budget})"
                                 " or the mesh keeps a streamed key")
        n0 = cuda_lib.launches["ntt_fwd"]
        key, dt = _timed(regen, ctx, kk)
        hook["calls"] += 1
        hook["s"] += dt
        hook["ntt_fwd"] += cuda_lib.launches["ntt_fwd"] - n0
        return key

    def kept_sorter(ctx, algo, N, p, **kw):
        # the trial's sort, keeping its input and output for (c)
        sort_fn, slots, mode = build_sorter(ctx, algo, N, p, **kw)

        def sort(ct, sign):
            ctx.op_counts.clear()
            out = sort_fn(ct, sign)
            kept.update(ctx=ctx, ct=ct, out=out, sign=sign, params=p,
                        census=dict(ctx.op_counts))
            return out
        return sort, slots, mode

    def read_caches(ctx):
        hook["caches"] = cache_bytes(ctx, device)

    tmp = tempfile.mkdtemp(prefix="experiments_stream_")
    env = os.environ.get(KEY_BUDGET_ENV)
    os.environ[KEY_BUDGET_ENV] = str(STREAM_BUDGET_MB)
    CkksContext._regen_rot_key = timed_regen
    experiments._release = read_caches
    experiments.build_sorter = kept_sorter
    try:
        cuda_lib.reset()
        (trials,) = experiments.main([
            "--algo", STREAM_ALGO, "--sizes", str(STREAM_N), "--trials", "1",
            "--ring", str(RING_LOG), "--outdir", tmp,
            *(["--cpu"] if device.type == "cpu" else [])])
        launches = _launch_counts()
        (t,) = trials
        single = dict(hook)
        hook.update(calls=0, s=0.0, ntt_fwd=0, resident_max=0)
        mesh_launches = stream_mesh_phase(device, kept, t, single, hook)
    finally:
        CkksContext._regen_rot_key = regen
        experiments._release = release
        experiments.build_sorter = build_sorter
        if "ctx" in kept:
            release(kept["ctx"])
        kept.clear()
        if env is None:
            del os.environ[KEY_BUDGET_ENV]
        else:
            os.environ[KEY_BUDGET_ENV] = env
        shutil.rmtree(tmp, ignore_errors=True)
    gb = 2 ** 30 / 1e9           # the monitor's GiB -> GB
    sort_k1 = t["kernel_launches"]["ntt_fwd"] - single["ntt_fwd"]
    print(f"[{STREAM_PATH}] " + json.dumps({
        "setup_s": t["setup_s"], "exec_ms": t["exec_ms"],
        "max_err": t["max_err"],
        "log2_err": float(np.log2(max(t["max_err"], 1e-300))),
        "security_logqp": t["logqp"], "security_ok": t["sec_ok"],
        "mults": t["mults"], "rots": t["rots"], "rot_keys": t["rot_keys"],
        "key_budget_mb": t["key_budget_mb"], "regens": t["key_regens"],
        "regen_hook_calls": single["calls"], "regen_hook_s": single["s"],
        "keygen_ntt_fwd": single["ntt_fwd"],
        "sort_kernel_launches": t["kernel_launches"],
        "sort_ntt_fwd_without_keygen": sort_k1,
        "resident_key_gb": t["rot_keys_resident_bytes"] / 1e9,
        "resident_at_regen_max_gb": single["resident_max"] / 1e9,
        "budget_gb": budget / 1e9,
        "device_gb": {k: t[k] * gb for k in t if k.startswith("device_")},
        "allocated_after_sort_gb": t.get("device_end_gb", 0) * gb,
        "run_launches": launches}), flush=True)
    print(f"[{STREAM_PATH}] caches at the trial's end: "
          + json.dumps(single["caches"]), flush=True)
    if not t["max_err"] < GATE:
        raise AssertionError(f"{STREAM_PATH}: max_err {t['max_err']} not "
                             f"below {GATE}")
    if not t["sec_ok"]:
        raise AssertionError(f"{STREAM_PATH}: logQP {t['logqp']} over the "
                             "HEStd-128 limit")
    if device.type == "cuda" and (
            sort_k1 <= 0 or min(t["kernel_launches"].values()) <= 0):
        raise AssertionError(f"{STREAM_PATH}: the sort launched no kernel: "
                             f"{t['kernel_launches']}")
    if not t["key_regens"] > t["rot_keys"]:
        raise AssertionError(f"{STREAM_PATH}: {t['key_regens']} "
                             f"regenerations for {t['rot_keys']} keys")
    if not t["rot_keys_resident_bytes"] <= budget:
        raise AssertionError(f"{STREAM_PATH}: resident keys over budget")
    return launches, {"ntt_fwd": single["ntt_fwd"], "ntt_inv": 0}, \
        mesh_launches


def stream_mesh_phase(device, run: dict, trial: dict, single: dict,
                      hook: dict) -> dict:
    """Step 7b (c): 7b's streamed sort (`run`: its context, input, output,
    sign, params and census; `trial`: its experiments record; `single`:
    its key-store hook's totals) on shard_context(ctx, a virtual mesh of
    STREAM_MESH_SLOTS slots on `device`) under the same budget, its
    sorter from bench.build_sorter, the launch counters, the op census
    and the hook's totals (`hook`) reset just before it and read just
    after.  Requires torch.equal to the single-device output, the same
    census, the 0.01 gate, as many regenerations as the single-device
    sort, the store's bytes within the budget at every regeneration and
    at the end, no streamed key in the mesh's own blocks, and launches
    of the six kernels.  Prints both runs' seconds and
    their ratio, the regenerations and the seconds in the hook, and each
    peak.  Returns the kernel launches of the sharded sort."""
    from sorting_fhe_tpu_torch import bench
    from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
    from sorting_fhe_tpu_torch.parallel.mesh import make_mesh
    from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff
    ctx, ct, out, census = run["ctx"], run["ct"], run["out"], run["census"]
    store = ctx.rot_keys
    budget = STREAM_BUDGET_MB << 20
    # the trial's input (experiments.run_trial: seed 100 for trial 0)
    v = vector_with_min_diff(STREAM_N, 0, 1, 1.0 / STREAM_N,
                             np.random.default_rng(100))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    mesh = make_mesh(devices=[device] * STREAM_MESH_SLOTS)
    sctx = shard_context(ctx, mesh)
    sort_fn, _, _ = bench.build_sorter(sctx, STREAM_ALGO, STREAM_N,
                                       run["params"])
    sct = sctx.shard(ct)
    regens0 = store.regen_count
    sctx.sync()
    cuda_lib.reset()
    ctx.op_counts.clear()
    sout, secs = _timed(sort_fn, sct, run["sign"])
    launches = _launch_counts()
    regens = store.regen_count - regens0
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    equal = torch.equal(sout.gather(device).data, out.data)
    err = float(np.abs(sctx.decrypt(sout)[:STREAM_N] - np.sort(v)).max())
    streamed_blocks = sorted(str(t) for t in sctx.mesh_tables.keys
                             if t not in ("relin", "conj"))
    single_s = trial["exec_ms"] / 1e3
    gb = 2 ** 30 / 1e9
    print(f"[{STREAM_MESH}] " + json.dumps({
        "slots": mesh.size, "devices": [str(d) for d in mesh.devices],
        "blocks": [[hi - lo for lo, hi in sctx.mesh_tables.q_blocks],
                   [hi - lo for lo, hi in sctx.mesh_tables.sp_blocks]],
        "single_s": single_s, "mesh_s": secs, "ratio": secs / single_s,
        "bit_equal": equal, "census_equal": dict(ctx.op_counts) == census,
        "max_err": err, "log2_err": float(np.log2(max(err, 1e-300))),
        "regens": [trial["key_regens"], regens],
        "regen_hook_s": [single["s"], hook["s"]],
        "regen_hook_calls": [single["calls"], hook["calls"]],
        "keygen_ntt_fwd": hook["ntt_fwd"],
        "resident_at_regen_max_gb": [single["resident_max"] / 1e9,
                                     hook["resident_max"] / 1e9],
        "resident_key_gb": store.resident_bytes / 1e9,
        "budget_gb": budget / 1e9, "streamed_blocks_in_mesh":
        streamed_blocks,
        "peak_gb": [trial.get("device_peak_gb", 0) * gb, peak],
        "gathers": {t: dict(g) for t, g in mesh.gathers.items()},
        "launches": launches}), flush=True)
    if not equal:
        raise AssertionError(f"{STREAM_MESH}: sharded sort != single-device"
                             " sort")
    if dict(ctx.op_counts) != census:
        raise AssertionError(f"{STREAM_MESH}: census {dict(ctx.op_counts)}"
                             f" != {census}")
    if not err < bench.GATE:
        raise AssertionError(f"{STREAM_MESH}: max_err {err} not below "
                             f"{bench.GATE}")
    if regens != trial["key_regens"] or hook["calls"] != regens:
        raise AssertionError(f"{STREAM_MESH}: {regens} regenerations "
                             f"({hook['calls']} through the hook), "
                             f"{trial['key_regens']} on one device")
    if not store.resident_bytes <= budget or streamed_blocks:
        raise AssertionError(f"{STREAM_MESH}: {store.resident_bytes} B in "
                             f"the store (budget {budget}), streamed "
                             f"blocks kept by the mesh: {streamed_blocks}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{STREAM_MESH}: the sharded sort launched no"
                             f" kernel: {launches}")
    del sctx, sout, sct
    return launches


def _best_ms(fn, reps: int = MESH_REPS) -> float:
    """Best of `reps` host-clock times of fn(), the device synchronised
    before and after each, after one warm-up call."""
    fn()
    return min(_timed(fn)[1] for _ in range(reps)) * 1e3


def _mesh_ops(sk, ctx, a, b, device) -> tuple[dict, dict, tuple]:
    """Step 8's ops on mesh `sk` and their single-device counterparts on
    the same data: {name: mesh op}, {name: single-device op}, each
    returning its int32 data on `device`, and the product (sharded and
    gathered) that the "rotate product k" ops rotate.  Those rotations
    carry the decrypt gate: at scale 2^27 a fresh ciphertext's rotation
    keeps ModDown's rounding error, which a rescale divides by q."""
    from sorting_fhe_tpu_torch.core.ckks import _k_mult3
    from sorting_fhe_tpu_torch.parallel.mesh import shard_ciphertext
    sa, sb = shard_ciphertext(a, sk.mesh), shard_ciphertext(b, sk.mesh)
    sm = sk.mult_relin(sa, sb)
    m = sm.gather(device)
    T = ctx.tables(a.limbs)
    mesh = {"mult_relin": lambda: sk.mult_relin(sa, sb).gather(device).data}
    single = {"mult_relin": lambda: ctx._relin(_k_mult3(
        a.data, b.data, T.q_p, T.q_rinv), a.limbs)}
    for k in MESH_ROTS:
        mesh[f"rotate {k}"] = lambda k=k: sk.rotate(sa, k).gather(device).data
        single[f"rotate {k}"] = lambda k=k: ctx.rotate(a, k).data
        mesh[f"rotate product {k}"] = \
            lambda k=k: sk.rotate(sm, k).gather(device).data
        single[f"rotate product {k}"] = lambda k=k: ctx.rotate(m, k).data
    return mesh, single, m


def mesh_phase(device, census: dict) -> dict:
    """Step 8: parallel/'s ShardedKeyswitch on a virtual mesh of
    MESH_SLOTS slots on `device`, at ring 2^RING_LOG on MESH_CFG's chain,
    with the launch counters reset just before its ops and read just
    after.  Requires HEStd-128; mult_relin, rotate(k) and the product's
    rotate(k) for k in MESH_ROTS torch.equal to the single-device ops;
    the product and its rotations, rescaled and decrypted, within
    MESH_GATE of v*w and np.roll(v*w, -k) (the fresh rotations' error is
    printed, not gated: see _mesh_ops); exactly two gathers per op, of (D-1)/D of the [lq, n] digit
    residues and of the [2, ksp, n] special residues; launches of the
    five kernels that key-switch (KS_PATH_KERNELS: the ops do not
    rescale).  Prints each op's launches, its
    best-of-MESH_REPS ms against the single-device op, the step's peak
    device memory and comm_budget of `census`; on two cards or more, the
    same ops on a mesh of distinct cards.  Returns the kernel launches of
    the ops."""
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.parallel.collective import ShardedKeyswitch
    from sorting_fhe_tpu_torch.parallel.mesh import (make_mesh,
                                                     shard_context_tables)
    from sorting_fhe_tpu_torch.registry import security_check
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cfg = _mesh_config()
    t0 = time.perf_counter()
    ctx = CkksContext(cfg, device=device)
    ctx.gen_rotation_keys(list(MESH_ROTS))
    ctx.sync()
    logqp, limit, sec_ok = security_check(cfg, ctx.params)
    P = ctx.params
    print(f"[{MESH_PATH}] {P.describe()}, security logQP {logqp} <= {limit}"
          f": {sec_ok}; relin + {len(ctx.rot_keys)} rotation keys "
          f"({(ctx.relin_key.nbytes + ctx.rot_keys.resident_bytes) / 1e9:.3f}"
          f" GB) in {time.perf_counter() - t0:.1f}s", flush=True)
    if not sec_ok:
        raise AssertionError(f"{MESH_PATH}: logQP {logqp} over {limit}")
    rng = np.random.default_rng(8)
    v, w = rng.uniform(-1, 1, MESH_N), rng.uniform(-1, 1, MESH_N)
    a, b = ctx.encrypt(v, slots=MESH_N), ctx.encrypt(w, slots=MESH_N)
    mesh = make_mesh(devices=[device] * MESH_SLOTS)
    t0 = time.perf_counter()
    shard_context_tables(ctx, mesh)
    sk = ShardedKeyswitch(ctx, mesh)
    ctx.sync()
    place_s = time.perf_counter() - t0
    mesh_ops, single_ops, m = _mesh_ops(sk, ctx, a, b, device)

    # the counted run: every op once, launches per op
    cuda_lib.reset()
    mesh.gather_log.clear()
    outs, per_op = {}, {}
    for name, op in mesh_ops.items():
        before = _launch_counts()
        outs[name] = op()
        per_op[name] = {k: v - before[k]
                        for k, v in _launch_counts().items()}
    torch.cuda.synchronize()
    launches = _launch_counts()
    log = [(g["tag"], g["bytes_per_slot"]) for g in mesh.gather_log]
    D, n = mesh.size, P.n
    want = {"digit": (D - 1) * P.nq * n * 4 // D,
            "moddown": (D - 1) * 2 * P.num_special * n * 4 // D}
    cb = sk.collective_bytes(k=2)

    equal = {name: torch.equal(out, single_ops[name]())
             for name, out in outs.items()}

    def err(name, like, want):
        """Decrypted error of outs[name], with like's metadata; a product
        (noise degree 2) is rescaled first."""
        ct = dataclasses.replace(like, data=outs[name])
        ct = ctx.rescale(ct) if ct.noise_deg == 2 else ct
        return float(np.abs(ctx.decrypt(ct)[:MESH_N] - want).max())

    errs = {"mult_relin": err("mult_relin", m, v * w)}
    fresh = {}
    for k in MESH_ROTS:
        errs[f"rotate product {k}"] = err(f"rotate product {k}", m,
                                          np.roll(v * w, -k))
        fresh[f"rotate {k}"] = err(f"rotate {k}", a, np.roll(v, -k))
    times = {name: {"mesh_ms": _best_ms(mesh_ops[name]),
                    "single_ms": _best_ms(single_ops[name])}
             for name in mesh_ops if not name.startswith("rotate product")}
    print(f"[{MESH_PATH}] " + json.dumps({
        "slots": D, "devices": [str(d) for d in mesh.devices],
        "limbs": P.nq, "special": P.num_special, "dnum": cfg.dnum,
        "block_rows": [P.nq // D, P.num_special // D],
        "place_s": place_s, "bit_equal": equal, "max_err": errs,
        "fresh_rotation_err": fresh, "gathers": log,
        "collective_bytes": cb, "launches": per_op,
        "launches_total": launches, "times": times,
        "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "comm_budget": {MESH_CENSUS: census,
                        "budget": sk.comm_budget(census)}}), flush=True)
    if not all(equal.values()):
        raise AssertionError(f"{MESH_PATH}: mesh op != single-device op: "
                             f"{equal}")
    if not all(e < MESH_GATE for e in errs.values()):
        raise AssertionError(f"{MESH_PATH}: decrypted error not below "
                             f"{MESH_GATE}: {errs}")
    if (log != [("digit", want["digit"]), ("moddown", want["moddown"])]
            * len(mesh_ops) or (cb["digit_allgather_B"],
                                cb["moddown_allgather_B"])
            != (want["digit"], want["moddown"])):
        raise AssertionError(f"{MESH_PATH}: gathers {log}, collective_bytes "
                             f"{cb}, expected 2 per op of {want}")
    if min(launches[k] for k in KS_PATH_KERNELS) <= 0:
        raise AssertionError(f"{MESH_PATH}: the mesh ops launched no "
                             f"kernel: {launches}")
    mesh_cards(ctx, a, b, device)
    del ctx, sk, outs, m
    return launches


def mesh_cards(ctx, a, b, device):
    """Step 8 on a mesh of distinct cards, where there are two or more:
    the most that divides both the q and the special rows.  The same ops
    must be torch.equal to the single-device ones; prints their times."""
    from sorting_fhe_tpu_torch.parallel.collective import ShardedKeyswitch
    from sorting_fhe_tpu_torch.parallel.mesh import make_mesh
    P, cards = ctx.params, torch.cuda.device_count()
    sizes = [d for d in range(2, cards + 1)
             if P.nq % d == 0 and P.num_special % d == 0]
    if not sizes:
        print(f"[{MESH_PATH}] real-device mesh not run: {cards} card(s)",
              flush=True)
        return
    mesh = make_mesh(max(sizes))
    sk = ShardedKeyswitch(ctx, mesh)
    mesh_ops, single_ops, _ = _mesh_ops(sk, ctx, a, b, device)
    equal = {name: torch.equal(op(), single_ops[name]())
             for name, op in mesh_ops.items()}
    times = {name: {"mesh_ms": _best_ms(op)} for name, op in mesh_ops.items()}
    print(f"[{MESH_PATH}] cards: " + json.dumps({
        "devices": [str(d) for d in mesh.devices], "bit_equal": equal,
        "times": times}), flush=True)
    if not all(equal.values()):
        raise AssertionError(f"{MESH_PATH}: card mesh op != single-device "
                             f"op: {equal}")


def _census_gathers(census: dict, boots: int = 0) -> dict:
    """The gathers per tag that an op census implies: a digit gather per
    key switch that decomposes (hoisted rotations share their
    decompose's; conjugations count as rotate_fused), a ModDown gather
    per key switch, a rescale gather per rescale and, with `boots`
    bootstraps, a raise gather per bootstrap."""
    ks = sum(census.get(op, 0) for op in ("mult_relin", "square_relin",
                                          "rotate_fused", "fast_rotate"))
    want = {"digit": ks - census.get("fast_rotate", 0)
            + census.get("decompose", 0), "moddown": ks,
            "rescale": census.get("rescale", 0)}
    return {**want, "raise": boots} if boots else want


def _balance(sctx, mesh) -> tuple[dict, float]:
    """The q rows each slot held at each level the run reached, and the
    slowest slot's q rows over a balanced share, summed over the digit
    gathers (one per key switch that decomposes)."""
    levels = sorted(sctx.mesh_tables._levels, reverse=True)
    digit_rows = [g["shape"][0] for g in mesh.gather_log
                  if g["tag"] == "digit"]
    imbalance = sum(max(sctx.occupancy(l)) for l in digit_rows) / \
        sum(l / mesh.size for l in digit_rows)
    return {l: sctx.occupancy(l) for l in levels}, imbalance


def _sharded_sort(ctx, ds_cls, ct, sign, mesh) -> tuple:
    """hybrid1 on shard_context(ctx, mesh), the op census and the mesh's
    gathers reset just before: (sharded output, seconds, census, sharded
    context)."""
    from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
    sctx = shard_context(ctx, mesh)
    ds = ds_cls(sctx, SHARD_N, use_minimal_keys=True)
    sct = sctx.shard(ct)
    sctx.sync()
    ctx.op_counts.clear()
    mesh.clear_gathers()
    out, secs = _timed(ds.sort_hybrid1, sct, sign)
    return out, secs, dict(ctx.op_counts), sctx


def sharded_phase(device) -> dict:
    """Step 9: the main path's hybrid1 N=128 sort (a) on one device and
    (b) unchanged on the row-sharded evaluator over SHARD_SLOTS virtual
    slots on `device`, with the launch counters reset just before (b)
    and read just after; (c) on up to 4 distinct cards where there are
    two or more.  Requires HEStd-128, (b) and (c) torch.equal to (a),
    the same op census, max_err < GATE, launches of the six kernels in
    (b), the gathers per tag that the census implies and
    their bytes within comm_budget.  Returns the kernel launches of
    (b)."""
    from sorting_fhe_tpu_torch.bench import GATE
    from sorting_fhe_tpu_torch.core.ckks import CkksContext
    from sorting_fhe_tpu_torch.models.direct_sort import DirectSort
    from sorting_fhe_tpu_torch.parallel.collective import comm_budget
    from sorting_fhe_tpu_torch.parallel.mesh import make_mesh
    from sorting_fhe_tpu_torch.registry import (full_config, get_params,
                                                security_check)
    from sorting_fhe_tpu_torch.utils.testvec import vector_with_min_diff
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    p = get_params(SHARD_ALGO, SHARD_N)
    cfg = full_config(p, ring_dim=1 << RING_LOG)
    t0 = time.perf_counter()
    ctx = CkksContext(cfg, device=device)
    ds = DirectSort(ctx, SHARD_N, use_minimal_keys=True)
    ctx.sync()
    logqp, limit, sec_ok = security_check(cfg, ctx.params)
    P = ctx.params
    print(f"[{SHARD_PATH}] {P.describe()}, security logQP {logqp} <= "
          f"{limit}: {sec_ok}; relin + {len(ctx.rot_keys)} rotation keys in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not sec_ok:
        raise AssertionError(f"{SHARD_PATH}: logQP {logqp} over {limit}")
    v = vector_with_min_diff(SHARD_N, 0, 1, 1.0 / SHARD_N,
                             np.random.default_rng(SHARD_SEED))
    ct = ctx.encrypt(v, slots=SHARD_N)
    sign = p.sign_config()

    ctx.op_counts.clear()                                   # (a)
    out, single_s = _timed(ds.sort_hybrid1, ct, sign)
    census = dict(ctx.op_counts)
    mesh = make_mesh(devices=[device] * SHARD_SLOTS)        # (b)
    cuda_lib.reset()
    sout, mesh_s, mesh_census, sctx = _sharded_sort(ctx, DirectSort, ct,
                                                    sign, mesh)
    launches = _launch_counts()
    equal = torch.equal(sout.gather(device).data, out.data)
    err = float(np.abs(sctx.decrypt(sout)[:SHARD_N] - np.sort(v)).max())
    gathers = {t: dict(g) for t, g in mesh.gathers.items()}
    want = _census_gathers(census)
    budget = comm_budget(census, P.n, mesh.size, P.nq, P.num_special)
    moved = sum(g["bytes_per_slot"] for g in gathers.values())
    occupancy, imbalance = _balance(sctx, mesh)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[{SHARD_PATH}] " + json.dumps({
        "slots": mesh.size, "devices": [str(d) for d in mesh.devices],
        "limbs": P.nq, "special": P.num_special, "dnum": cfg.dnum,
        "single_s": single_s, "mesh_s": mesh_s,
        "ratio": mesh_s / single_s, "bit_equal": equal, "max_err": err,
        "log2_err": float(np.log2(max(err, 1e-300))),
        "census_equal": mesh_census == census, "census": census,
        "gathers": gathers, "gathers_want": want,
        "gathered_bytes_per_slot": moved, "comm_budget": budget,
        "launches": launches, "peak_gb": peak,
        "levels_out": [out.limbs, sout.limbs],
        "slowest_slot_over_balanced": imbalance,
        "occupancy": occupancy}), flush=True)
    if not equal:
        raise AssertionError(f"{SHARD_PATH}: sharded sort != single-device "
                             "sort")
    if mesh_census != census:
        raise AssertionError(f"{SHARD_PATH}: census {mesh_census} != "
                             f"{census}")
    if not err < GATE:
        raise AssertionError(f"{SHARD_PATH}: max_err {err} not below {GATE}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"{SHARD_PATH}: the sharded sort launched no "
                             f"kernel: {launches}")
    if {t: g["count"] for t, g in gathers.items()} != want:
        raise AssertionError(f"{SHARD_PATH}: gathers {gathers}, the census "
                             f"implies {want}")
    if not moved <= budget["total_receive_B"]:
        raise AssertionError(f"{SHARD_PATH}: {moved} B per slot over the "
                             f"budget {budget}")
    del sctx, sout
    cards = torch.cuda.device_count()
    if cards < 2:                                           # (c)
        print(f"[{SHARD_PATH}] real-device mesh not run: {cards} card(s)",
              flush=True)
    else:
        mesh = make_mesh(min(cards, SHARD_SLOTS))
        cout, cards_s, cards_census, _ = _sharded_sort(ctx, DirectSort, ct,
                                                       sign, mesh)
        equal = torch.equal(cout.gather(device).data, out.data)
        print(f"[{SHARD_PATH}] cards: " + json.dumps({
            "devices": [str(d) for d in mesh.devices], "s": cards_s,
            "bit_equal": equal, "census_equal": cards_census == census}),
            flush=True)
        if not equal or cards_census != census:
            raise AssertionError(f"{SHARD_PATH}: card mesh sort != "
                                 "single-device sort")
    del ctx, ds, out
    return launches


def _boot_mesh_sort(ctx, algo, N, p, ct, sign, mesh) -> dict:
    """The (algo, N) sort built by bench.build_sorter on shard_context(ctx,
    mesh) with a counting BootstrapHook of its own, the launch counters,
    the op census, the mesh's gathers and the hook's calls reset just
    before the sort: its output, seconds, census, hook and kernel
    launches, and the sharded context."""
    from sorting_fhe_tpu_torch import bench
    from sorting_fhe_tpu_torch.core.bootstrap import BootstrapHook
    from sorting_fhe_tpu_torch.parallel.evaluator import shard_context
    sctx = shard_context(ctx, mesh)
    hook = bench.TimedHook(BootstrapHook(sctx))
    sort_fn, _, _ = bench.build_sorter(sctx, algo, N, p, hook=hook)
    sct = sctx.shard(ct)
    sctx.sync()
    cuda_lib.reset()
    ctx.op_counts.clear()
    mesh.clear_gathers()
    hook.calls = []
    out, secs = _timed(sort_fn, sct, sign)
    return {"out": out, "s": secs, "census": dict(ctx.op_counts),
            "hook": hook, "sctx": sctx, "launches": _launch_counts()}


def boot_mesh_phase(device, label: str, run: dict) -> dict:
    """Step 10 for step 4's bootstrapping sort `label`, on what its step-4
    run kept (`run`: bench.sort_bench's `keep` and its record, "rec"):
    (a) is that run's first trial on one device; (b) the same call, its
    sorter built by bench.build_sorter, on the row-sharded evaluator over
    BOOT_MESH_SLOTS virtual slots on `device`, on the same context and
    input, after what (a) no longer needs is released; (c) on up to 4
    distinct cards where there are two or more.  Requires (b), and (c)
    where it runs, torch.equal to (a)'s output; (a)'s op census; step 4's
    gate; as many bootstraps as (a), at least one; the gathers per tag
    that the census and the bootstraps imply; their bytes per slot within
    comm_budget of the census plus the raise gathers' own, which
    comm_budget does not count; launches of the six kernels in (b).
    Returns the kernel launches of (b)."""
    from sorting_fhe_tpu_torch import bench
    from sorting_fhe_tpu_torch.parallel.collective import comm_budget
    from sorting_fhe_tpu_torch.parallel.mesh import make_mesh
    name = BOOT_MESH[label]
    algo, N = next((a, n) for lb, a, n, _ in PATHS if lb == label)
    ctx, ct, out, v = run["ctx"], run["ct"], run["out"], run["values"]
    p, sign, slots, rec = run["params"], run["sign"], run["slots"], run["rec"]
    single_s, census = rec["trials"][0], rec["op_census"][0]
    single_boots = rec["bootstraps"][0]
    a_peak = rec["device_mem"]["sort"]["peak_gb"]
    P, cfg = ctx.params, ctx.cfg
    ctx._pt_cache.clear()      # (a)'s plaintexts: (b) encodes its own
    ctx._pt_cache_bytes = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    mesh = make_mesh(devices=[device] * BOOT_MESH_SLOTS)    # (b)
    b = _boot_mesh_sort(ctx, algo, N, p, ct, sign, mesh)
    sctx, sout, boots = b["sctx"], b["out"], b["hook"].calls
    equal = torch.equal(sout.gather(device).data, out.data)
    err = np.abs(sctx.decrypt(sout)[:N] - np.sort(v))
    if algo == "bitonic":
        gate = {"max_err_below": bench.BITONIC_GATE[0],
                "slot_err_above": bench.BITONIC_GATE[1],
                "slots_above": int((err > bench.BITONIC_GATE[1]).sum())}
        gate["ok"] = bool(err.max() < gate["max_err_below"]
                          and gate["slots_above"] == 0)
    else:
        gate = {"max_err_below": bench.GATE,
                "ok": bool(err.max() < bench.GATE)}
    D = mesh.size
    gathers = {t: dict(g) for t, g in mesh.gathers.items()}
    want = _census_gathers(census, len(boots))
    l0 = b["hook"].setup(slots).raise_limbs
    raise_bytes = len(boots) * ((D - 1) * 2 * l0 * P.n * 4 // D)
    budget = comm_budget(census, P.n, D, P.nq, P.num_special)
    moved = sum(g["bytes_per_slot"] for g in gathers.values())
    occupancy, imbalance = _balance(sctx, mesh)
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[{name}] " + json.dumps({
        "slots": D, "devices": [str(d) for d in mesh.devices],
        "limbs": P.nq, "special": P.num_special, "dnum": cfg.dnum,
        "blocks": [[hi - lo for lo, hi in sctx.mesh_tables.q_blocks],
                   [hi - lo for lo, hi in sctx.mesh_tables.sp_blocks]],
        "single_s": single_s, "mesh_s": b["s"], "ratio": b["s"] / single_s,
        "bit_equal": equal, "max_err": float(err.max()),
        "log2_err": float(np.log2(max(err.max(), 1e-300))), "gate": gate,
        "census_equal": b["census"] == census, "census": census,
        "bootstraps": [len(single_boots), len(boots)],
        "bootstrap_phase_s": [
            {"limbs": [m["limbs_in"], m["limbs_out"]], "single_s": a["s"],
             "mesh_s": m["s"], "single": a["phase_s"], "mesh": m["phase_s"]}
            for a, m in zip(single_boots, boots)],
        "gathers": gathers, "gathers_want": want,
        "raise_bytes_want": raise_bytes,
        "gathered_bytes_per_slot": moved, "comm_budget": budget,
        "launches": b["launches"], "peak_gb": peak,
        "single_peak_gb": a_peak, "levels_out": [out.limbs, sout.limbs],
        "slowest_slot_over_balanced": imbalance,
        "occupancy": occupancy}), flush=True)
    if not equal:
        raise AssertionError(f"{name}: sharded sort != single-device sort")
    if b["census"] != census:
        raise AssertionError(f"{name}: census {b['census']} != {census}")
    if not gate["ok"]:
        raise AssertionError(f"{name}: outside its gate {gate}")
    if not boots or len(boots) != len(single_boots):
        raise AssertionError(f"{name}: bootstraps {len(boots)} on the mesh,"
                             f" {len(single_boots)} on one device")
    if {t: g["count"] for t, g in gathers.items()} != want:
        raise AssertionError(f"{name}: gathers {gathers}, the census and "
                             f"the bootstraps imply {want}")
    if gathers["raise"]["bytes_per_slot"] != raise_bytes:
        raise AssertionError(f"{name}: raise gathers moved "
                             f"{gathers['raise']} B per slot, not "
                             f"{raise_bytes}")
    if not moved <= budget["total_receive_B"] + raise_bytes:
        raise AssertionError(f"{name}: {moved} B per slot over the budget "
                             f"{budget} + {raise_bytes} B of raises")
    launches = b["launches"]
    del b, sctx, sout
    cards = torch.cuda.device_count()
    if cards < 2:                                           # (c)
        print(f"[{name}] real-device mesh not run: {cards} card(s)",
              flush=True)
    else:
        c = _boot_mesh_sort(ctx, algo, N, p, ct, sign,
                            make_mesh(min(cards, BOOT_MESH_SLOTS)))
        equal = torch.equal(c["out"].gather(device).data, out.data)
        print(f"[{name}] cards: " + json.dumps({
            "devices": [str(d) for d in c["sctx"].mesh.devices],
            "s": c["s"], "bit_equal": equal,
            "census_equal": c["census"] == census}), flush=True)
        if not equal or c["census"] != census:
            raise AssertionError(f"{name}: card mesh sort != single-device "
                                 "sort")
        del c
    run.clear()
    del ctx, out, ct
    if min(launches.values()) <= 0:
        raise AssertionError(f"{name}: the sharded sort launched no kernel:"
                             f" {launches}")
    return launches


def main() -> int:
    print(f"python {platform.python_version()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke run needs the GPU)",
              file=sys.stderr, flush=True)
        return 1
    card = _nvidia_smi()
    clock_mhz = _nvidia_smi_clock_mhz()
    int_rate = ISSUE_PER_CLOCK * clock_mhz * 1e6
    imad_rate = IMAD_PER_CLOCK * clock_mhz * 1e6
    print(f"card: {card}; max SM clock {clock_mhz} MHz; torch sees "
          f"{torch.cuda.device_count()} device(s): "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    device = torch.device("cuda:0")

    t_start = time.perf_counter()

    # 2. build (the earlier kernels' nvcc runs alongside)
    t0 = time.perf_counter()
    started = _start_prev_build()
    cuda_lib.build()
    prev = _load_prev(started)
    print(f"[build] {cuda_lib.build_info['path']} in "
          f"{time.perf_counter() - t0:.2f}s; earlier kernels: "
          f"{'built' if prev else 'absent'}", flush=True)
    for line in cuda_lib.build_info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 3. kernels vs plain versions on the card, on every path's chain
    largest, table, basis, keyswitch, rescale = check_kernels(
        device, int_rate, imad_rate, prev)
    for row in table:
        print("[kernel] " + json.dumps(row), flush=True)
    for row in basis:
        print("[kernel base_conv] " + json.dumps(row), flush=True)
    for rows in keyswitch:
        for name, row in rows.items():
            print(f"[kernel {name}] " + json.dumps(row), flush=True)
    for row in rescale:
        print("[kernel rescale_lift] " + json.dumps(row), flush=True)
    print(f"[time] kernels checked at {time.perf_counter() - t_start:.1f}s",
          flush=True)

    # 4. the sorts, counting launches path by path
    launches, mems, census = {}, {}, {}
    for label, algo, N, trials in PATHS:
        kept = {} if label in BOOT_MESH or label == MICRO_CHAIN else None
        launches[label], mems[label], census[label] = run_path(
            label, algo, N, trials, device, kept)
        print(f"[time] {label} done at {time.perf_counter() - t_start:.1f}s",
              flush=True)
        if label == MICRO_CHAIN:
            # 4c. the per-op table on its context, and K1's throughput
            launches[MICRO_PATH], launches[NTT_PATH], ntt_rate = \
                micro_phase(device, card, kept)
            print(f"[time] {MICRO_PATH} done at "
                  f"{time.perf_counter() - t_start:.1f}s", flush=True)
        elif kept is not None:
            # 10. the same sort on the row-sharded evaluator, on its
            # context, input and output
            name = BOOT_MESH[label]
            launches[name] = boot_mesh_phase(device, label, kept)
            print(f"[time] {name} done at "
                  f"{time.perf_counter() - t_start:.1f}s", flush=True)
    # 4d. the ring-2^18 tier
    launches[R18_PATH] = ring18_phase(device, card)
    print(f"[time] {R18_PATH} done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    launches[BOOT_PHASE] = bootstrap_phase(device)
    print(f"[time] {BOOT_PHASE} done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    # 6. the CLI's blind sort from files, the server in its own process
    launches[CLI_PATH] = cli_phase(device)
    print(f"[time] {CLI_PATH} done at {time.perf_counter() - t_start:.1f}s",
          flush=True)

    # 7. the experiment harness
    launches[EXP_PATH] = experiments_phase(device, mems[EXP_CHAIN])
    print(f"[time] {EXP_PATH} done at {time.perf_counter() - t_start:.1f}s",
          flush=True)

    # 7b. key streaming with device keygen on the mehp24 N=512 chain
    keygen_phase(device)
    (launches[STREAM_PATH], launches[STREAM_KEYGEN],
     launches[STREAM_MESH]) = stream_phase(device)
    print(f"[time] {STREAM_PATH} done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    # 8. the limb-sharded key switch on a virtual mesh (and on the cards)
    launches[MESH_PATH] = mesh_phase(device, census[MESH_CENSUS])
    print(f"[time] {MESH_PATH} done at {time.perf_counter() - t_start:.1f}s",
          flush=True)

    # 9. the main path's sort on the row-sharded evaluator
    launches[SHARD_PATH] = sharded_phase(device)
    print(f"[time] {SHARD_PATH} done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    # 11. results
    print(json.dumps({"kernels": kernel_records(largest, table, basis,
                                                keyswitch, rescale, launches,
                                                ntt_rate)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
