"""RNS-CKKS evaluator on torch tensors: the homomorphic op surface.

Counterpart of sorting_fhe_tpu/core/ckks.py, with the same API and the same
bits: EvalAdd/Sub/Mult/Square (ct-ct, ct-pt, ct-scalar) with
FLEXIBLEAUTO-style lazy rescaling, EvalMultAndRelinearize, EvalRotate via
Galois automorphism + hybrid key switching, hoisted fast rotations,
MakeCKKSPackedPlaintext with SetSlots semantics, Encrypt/Decrypt, and the
level/scale bookkeeping.

Representation: ciphertext components are int32 [k, limbs, n] tensors on
the context's device, canonical residues in the NTT (evaluation) domain and
the Montgomery domain — the JAX package's uint32 bits.  Arithmetic is
exact int64 (core/rns.py), so every op returns the residues the JAX op
returns.  Both NTTs go through core/cuda_ntt.py, the key switch's base
conversions (ModUp, ModDown) through core/cuda_basis.py, its key inner
product and ModDown's tail through core/cuda_keyswitch.py and the
composite rescale's lift through core/cuda_rescale.py: the hand-written
kernels of core/cuda_lib.py's library on a CUDA device, their plain
versions on the CPU.  Each key-switching op is composed once, by the
context's `_relin` and `_fast_rotate` over `_decompose` and `_keyswitch`.

Differences from the JAX package, none of which changes a bit: ops are
plain functions run eagerly (no jit, no pytrees, no trace-state guards),
every op runs at the exact limb count (no limb bucketing), and constants
need no Shoup companions.

Rotation-key streaming as in the JAX package: under a budget
(cfg.rot_key_budget_mb, else SORTING_FHE_KEY_BUDGET_MB) gen_rotation_keys
only registers keys, and the key store makes each on first use with the
device keygen (keys.gen_rotation_key_dev) and keeps at most the budget's
bytes of them (core/keystore.py).

One op is not bit-equal by design: mod_raise's correction count is a
float32 sum, as in the JAX package, and a float32 sum can round the other
way there; such a coefficient then differs by exactly +-D (the product of
the raised primes), which the bootstrap's periodic sine absorbs.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from . import nt, encoding
from .device import resolve_device
from .params import CkksParams, CkksConfig  # noqa: F401
from .keys import KeyGenerator, Encryptor, Decryptor
from .keystore import KeyStore
from .interop import keys_to_torch
from .rns import add_mod, sub_mod, neg_mod, mont_mul
from .cuda_ntt import ntt_fwd, ntt_inv
from .cuda_basis import base_conv
from .cuda_keyswitch import ks_inner, moddown_tail
from .cuda_rescale import rescale_lift, rescale_tables

SCALE_TOL = 2.0 ** -25
# the rotation keys' budget in MB for a config that names none
KEY_BUDGET_ENV = "SORTING_FHE_KEY_BUDGET_MB"
I32 = torch.int32
I64 = torch.int64


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Canonical residues -> contiguous int32, the NTT kernels' input."""
    return x.to(I32).contiguous()


def _col(v: torch.Tensor) -> torch.Tensor:
    """[l] per-limb vector -> [1, l, 1] for [k, l, n] broadcasts."""
    return v.reshape(1, -1, 1)


@dataclass
class Ciphertext:
    """data: int32 [k, limbs, n], NTT+Montgomery domain, k in {2, 3}."""
    data: torch.Tensor
    scale: float
    noise_deg: int      # 1: scale ~ S[l]; 2: product awaiting rescale
    slots: int

    @property
    def limbs(self) -> int:
        return self.data.shape[1]

    @property
    def k(self) -> int:
        return self.data.shape[0]

    def with_slots(self, s: int) -> "Ciphertext":
        """SetSlots: metadata-only reinterpretation (OpenFHE semantics)."""
        return replace(self, slots=s)


@dataclass
class Plaintext:
    data: torch.Tensor   # int32 [limbs, n] NTT+Montgomery
    scale: float
    slots: int

    @property
    def limbs(self) -> int:
        return self.data.shape[0]


class _LevelTables:
    """Per-limb-count constants for rescale / keyswitch / moddown.

    Small int64 vectors on the device.  The [LP, n] twiddle tables are not
    sliced per level: every level shares the chain's NttContext and passes
    the int32 `rows_*` index vectors to the NTT kernels.
    """

    def __init__(self, P: CkksParams, l: int):
        q = P.q
        nq = P.nq
        ksp = P.num_special
        sp = P.p_special
        dev = P.device
        self.l = l
        self.nq = nq
        self.ksp = ksp
        self.ntt = P.ntt
        self.device = P.primes_dev.device
        self.q_host = q[:l]          # the rows' primes as Python ints

        def i64(a):
            return torch.tensor(np.asarray(a, dtype=np.int64), dtype=I64,
                                device=dev)

        # --- row sets: q = chain prefix, ext = q rows + special primes ---
        sprows = np.arange(nq, nq + ksp)
        ext_rows = np.concatenate([np.arange(l), sprows])
        self.rows_q = torch.arange(l, dtype=I32, device=dev)
        self.rows_ext = torch.tensor(ext_rows, dtype=I32, device=dev)
        self.rows_sp = torch.tensor(sprows, dtype=I32, device=dev)
        ext_idx = self.rows_ext.to(I64)
        self.q_p = P.primes_dev[:l]
        self.ext_p = P.primes_dev[ext_idx]
        self.sp_p = P.primes_dev[nq:nq + ksp]
        self.q_rinv = P.mont_r_inv[:l]
        self.ext_rinv = P.mont_r_inv[ext_idx]
        # to-Montgomery factor R mod q for every q row
        self.rmod = i64([(1 << 32) % p for p in q[:l]])

        # --- keyswitch digit tables (digit j: rows [j alpha, (j+1) alpha)) ---
        alpha = P.alpha
        ndig = -(-l // alpha)
        self.alpha = alpha
        self.ndig = ndig
        self.digits = [list(range(j * alpha, min((j + 1) * alpha, l)))
                       for j in range(ndig)]
        ext_primes = [q[i] for i in range(l)] + list(sp)
        R = 1 << 32
        w_in = []
        Cw = np.zeros((l, len(ext_primes)), dtype=np.int64)
        for dig in self.digits:
            D = 1
            for i in dig:
                D *= q[i]
            for i in dig:
                d = q[i]
                dh = D // d
                w_in.append(nt.mod_inverse(dh % d, d)
                            * nt.mod_inverse(R % d, d) % d)
                for r, pr in enumerate(ext_primes):
                    Cw[i, r] = (dh % pr) * (R % pr) % pr
        # [l]: row i's Mont input -> plain [x * (D/d)^-1]_d of its digit
        self.dig_in = i64(w_in)
        # [l, l+ksp]: row i's plain xhat -> Mont output on every ext row
        self.dig_conv = i64(Cw)

        # --- moddown tables (basis P -> q rows) ---
        Pint = P.P_int
        w_in = []
        Cw = np.zeros((ksp, l), dtype=np.int64)
        for a, p in enumerate(sp):
            ph = Pint // p
            w_in.append(nt.mod_inverse(ph % p, p)
                        * nt.mod_inverse(R % p, p) % p)
            for r in range(l):
                Cw[a, r] = (ph % q[r]) * (R % q[r]) % q[r]
        self.md_in = i64(w_in)
        self.md_conv = i64(Cw)
        self.md_pinv = i64([nt.mod_inverse(Pint % q[r], q[r])
                            for r in range(l)])
        # approximate-extension magnitude correction is omitted (HPS-style
        # approximate conversion, as in the JAX package and OpenFHE's
        # ApproxSwitchCRTBasis): the same formula gives the same bits.


# ===================== ops (plain functions on tensors) =====================
#
# Row sets for the NTT: 'q' = chain prefix [0, k), 'ext' = q rows of the
# level plus the special primes, 'sp' = special primes only.  Inputs to the
# helpers below are canonical residues (int32 or int64); outputs of the
# _kj_* ops are int32.


def _fwd_q(x, T: _LevelTables, k: int):
    return ntt_fwd(_i32(x), T.ntt, T.rows_q[:k])


def _inv_q(x, T: _LevelTables, lo: int, hi: int):
    return ntt_inv(_i32(x), T.ntt, T.rows_q[lo:hi])


def _fwd_ext(x, T: _LevelTables):
    return ntt_fwd(_i32(x), T.ntt, T.rows_ext)


def _inv_sp(x, T: _LevelTables):
    return ntt_inv(_i32(x), T.ntt, T.rows_sp)


def _kj_add(a, b, p):
    return add_mod(a, b, p).to(I32)


def _kj_sub(a, b, p):
    return sub_mod(a, b, p).to(I32)


def _k_mult3(a, b, p, r_inv):
    """(a0,a1) x (b0,b1) -> (d0,d1,d2) tensor product, int64."""
    pb, rb = _col(p), _col(r_inv)
    d0 = mont_mul(a[0:1], b[0:1], pb, rb)
    d2 = mont_mul(a[1:2], b[1:2], pb, rb)
    d1 = add_mod(mont_mul(a[0:1], b[1:2], pb, rb),
                 mont_mul(a[1:2], b[0:1], pb, rb), pb)
    return torch.cat([d0, d1, d2], dim=0)


def _k_square3(a, p, r_inv):
    pb, rb = _col(p), _col(r_inv)
    d0 = mont_mul(a[0:1], a[0:1], pb, rb)
    d2 = mont_mul(a[1:2], a[1:2], pb, rb)
    x = mont_mul(a[0:1], a[1:2], pb, rb)
    d1 = add_mod(x, x, pb)
    return torch.cat([d0, d1, d2], dim=0)


def _kj_pt_mul(a, pt, p, r_inv):
    return mont_mul(a, pt[None], _col(p), _col(r_inv)).to(I32)


def _kj_const_mul(a, w, p):
    """Multiply by per-limb plain constants w (shape [l])."""
    return (a.to(I64) * _col(w) % _col(p)).to(I32)


def _int_rows(m: int, T) -> torch.Tensor:
    """An integer (possibly negative) as plain constants of T's rows."""
    return torch.tensor([m % p for p in T.q_host], dtype=I64, device=T.device)


def _kj_rescale(data, consts, T: _LevelTables):
    """Composite rescale: drop the `comp` primes q[l-1], q[l-2], ... in one
    op (OpenFHE ModReduce semantics, one level = comp primes), int32 [k,
    l - comp, n].  The comp steps (c - lift([c]_{q_d})) * q_d^-1 combine
    into one (core/cuda_rescale.py): the inverse NTT of the dropped rows,
    their combined lift on the kept rows (`rescale_lift`), its forward NTT
    and (x - lift) * (prod q_d)^-1 (`moddown_tail`, the kept rows read in
    place).  `consts`: CkksContext._rescale_consts(l)."""
    drop, keep, pinv = consts
    lo = T.l - drop.shape[0]
    lift = rescale_lift(_inv_q(data[:, lo:], T, lo, T.l), drop, keep)
    return moddown_tail(data[:, :lo], _fwd_q(lift, T, lo), T.q_p[:lo], pinv)


def _kj_decompose(cx, T: _LevelTables):
    """Hybrid-keyswitch digit decomposition of one poly [l, n] (NTT Mont).

    Returns ext digits stacked [ndig, l+ksp, n] int32 in NTT+Mont domain
    (EvalFastRotationPrecompute equivalent)."""
    l = cx.shape[0]
    cc = _inv_q(cx, T, 0, l)                          # [l, n] Mont coeff
    # in-digit rows: exact copies of cc (keep_own)
    out = base_conv(cc[None], T.dig_conv, T.ext_p, T.alpha, T.dig_in,
                    T.q_p, keep_own=True)[0]
    # one batched forward NTT over all digits' extended bases
    return _fwd_ext(out, T)


def _k_moddown(acc_q, acc_sp, T: _LevelTables):
    """ModDown of the inner product's q rows [k, l, n] and special rows
    [k, ksp, n] (NTT Mont, int32) -> [k, l, n] int32: (x - lift([x]_P))
    * P^-1."""
    conv = _inv_sp(acc_sp, T)                         # [k, ksp, n] Mont coeff
    conv = base_conv(conv, T.md_conv, T.q_p, T.ksp, T.md_in, T.sp_p)[:, 0]
    conv = _fwd_q(conv, T, T.l)                       # [k, l, n] NTT Mont
    return moddown_tail(acc_q, conv, T.q_p, T.md_pinv)


def _k_ks_moddown(exts, ksk, T: _LevelTables, perm=None):
    """ModDown(<exts, ksk>), int32 [2, l, n]: the inner product of the ext
    digits [ndig, l+ksp, n], read through the automorphism `perm` (None:
    relinearisation), with the key [>=ndig, 2, nq+ksp, n], whose rows the
    kernel selects, then ModDown."""
    return _k_moddown(*ks_inner(exts, ksk, T.ext_p, T.ext_rinv, T.l, T.nq,
                                perm), T)


def _kj_permute(data, perm):
    return data.index_select(-1, perm)


def _kj_encode(rows, rmod, T):
    """Plain coefficient rows [l, n] -> NTT+Montgomery domain, int32."""
    l = rows.shape[0]
    mont = rows.to(I64) * rmod.reshape(-1, 1) % T.q_p.reshape(-1, 1)
    return _fwd_q(mont, T, l)


def _kj_negate(data, p):
    return neg_mod(data, p).to(I32)


def _k_raise_rows(x, w, dinv, q_lo, Cw, DmodR, q_p, lo: int):
    """ModRaise's CRT extension onto some rows of the full chain, int64
    [k, rows, n] in the coefficient domain (Montgomery form).

    x: the Montgomery coefficients [k, l0, n] (int64) of all l0 base rows;
    w, dinv, q_lo: per base row, [(D/d)^-1 R^-1]_d, float32 1/d and d; Cw
    [l0, rows], DmodR [rows], q_p [rows]: the target rows' columns of
    [D/d R]_p, [D R]_p and their primes; lo: the chain index of the first
    target row (the rows below l0 among them are exact copies of x).

    The plain digit values xhat_i determine u = round(sum xhat_i / d_i);
    subtracting u*D centers the lift in (-D/2, D/2).  The sum runs in
    float32 from i = 0 up, as the JAX package's does, so every caller of
    the same x gets the same count; a misround shifts one coefficient by
    +-D, an integer multiple of D that EvalMod's periodic sine absorbs
    (core/bootstrap.py)."""
    l0 = x.shape[1]
    xhat = x * _col(w) % _col(q_lo)                  # plain [x (D/d)^-1]_d
    xf = xhat.to(torch.float32) * _col(dinv)
    y = xf[:, 0]
    for i in range(1, l0):
        y = y + xf[:, i]
    corr = torch.round(y).to(I64)[:, None, :]        # [k, 1, n], <= l0
    qp = _col(q_p)
    acc = torch.zeros((x.shape[0], q_p.shape[0], x.shape[2]), dtype=I64,
                      device=x.device)
    for i in range(l0):                              # terms < p: no overflow
        acc += xhat[:, i:i + 1] * _col(Cw[i]) % qp
    acc = sub_mod(acc % qp, corr * _col(DmodR) % qp, qp)
    m = max(0, min(l0 - lo, acc.shape[1]))
    acc[:, :m] = x[:, lo:lo + m]                     # in-digit rows exact
    return acc


def _kj_mod_raise(data, w, Cw, dinv, DmodR, T_lo: _LevelTables,
                  T_hi: _LevelTables):
    """ModRaise: [k, l0, n] NTT+Mont at modulus D = prod(q[:l0]) ->
    [k, nq, n] at the full chain, with centered lift (_k_raise_rows)."""
    l0 = data.shape[1]
    x = _inv_q(data, T_lo, 0, l0).to(I64)            # [k, l0, n] Mont coeff
    acc = _k_raise_rows(x, w, dinv, T_lo.q_p[:l0], Cw, DmodR, T_hi.q_p, 0)
    return _fwd_q(acc, T_hi, T_hi.l)


# ===================== context =====================


class CkksContext:
    """CryptoContext equivalent: params + keys + evaluator + client ops,
    with every tensor on `device` (the card unless device="cpu").

    The ops, the bootstrap's among them, reach ciphertext and plaintext
    residues only through the nine methods under "the steps that touch
    the data" (_local, _narrow, _place, _host_rows, _to_eval_domain,
    _rescale_data, _decompose, _keyswitch, _mod_raise_data): a row-sharded
    context (parallel/evaluator.py) overrides those, and the level and
    scale bookkeeping above them is the same code for both."""

    ct_type = Ciphertext

    def __init__(self, cfg: CkksConfig, device="cuda"):
        self._init_common(cfg, device)
        P = self.params
        self.keygen = KeyGenerator(P)
        self.encryptor = Encryptor(P, self.keygen.public_key)
        self.decryptor = Decryptor(P, self.keygen.sk)
        self.relin_key = self.keygen.gen_relin_key()

    @classmethod
    def for_evaluation(cls, cfg: CkksConfig, public_key, relin_key,
                       rot_keys: dict, conj_key=None,
                       device="cuda") -> "CkksContext":
        """Blind-evaluation (server-side) context: public material only,
        no secret key (the reference's deserialized CryptoContext,
        sort.h:31-74).  Keys are uint32 residue arrays, as serial.py
        loads them; they go to `device`, and the public key stays on the
        host as uint64 (b, a), where the Encryptor uses it.  The loaded
        rotation keys are pinned in the key store whatever the config's
        budget (with no secret nothing can make them again), as the JAX
        package's plain dict keeps them.  The server can encrypt,
        evaluate and serialize; decrypt() raises."""
        self = cls.__new__(cls)
        self._init_common(cfg, device)
        self.keygen = None
        self.decryptor = None
        pk, self.relin_key, rot, self.conj_key = keys_to_torch(
            public_key, relin_key, rot_keys, conj_key, self.device)
        self.encryptor = Encryptor(self.params, pk)
        for k, v in rot.items():
            self.rot_keys[k] = v
        return self

    def _init_common(self, cfg: CkksConfig, device="cuda"):
        # resolve first: the full chain takes seconds to build on the host
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = CkksParams(cfg, self.device)
        self.n = self.params.n
        self.delta = float(2 ** cfg.scale_bits)
        # rotation-key budget (JAX ckks.py:617-626): the config's, else
        # the environment's; 0 streams with no cap (lazy device keygen,
        # every key kept)
        budget_mb = cfg.rot_key_budget_mb
        if budget_mb is None:
            env = os.environ.get(KEY_BUDGET_ENV)
            budget_mb = int(env) if env else None
        self._key_streaming = budget_mb is not None
        self.rot_keys = KeyStore((budget_mb << 20) if budget_mb else None,
                                 regen=self._regen_rot_key)
        self.conj_key = None
        self._tables: dict[int, _LevelTables] = {}
        self._rs_cache: dict[int, tuple] = {}
        self._perm_cache: dict[int, torch.Tensor] = {}
        # device plaintext cache: byte-capped LRU (same cap and knob as
        # the JAX package); masks re-encode cheaply from the host cache
        self._pt_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._pt_cache_bytes = 0
        self._pt_cache_cap = int(os.environ.get(
            "SORTING_FHE_PT_CACHE_MB", "3072")) << 20
        # host coefficient-row cache: on device eviction only the transfer
        # and the device NTT re-run, not the iFFT + per-limb reduction
        self._pt_host_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._pt_host_bytes = 0
        self._pt_host_cap = int(os.environ.get(
            "SORTING_FHE_PT_HOST_CACHE_MB", "16384")) << 20
        self.mult_count = 0
        self.rot_count = 0
        self.precompute_count = 0   # hoisting decompositions
        self.pt_encode_s = 0.0      # wall spent encoding plaintexts
        self.pt_encode_count = 0    # (host iFFT + RNS rows + device NTT)
        self.op_counts = collections.Counter()   # per-op dispatch census
        self.ks_digits = 0          # digits key-switched, hoisted included
        self.span_s: dict[str, float] = {}   # seconds by span (span())
        self._spans_open: list = []          # event pairs not yet read

    # ---------------- tables ----------------
    def tables(self, l: int) -> _LevelTables:
        """Level tables for limb count l (exact; no bucketing)."""
        if l not in self._tables:
            self._tables[l] = _LevelTables(self.params, l)
        return self._tables[l]

    def canonical_scale(self, l: int) -> float:
        return self.params.canonical_scale[l]

    # ---------------- plaintext-cache LRU plumbing ----------------
    def _pt_get(self, key):
        hit = self._pt_cache.get(key)
        if hit is None:
            return None
        self._pt_cache.move_to_end(key)
        return hit[0]

    def _pt_put(self, key, value, nbytes: int):
        if key in self._pt_cache:
            self._pt_cache_bytes -= self._pt_cache[key][1]
        self._pt_cache[key] = (value, nbytes)
        self._pt_cache_bytes += nbytes
        while (self._pt_cache_bytes > self._pt_cache_cap
               and len(self._pt_cache) > 1):
            _, (_, ob) = self._pt_cache.popitem(last=False)
            self._pt_cache_bytes -= ob
        return value

    def _rescale_consts(self, l: int) -> tuple:
        """The composite rescale's tables from limb count l, cached:
        cuda_rescale.rescale_tables of the dropped primes q[l-1], q[l-2],
        ... onto the kept rows q[:l - comp]."""
        if l not in self._rs_cache:
            q, comp = self.params.q, self.params.comp
            self._rs_cache[l] = rescale_tables(q[l - comp:l][::-1],
                                               q[:l - comp], self.device)
        return self._rs_cache[l]

    # ---------------- key management ----------------
    def gen_rotation_keys(self, indices: list[int]):
        """EvalRotateKeyGen equivalent.  Under a rotation-key budget the
        keys are only registered: the key store makes each on first use
        (`_regen_rot_key`).  An evaluation-only context cannot make keys:
        a missing one raises."""
        half = self.n // 2
        for k in indices:
            kk = k % half
            if kk and kk not in self.rot_keys:
                if self.keygen is None:
                    raise KeyError(
                        f"evaluation-only context is missing rotation key "
                        f"{k}: regenerate and reserialize with it")
                if self._key_streaming:
                    self.rot_keys.register(kk)
                    continue
                g = encoding.galois_element_for_rotation(self.n, kk)
                self.rot_keys[kk] = self.keygen.gen_rotation_key(g)

    def _regen_rot_key(self, kk: int):
        """The key store's hook: the device keygen's key for rotation kk;
        on a context placed on a mesh (parallel/mesh.shard_context_tables),
        that key's slot blocks, which the store then keeps in its place."""
        g = encoding.galois_element_for_rotation(self.n, kk)
        key = self.keygen.gen_rotation_key_dev(g)
        tables = getattr(self, "mesh_tables", None)
        return key if tables is None else tables.split_key(key)

    def _perm(self, k, device=None) -> torch.Tensor:
        """int64 gather index of the Galois automorphism for rotation k
        (for k = "conj": conjugation, Galois element 2n-1), on `device`
        (default: the context's), cached per device."""
        if k not in self._perm_cache:
            g = 2 * self.n - 1 if k == "conj" else \
                encoding.galois_element_for_rotation(self.n, k)
            self._perm_cache[k] = torch.from_numpy(
                encoding.automorphism_eval_perm(self.n, g).astype(np.int64)
            ).to(self.device)
        perm = self._perm_cache[k]
        if device is None or perm.device == device:
            return perm
        if (k, device) not in self._perm_cache:
            self._perm_cache[k, device] = perm.to(device)
        return self._perm_cache[k, device]

    # ---------------- the steps that touch the data ----------------
    # Ciphertext data is int32 [k, limbs, n], plaintext data [limbs, n];
    # a row-sharded context holds one row block per slot instead.

    def _local(self, l: int, fn, *args):
        """A row-local step at limb count l: fn(T, *args), T the level's
        tables (q_p, q_rinv, rmod, q_host, device); every output row
        depends on the same row of the inputs alone."""
        return fn(self.tables(l), *args)

    def _narrow(self, data, limbs: int):
        """The first `limbs` rows of ciphertext data (a level drop)."""
        return data[:, :limbs, :]

    def _place(self, data: torch.Tensor):
        """Ciphertext data made on self.device, in this context's layout."""
        return data

    def _host_rows(self, data, need: int) -> np.ndarray:
        """The first `need` rows of ciphertext data on the host (uint32):
        only the rows decryption uses are copied."""
        return data[:, :need, :].cpu().numpy().view(np.uint32)

    def _to_eval_domain(self, rows: np.ndarray, limbs: int):
        """Host plain-coefficient rows [limbs, n] (uint32 < p) -> device
        plaintext data in the NTT+Montgomery domain."""
        T = self.tables(limbs)
        x = torch.from_numpy(rows.view(np.int32)).to(self.device)
        return _kj_encode(x, T.rmod, T)

    def _rescale_data(self, data, l: int):
        """The composite rescale's residues (comp rows dropped)."""
        return _kj_rescale(data, self._rescale_consts(l), self.tables(l))

    def _decompose(self, c1, l: int):
        """Hoisted ext digits of one poly [l, n] (the key switch's first
        half)."""
        return _kj_decompose(c1, self.tables(l))

    def _keyswitch(self, exts, tag, l: int):
        """The key switch's second half, int32 [2, l, n]: ModDown of the
        inner product of `exts` with the relinearisation key (tag
        "relin"), the conjugation key ("conj") or rotation tag's key, the
        digits read through that automorphism (not for "relin")."""
        perm = None if tag == "relin" else self._perm(tag)
        return _k_ks_moddown(exts, self._key(tag), self.tables(l), perm)

    def _mod_raise_data(self, data, l0: int):
        """mod_raise's residues: [k, l0, n] -> [k, nq, n]."""
        w, Cw, dinv, DmodR = self._raise_consts(l0)
        return _kj_mod_raise(data, w, Cw, dinv, DmodR, self.tables(l0),
                             self.tables(self.params.nq))

    def _key(self, tag) -> torch.Tensor:
        """The key-switching key of tag: "relin", "conj" or a rotation,
        whole (joined from a mesh's slot blocks where the store keeps
        those)."""
        key = self._key_entry(tag)
        return key if isinstance(key, torch.Tensor) else \
            key.whole(self.device)

    def _key_entry(self, tag):
        """The key of tag as the context keeps it: a tensor, or for a
        streamed rotation of a context placed on a mesh, its slot blocks
        (parallel/mesh.KeyBlocks)."""
        if tag == "relin":
            return self.relin_key
        return self.conj_key if tag == "conj" else self.rot_keys[tag]

    # ---------------- ops composed from those steps ----------------
    def _const_mul(self, data, m: int, l: int):
        """data at limb count l times the integer m (any sign)."""
        return self._local(l, lambda T, x: _kj_const_mul(x, _int_rows(m, T),
                                                         T.q_p), data)

    def _relin(self, d, l: int):
        """[3, l, n] -> d[:2] + ModDown(<decompose(d[2]), relin key>).  The
        digits are freed before the final add, whose int64 temporaries
        would otherwise join them at the op's memory peak."""
        self.ks_digits += -(-l // self.params.alpha)
        dd = self._keyswitch(self._decompose(
            self._local(l, lambda T, x: x[2], d), l), "relin", l)
        return self._local(l, lambda T, x, y: add_mod(
            x[:2], y, _col(T.q_p)).to(I32), d, dd)

    def _fast_rotate(self, data, exts, kk, l: int):
        """Automorphism kk (a rotation or "conj") of hoisted digits + key
        inner product + ModDown, and c0's automorphism added."""
        self.ks_digits += -(-l // self.params.alpha)
        dd = self._keyswitch(exts, kk, l)

        def tail(T, x, y):
            c0 = add_mod(_kj_permute(x[0:1], self._perm(kk, T.device)),
                         y[0:1], _col(T.q_p))
            return torch.cat([c0, y[1:2]], dim=0).to(I32)
        return self._local(l, tail, data, dd)

    def _c1(self, ct: Ciphertext):
        return self._local(ct.limbs, lambda T, x: x[1], ct.data)

    # ---------------- client ops (host) ----------------
    def encrypt(self, values, slots: int | None = None) -> Ciphertext:
        slots = slots or self.params.num_slots
        coeffs = encoding.encode_real(np.asarray(values, dtype=np.float64),
                                      self.n, self.delta, slots)
        data = self.encryptor.encrypt_coeffs(coeffs)
        return self.ct_type(self._place(data), self.delta, 1, slots)

    def decrypt(self, ct: Ciphertext, complex_out: bool = False) -> np.ndarray:
        if self.decryptor is None:
            raise RuntimeError("evaluation-only context has no secret key")
        # enough limbs that prod(q) > value * scale * 2^20 headroom
        bits_needed = np.log2(max(ct.scale, 1.0)) + 24
        need = 0
        acc = 0.0
        while acc < bits_needed and need < ct.limbs:
            acc += np.log2(float(self.params.q[need]))
            need += 1
        need = min(ct.limbs, need)
        data = self._host_rows(ct.data, need)
        coeffs = self.decryptor.decrypt_to_coeffs(
            data, need, max_limbs=need)
        return encoding.decode_real(coeffs.astype(np.float64), self.n,
                                    ct.scale, ct.slots,
                                    complex_out=complex_out)

    def zero_like(self, ct: Ciphertext) -> Ciphertext:
        return replace(ct, data=self._local(
            ct.limbs, lambda T, x: torch.zeros_like(x), ct.data))

    def fresh_zero(self, slots: int | None = None) -> Ciphertext:
        slots = slots or self.params.num_slots
        z = torch.zeros((2, self.params.nq, self.n), dtype=I32,
                        device=self.device)
        return self.ct_type(self._place(z), self.delta, 1, slots)

    # ---------------- plaintext encoding ----------------
    def make_plaintext(self, values, limbs: int, scale: float,
                       slots: int | None = None) -> Plaintext:
        """MakeCKKSPackedPlaintext equivalent (NTT+Mont, device)."""
        slots = slots or self.params.num_slots
        v = np.asarray(values)
        if not np.iscomplexobj(v):
            v = v.astype(np.float64)
        key = (hashlib.md5(v.tobytes()).hexdigest(), str(v.dtype), limbs,
               float(scale), slots)
        hit = self._pt_get(key)
        if hit is not None:
            return hit
        t0 = time.time()
        rows = self._pt_host_cache.get(key)
        if rows is None:
            coeffs = encoding.encode_real(v, self.n, scale, slots)
            rows = np.empty((limbs, self.n), dtype=np.uint32)
            for i in range(limbs):
                p = self.params.q[i]
                r = np.fmod(coeffs, float(p))
                rows[i] = np.where(r < 0, r + p, r).astype(np.uint32)
            self._pt_host_cache[key] = rows
            self._pt_host_bytes += rows.nbytes
            while (self._pt_host_bytes > self._pt_host_cap
                   and len(self._pt_host_cache) > 1):
                _, old = self._pt_host_cache.popitem(last=False)
                self._pt_host_bytes -= old.nbytes
        else:
            self._pt_host_cache.move_to_end(key)
        pt = Plaintext(self._to_eval_domain(rows, limbs), float(scale), slots)
        self.pt_encode_s += time.time() - t0
        self.pt_encode_count += 1
        return self._pt_put(key, pt, limbs * self.n * 4)

    # ---------------- rescale / level management ----------------
    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Composite rescale: drop `comp` primes (one level, one op)."""
        comp = self.params.comp
        l = ct.limbs
        assert l - comp >= self.params.base_limbs, \
            "cannot rescale below base limbs"
        dropped = 1.0
        for i in range(comp):
            dropped *= float(self.params.q[l - 1 - i])
        self.op_counts["rescale"] += 1
        return replace(ct, data=self._rescale_data(ct.data, l),
                       scale=ct.scale / dropped, noise_deg=1)

    def level_reduce(self, ct: Ciphertext, target_limbs: int) -> Ciphertext:
        assert target_limbs <= ct.limbs
        if target_limbs == ct.limbs:
            return ct
        return replace(ct, data=self._narrow(ct.data, target_limbs))

    def _ensure_deg1(self, ct: Ciphertext) -> Ciphertext:
        return self.rescale(ct) if ct.noise_deg == 2 else ct

    def _anchor(self, ct: Ciphertext) -> Ciphertext:
        """Bound FLEXIBLEAUTO scale drift before multiplications: a deg-1
        ct more than sqrt(2) off the canonical ladder spends one level to
        land back on it (same rule as the JAX package)."""
        if ct.noise_deg != 1 or \
                ct.limbs - self.params.comp < self.params.base_limbs:
            return ct
        r = ct.scale / self.canonical_scale(ct.limbs)
        if 0.7071 < r < 1.4142:
            return ct
        t = ct.limbs - self.params.comp
        return self.adjust_to(ct, t, self.canonical_scale(t))

    def adjust_to(self, ct: Ciphertext, target_limbs: int,
                  target_scale: float) -> Ciphertext:
        """Bring ct to (target_limbs, ~target_scale) exactly: drop limbs,
        then integer-scalar multiply + one rescale to land on the scale."""
        ct = self._ensure_deg1(ct)
        if ct.limbs == target_limbs:
            ratio = target_scale / ct.scale
            if abs(ratio - 1) < SCALE_TOL:
                return ct
            if ratio > 1.5:
                # target is a deg-2 scale: integer raise, no level burned
                return self._raise_deg(ct, target_scale)
            assert ct.limbs > self.params.base_limbs, \
                "scale mismatch at base level"
        comp = self.params.comp
        ct = self.level_reduce(ct, min(ct.limbs, target_limbs + comp))
        qd = 1.0
        for i in range(ct.limbs - comp, ct.limbs):
            qd *= float(self.params.q[i])
        m = int(round(target_scale * qd / ct.scale))
        # a zero multiplier would silently zero the ciphertext; fail loudly
        assert m >= 1, (
            f"adjust_to multiplier underflow: scale={ct.scale:.6g} "
            f"target={target_scale:.6g} qd={qd:.6g}")
        self.op_counts["adjust"] += 1
        ct = replace(ct, data=self._const_mul(ct.data, m, ct.limbs),
                     scale=ct.scale * m, noise_deg=1)
        return self.rescale(ct)

    def _match_add(self, a: Ciphertext, b: Ciphertext):
        """Equalize (limbs, scale) of two cts for addition (bounded
        fixpoint; see the JAX package for why one pass is not enough)."""
        for _ in range(16):
            if a.limbs > b.limbs:
                a = self.adjust_to(a, b.limbs, b.scale)
                continue
            if b.limbs > a.limbs:
                b = self.adjust_to(b, a.limbs, a.scale)
                continue
            if abs(a.scale / b.scale - 1) < SCALE_TOL:
                return a, b
            if (a.noise_deg == 1 and b.noise_deg == 2
                    and b.scale / a.scale > 1.5):
                a = self._raise_deg(a, b.scale)
                continue
            if (a.noise_deg == 2 and b.noise_deg == 1
                    and a.scale / b.scale > 1.5):
                b = self._raise_deg(b, a.scale)
                continue
            # same degree (or raise impossible) with mismatched scales:
            # burn one level on both, landing on the canonical scale
            comp = self.params.comp
            a = self.adjust_to(a, a.limbs - comp,
                               self.canonical_scale(a.limbs - comp))
            b = self.adjust_to(b, b.limbs - comp,
                               self.canonical_scale(b.limbs - comp))
        raise AssertionError(
            f"_match_add failed to converge: limbs {a.limbs}/{b.limbs} "
            f"scales {a.scale}/{b.scale}")

    def _raise_deg(self, ct: Ciphertext, target_scale: float) -> Ciphertext:
        """Multiply deg-1 ct by integer ~ target_scale/scale (no rescale)."""
        m = int(round(target_scale / ct.scale))
        assert m >= 1
        return replace(ct, data=self._const_mul(ct.data, m, ct.limbs),
                       scale=ct.scale * m, noise_deg=2)

    def _match_components(self, a: Ciphertext, b: Ciphertext):
        """Pad component counts (deg-2 + deg-1 adds)."""
        if a.k == b.k:
            return a, b

        def pad(x: Ciphertext, k: int) -> Ciphertext:
            def f(T, d):
                z = torch.zeros((k - d.shape[0],) + tuple(d.shape[1:]),
                                dtype=d.dtype, device=d.device)
                return torch.cat([d, z], dim=0)
            return replace(x, data=self._local(x.limbs, f, x.data))
        return (pad(a, b.k), b) if a.k < b.k else (a, pad(b, a.k))

    # ---------------- arithmetic: add/sub ----------------
    def add(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            a, b = self._match_add(a, b)
            a, b = self._match_components(a, b)
            self.op_counts["add"] += 1
            data = self._local(a.limbs, lambda T, x, y: _kj_add(
                x, y, _col(T.q_p)), a.data, b.data)
            return replace(a, data=data,
                           noise_deg=max(a.noise_deg, b.noise_deg))
        if isinstance(b, Plaintext):
            return self._add_pt(a, b, sub=False)
        return self._add_scalar(a, float(b), sub=False)

    def sub(self, a: Ciphertext, b) -> Ciphertext:
        if isinstance(b, Ciphertext):
            a, b = self._match_add(a, b)
            a, b = self._match_components(a, b)
            self.op_counts["add"] += 1
            data = self._local(a.limbs, lambda T, x, y: _kj_sub(
                x, y, _col(T.q_p)), a.data, b.data)
            return replace(a, data=data,
                           noise_deg=max(a.noise_deg, b.noise_deg))
        if isinstance(b, Plaintext):
            return self._add_pt(a, b, sub=True)
        return self._add_scalar(a, float(b), sub=True)

    def rsub(self, b, a: Ciphertext) -> Ciphertext:
        """scalar/pt minus ct."""
        return self.negate(self.sub(a, b))

    def negate(self, a: Ciphertext) -> Ciphertext:
        return replace(a, data=self._local(
            a.limbs, lambda T, x: _kj_negate(x, _col(T.q_p)), a.data))

    def _add_pt(self, a: Ciphertext, pt: Plaintext, sub: bool) -> Ciphertext:
        rows = a.limbs
        assert pt.data.shape[0] >= rows, "plaintext too short"
        assert abs(pt.scale / a.scale - 1) < SCALE_TOL, (pt.scale, a.scale)

        def f(T, x, y):
            p, ptd = _col(T.q_p), y[:x.shape[1]][None]
            c0 = sub_mod(x[0:1], ptd, p) if sub else add_mod(x[0:1], ptd, p)
            return torch.cat([c0.to(I32), x[1:]], dim=0)
        return replace(a, data=self._local(rows, f, a.data, pt.data))

    def _add_scalar(self, a: Ciphertext, c: float, sub: bool) -> Ciphertext:
        """Add/sub a real constant: encode at exact scale on the constant
        coefficient (slot-constant = coefficient-0 constant)."""
        m = int(round(c * a.scale))
        if sub:
            m = -m

        def f(T, x):
            # constant poly: value m at coeff 0 -> NTT is constant m across
            # slots, in Montgomery form
            wm = torch.tensor([(m % p) * ((1 << 32) % p) % p
                               for p in T.q_host], dtype=I64, device=T.device)
            c0 = add_mod(x[0:1], _col(wm), _col(T.q_p))
            return torch.cat([c0.to(I32), x[1:]], dim=0)
        return replace(a, data=self._local(a.limbs, f, a.data))

    # ---------------- arithmetic: mult ----------------
    def mult(self, a: Ciphertext, b) -> Ciphertext:
        """EvalMult (auto-relinearized for ct-ct, lazy rescale semantics)."""
        if isinstance(b, Ciphertext):
            return self._mult_ct(a, b)
        if isinstance(b, Plaintext):
            return self._mult_pt(a, b)
        return self.mult_scalar(a, float(b))

    def _prep_mult(self, a: Ciphertext, b: Ciphertext):
        a = self._anchor(self._ensure_deg1(a))
        b = self._anchor(self._ensure_deg1(b))
        if a.limbs > b.limbs:
            a = self.adjust_to(a, b.limbs, self.canonical_scale(b.limbs)) \
                if abs(a.scale / b.scale - 1) > SCALE_TOL else \
                self.level_reduce(a, b.limbs)
        elif b.limbs > a.limbs:
            b = self.adjust_to(b, a.limbs, self.canonical_scale(a.limbs)) \
                if abs(b.scale / a.scale - 1) > SCALE_TOL else \
                self.level_reduce(b, a.limbs)
        return a, b

    def _mult_ct(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._prep_mult(a, b)
        assert a.k == 2 and b.k == 2, "relinearize before multiplying"
        l = a.limbs
        d = self._relin(self._local(l, lambda T, x, y: _k_mult3(
            x, y, T.q_p, T.q_rinv), a.data, b.data), l)
        self.mult_count += 1
        self.op_counts["mult_relin"] += 1
        return replace(a, data=d, scale=a.scale * b.scale, noise_deg=2)

    def square(self, a: Ciphertext) -> Ciphertext:
        a = self._anchor(self._ensure_deg1(a))
        l = a.limbs
        d = self._relin(self._local(l, lambda T, x: _k_square3(
            x, T.q_p, T.q_rinv), a.data), l)
        self.mult_count += 1
        self.op_counts["square_relin"] += 1
        return replace(a, data=d, scale=a.scale * a.scale, noise_deg=2)

    def _mult_pt(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        a = self._ensure_deg1(a)
        rows = a.limbs
        assert pt.data.shape[0] >= rows, "plaintext too short"
        self.op_counts["pt_mul"] += 1
        d = self._local(rows, lambda T, x, y: _kj_pt_mul(
            x, y[:x.shape[1]], T.q_p, T.q_rinv), a.data, pt.data)
        return replace(a, data=d, scale=a.scale * pt.scale, noise_deg=2)

    def mult_delta(self, ct: Ciphertext) -> float:
        """FLEXIBLEAUTO scaling factor for a scalar/plaintext multiply of
        `ct` (must be deg-1): chosen so the deg-2 product rescales exactly
        onto the canonical ladder (OpenFHE's ScalingFactorReal analogue)."""
        P = self.params
        l = ct.limbs
        if l - P.comp < P.base_limbs:
            return self.delta
        qd = 1.0
        for i in range(l - P.comp, l):
            qd *= float(P.q[i])
        d = self.canonical_scale(l - P.comp) * qd / ct.scale
        # degenerate drift guard: a wildly off-ladder operand falls back
        # to the fresh Delta (then _anchor repairs as before)
        return d if 1.0 < d < self.delta * self.delta else self.delta

    def mult_scalar(self, a: Ciphertext, c: float) -> Ciphertext:
        """EvalMult(ct, double): scalar at the level's canonical factor."""
        a = self._ensure_deg1(a)
        dl = self.mult_delta(a)
        m = int(round(c * dl))
        self.op_counts["const_mul"] += 1
        return replace(a, data=self._const_mul(a.data, m, a.limbs),
                       scale=a.scale * dl, noise_deg=2)

    def mult_plain(self, ct: Ciphertext, values, slots: int | None = None
                   ) -> Ciphertext:
        """pt-mult with the plaintext encoded at the canonical mult factor
        (mult_delta) for ct's level."""
        ct = self._ensure_deg1(ct)
        pt = self.make_plaintext(values, ct.limbs, self.mult_delta(ct),
                                 slots or ct.slots)
        return self.mult(ct, pt)

    def mult_int(self, a: Ciphertext, m: int) -> Ciphertext:
        """Multiply the message by a small integer WITHOUT consuming scale
        or depth (noise grows by |m|): OpenFHE's Chebyshev doubling."""
        if m == 1:
            return a
        if m == 0:
            return self.zero_like(a)
        self.op_counts["const_mul"] += 1
        return replace(a, data=self._const_mul(a.data, m, a.limbs))

    # ---------------- relinearization ----------------
    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        if ct.k == 2:
            return ct
        return replace(ct, data=self._relin(ct.data, ct.limbs))

    # ---------------- rotations ----------------
    def rotate(self, ct: Ciphertext, k: int) -> Ciphertext:
        """EvalRotate: left rotation by k slots (key must exist).  Batched
        same-source rotations should go through fast_rotation_precompute /
        fast_rotation (or RotationTree) to share the decomposition."""
        half = self.n // 2
        kk = k % half
        if kk == 0 or k % ct.slots == 0:
            return ct
        assert kk in self.rot_keys, f"missing rotation key {k}"
        l = ct.limbs
        out = self._fast_rotate(ct.data, self._decompose(self._c1(ct), l),
                                kk, l)
        self.rot_count += 1
        self.op_counts["rotate_fused"] += 1
        return replace(ct, data=out)

    def rotate_raw(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Rotation WITHOUT the slots-period shortcut: applies the Galois
        automorphism even when k is a multiple of ct.slots.  Required by
        bootstrapping's subring trace, which rotates by multiples of the
        slot period to act on the mod-raise error (the message part is
        period-invariant but the error is dense)."""
        kk = k % (self.n // 2)
        if kk == 0:
            return ct
        assert kk in self.rot_keys, f"missing rotation key {k}"
        l = ct.limbs
        out = self._fast_rotate(ct.data, self._decompose(self._c1(ct), l),
                                kk, l)
        self.rot_count += 1
        self.op_counts["rotate_fused"] += 1
        return replace(ct, data=out)

    def fast_rotation_precompute(self, ct: Ciphertext):
        """Hoisted decomposition of c1 (EvalFastRotationPrecompute)."""
        self.precompute_count += 1
        self.op_counts["decompose"] += 1
        return self._decompose(self._c1(ct), ct.limbs)

    def fast_rotation(self, ct: Ciphertext, k: int, precomp) -> Ciphertext:
        half = self.n // 2
        kk = k % half
        if kk == 0 or k % ct.slots == 0:
            return ct
        assert kk in self.rot_keys, f"missing rotation key {k}"
        out = self._fast_rotate(ct.data, precomp, kk, ct.limbs)
        self.rot_count += 1
        self.op_counts["fast_rotate"] += 1
        return replace(ct, data=out)

    # ---------------- conjugation ----------------
    def gen_conj_key(self):
        """Galois key for complex conjugation (element 2n-1)."""
        if self.conj_key is None:
            self.conj_key = self.keygen.gen_rotation_key(2 * self.n - 1)

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        """EvalConjugate: slot-wise complex conjugation (sigma_{2n-1})."""
        assert self.conj_key is not None, "call gen_conj_key() first"
        ct = self._ensure_deg1(ct)
        l = ct.limbs
        out = self._fast_rotate(ct.data, self._decompose(self._c1(ct), l),
                                "conj", l)
        self.rot_count += 1
        self.op_counts["rotate_fused"] += 1
        return replace(ct, data=out)

    # ---------------- plaintext rotation (free: no key switch) ----------
    def rotate_plaintext(self, pt: Plaintext, r: int) -> Plaintext:
        """Slot-rotate a PLAINTEXT by r via the Galois automorphism — a pure
        eval-domain permutation: encode(roll(v, -r)) == sigma_g(encode(v))."""
        kk = r % (self.n // 2)
        if kk == 0:
            return pt
        self.op_counts["pt_rotate"] += 1
        return replace(pt, data=self._local(pt.limbs, lambda T, x: _kj_permute(
            x, self._perm(kk, T.device)), pt.data))

    # ---------------- monomial multiplication (free: no key, no level) ----
    def mult_monomial(self, ct: Ciphertext, power: int) -> Ciphertext:
        """Multiply by X^power (power mod 2n).  Multiplying by X^{n/2}
        multiplies every slot by i, X^{3n/2} by -i: noiseless, depth-free
        complex bookkeeping for bootstrap's real/imag split."""
        power %= 2 * self.n
        if power == 0:
            return ct
        limbs = ct.limbs
        key = ("mono", power, limbs)
        mono = self._pt_get(key)
        if mono is None:
            neg = power >= self.n
            k = power - self.n if neg else power
            rows = np.zeros((limbs, self.n), dtype=np.uint32)
            for i in range(limbs):
                # plain +-1 at coefficient k; _to_eval_domain applies the
                # Montgomery factor and the forward NTT
                rows[i, k] = (self.params.q[i] - 1) if neg else 1
            mono = self._pt_put(key, self._to_eval_domain(rows, limbs),
                                limbs * self.n * 4)
        return replace(ct, data=self._local(limbs, lambda T, x, y: _kj_pt_mul(
            x, y, T.q_p, T.q_rinv), ct.data, mono))

    # ---------------- mod raise (bootstrap step 1) ----------------
    def _raise_consts(self, l0: int) -> tuple:
        """mod_raise's constants for a raise from l0 limbs, cached as
        ("raise", l0): w [l0], Cw [l0, nq], dinv [l0] float32, DmodR [nq]."""
        key = ("raise", l0)
        consts = self._pt_get(key)
        if consts is not None:
            return consts
        q = self.params.q
        nq = self.params.nq
        R = 1 << 32
        D = self.params.q_product(l0)
        w = np.empty(l0, dtype=np.int64)
        Cw = np.zeros((l0, nq), dtype=np.int64)
        dinv = np.empty(l0, dtype=np.float32)
        for i in range(l0):
            d = q[i]
            dh = D // d
            w[i] = nt.mod_inverse(dh % d, d) * nt.mod_inverse(R % d, d) % d
            dinv[i] = np.float32(1.0 / d)
            for r in range(nq):
                Cw[i, r] = (dh % q[r]) * (R % q[r]) % q[r]
        DmodR = np.array([(D % p) * (R % p) % p for p in q], dtype=np.int64)
        consts = tuple(torch.from_numpy(a).to(self.device)
                       for a in (w, Cw, dinv, DmodR))
        return self._pt_put(key, consts, (2 * l0 + l0 * 2 * nq + 3 * nq) * 4)

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Re-interpret a low-level ciphertext at the full modulus chain.

        The output decrypts to m + D*I for the small integer polynomial I
        (|I| bounded by the secret's Hamming weight), D = prod(q[:limbs]).
        First step of EvalBootstrap (OpenFHE EvalBootstrap's ModRaise)."""
        l0 = ct.limbs
        assert l0 < self.params.nq, "already at full level"
        return self.ct_type(self._mod_raise_data(ct.data, l0), ct.scale, 1,
                            ct.slots)

    def _cards(self) -> list:
        """The devices this context's ops run on."""
        return [self.device]

    def sync(self):
        """Wait for the devices' queued work (host timing of phases), then
        read the spans that work closed into span_s."""
        for d in self._cards():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        for name, starts, ends in self._spans_open:
            ms = sum(a.elapsed_time(b) for a, b in zip(starts, ends))
            self.span_s[name] = (self.span_s.get(name, 0.0)
                                 + ms / len(starts) / 1e3)
        self._spans_open.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        """Adds the seconds of the block's work to span_s[name].  On CUDA
        devices a pair of events on each device's current stream, read at
        the next sync() (the mean over the devices): a span makes the host
        wait for nothing.  On the CPU the host clock."""
        cards = [d for d in self._cards() if d.type == "cuda"]
        if not cards:
            t0 = time.perf_counter()
            yield
            self.span_s[name] = (self.span_s.get(name, 0.0)
                                 + time.perf_counter() - t0)
            return

        def mark(d):
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(d))
            return e
        starts = [mark(d) for d in cards]
        yield
        self._spans_open.append((name, starts, [mark(d) for d in cards]))

    # ---------------- client-side debug ----------------
    def decrypt_debug(self, ct: Ciphertext, count: int | None = None):
        v = self.decrypt(ct)
        return v[: (count or ct.slots)]
