"""The row-sharded evaluator: a CkksContext whose ops run on a mesh.

Counterpart of the GSPMD half of sorting_fhe_tpu/parallel/mesh.py.  In
the JAX package `shard_context_tables` re-places the context's arrays and
every algorithm then runs unchanged on limb-sharded ciphertexts, GSPMD
working out the collectives.  Here `shard_context(ctx, mesh)` returns a
ShardedContext: the same class of context, sharing ctx's params, keys
and counters, whose ciphertexts and plaintexts hold one row block per
slot (parallel/mesh.py's ragged ownership).  DirectSort, MEHP24's
indicator, poly_eval, the bootstrap (core/bootstrap.py: Bootstrapper and
BootstrapHook) and so the bitonic and k-way sorts run on it unchanged.

It overrides only the context's steps that touch the data (core/ckks.py);
the level and scale bookkeeping is CkksContext's own.  The steps:

* row-local ops (add, sub, negate, the constant and plaintext products,
  the tensor products, the plaintext automorphism, zero padding): each
  slot on its own rows with its slice of the level's constants;
* a level drop narrows each block; no row moves between slots;
* the key switch: parallel/collective.py's phases at the op's level, two
  gathers ("digit", "moddown"); hoisted rotations share the digit gather;
  conjugation is the key switch of tag "conj" (the conjugation key's
  blocks, the automorphism of Galois element 2n-1);
* rescale: the owners of the `comp` dropped rows inverse-NTT them (K2),
  one gather ("rescale") hands the [k, comp, n] coefficient rows to every
  slot, and each slot lifts them, forward-NTTs (K1), subtracts and
  multiplies by q_d^-1 on its own rows.  The drops after the first take
  the dropped rows updated in coefficient form (the NTT is linear mod p),
  so the result equals the single-device rescale bit for bit;
* mod_raise from l0 limbs: the owners of the l0 base rows inverse-NTT
  them (K2), one gather ("raise") hands the [k, l0, n] coefficient rows
  to every slot, and each slot computes the float32 correction count
  from all of them, as the single-device op does (so it rounds the same
  way), extends them onto its own rows of the full chain (its base rows
  exact copies) and forward-NTTs its block (K1);
* client ops: encrypt is the single-device encryptor, then placement;
  decrypt copies the rows it needs to one device; plaintexts are encoded
  by each slot from the host rows of its block, into the sharded
  context's own plaintext cache (the same byte cap).

Under a rotation-key budget the key store, shared with ctx, keeps each
streamed key as its slot blocks (parallel/mesh.MeshTables): the hook
makes the whole key on ctx's device and splits it, the store counts the
blocks' bytes, which are the key's, and evicts them as it would the key,
so the regenerations and the outputs are those of ctx on one device.

Each slot's launches run under torch.cuda.device(slot), which distinct
cards need.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..core import nt
from ..core.ckks import CkksContext, _col, _i32, _k_raise_rows, _kj_encode
from ..core.rns import sub_mod
from .collective import _on, decompose, fwd, inv, keyswitch
from .mesh import (Blocks, Mesh, ShardedCiphertext, all_gather,
                   shard_ciphertext, shard_context_tables, split_rows)

I32 = torch.int32
I64 = torch.int64


def _shared(name: str):
    """An attribute read from and written to the wrapped context."""
    return property(lambda self: getattr(self.base, name),
                    lambda self, v: setattr(self.base, name, v))


class ShardedContext(CkksContext):
    """ctx's evaluator on `mesh`: ciphertexts are ShardedCiphertexts and
    plaintexts hold Blocks.  Counters, keys and the key store are ctx's."""

    ct_type = ShardedCiphertext
    mult_count = _shared("mult_count")
    rot_count = _shared("rot_count")
    precompute_count = _shared("precompute_count")
    pt_encode_s = _shared("pt_encode_s")
    pt_encode_count = _shared("pt_encode_count")
    op_counts = _shared("op_counts")
    relin_key = _shared("relin_key")
    conj_key = _shared("conj_key")

    def __init__(self, ctx: CkksContext, mesh: Mesh):
        shared = {k: v for k, v in vars(ctx).items()
                  if not isinstance(getattr(type(self), k, None), property)}
        self.__dict__.update(shared)
        self.base, self.mesh = ctx, mesh
        tables = getattr(ctx, "mesh_tables", None)
        if tables is None or tables.mesh is not mesh:
            shard_context_tables(ctx, mesh)
        self.mesh_tables = ctx.mesh_tables
        # its own plaintext caches (the same caps): device entries hold
        # every slot's blocks
        self._pt_cache = collections.OrderedDict()
        self._pt_cache_bytes = 0
        self._pt_host_cache = collections.OrderedDict()
        self._pt_host_bytes = 0
        self._rs_slots: dict[int, list] = {}
        self._raise_slots: dict[int, list] = {}

    def shard(self, ct) -> ShardedCiphertext:
        """A single-device Ciphertext of this context placed on the mesh."""
        return shard_ciphertext(ct, self.mesh, self.params.nq)

    def occupancy(self, l: int) -> list:
        """The q rows each slot holds at limb count l."""
        return [max(0, min(hi, l) - lo) for lo, hi in
                self.mesh_tables.q_blocks]

    # ---------------- the steps that touch the data ----------------
    def _local(self, l: int, fn, *args):
        out = Blocks()
        for i, S in enumerate(self.mesh_tables.level(l)):
            with _on(S.device):
                out.append(fn(S, *(a[i] if isinstance(a, Blocks) else a
                                   for a in args)))
        return out

    def _narrow(self, data, limbs: int):
        return Blocks(b[:, :r] for b, r in zip(data, self.occupancy(limbs)))

    def _place(self, data: torch.Tensor):
        return split_rows(data, self.mesh, self.params.nq)

    def _host_rows(self, data, need: int) -> np.ndarray:
        dev = self.mesh.devices[0]
        rows = torch.cat([b[:, :r].to(dev) for b, r in
                          zip(data, self.occupancy(need))], dim=1)
        return rows.cpu().numpy().view(np.uint32)

    def _to_eval_domain(self, rows: np.ndarray, limbs: int):
        host = torch.from_numpy(rows.view(np.int32))
        out = Blocks()
        for (lo, _), S in zip(self.mesh_tables.q_blocks,
                              self.mesh_tables.level(limbs)):
            with _on(S.device):
                x = host[lo:lo + S.lq].to(S.device)
                out.append(_kj_encode(x, S.rmod, S) if S.lq else x)
        return out

    def _decompose(self, c1, l: int):
        return decompose(c1, self.mesh_tables.level(l), self.mesh)

    def _keyswitch(self, exts, tag, l: int):
        slots = self.mesh_tables.level(l)
        keys = self.mesh_tables.blocks(tag)
        perms = [None if tag == "relin" else self._perm(tag, S.device)
                 for S in slots]
        return keyswitch(exts, keys, perms, slots, self.mesh)

    def _rescale_data(self, data, l: int):
        comp = self.params.comp
        top = self.mesh_tables.level(l)
        low = self.mesh_tables.level(l - comp)
        drops = []
        for x, S, F in zip(data, top, low):
            with _on(S.device):
                drops.append(inv(x[:, F.lq:], S, S.rows_q[F.lq:]))
        coeffs = all_gather(drops, self.mesh, 1, tag="rescale")
        out = Blocks()
        for x, c, F, steps in zip(data, coeffs, low, self._rescale_slots(l)):
            with _on(F.device):
                out.append(_rescale_block(x[:, :F.lq], c, F, steps))
        return out

    def _rescale_slots(self, l: int) -> list:
        """Per slot, the rescale's steps from limb count l: (position of
        the dropped row among the comp gathered ones, 2^-32 mod q_d, q_d,
        q_d // 2, q_d mod and q_d^-1 mod the slot's kept rows, and for each
        gathered row still to drop: its position, prime, q_d mod and
        q_d^-1 mod it, R mod it)."""
        if l not in self._rs_slots:
            q, base = self.params.q, l - self.params.comp
            steps = self._rescale_consts(l)
            self._rs_slots[l] = [[
                (idx - base, rinv, qd, half, qd_mod[F.rows_q.long().to(
                    qd_mod.device)].to(F.device), qdinv[F.rows_q.long().to(
                        qdinv.device)].to(F.device),
                 [(d - base, q[d], qd % q[d],
                   nt.mod_inverse(qd % q[d], q[d]), (1 << 32) % q[d])
                  for d in range(base, idx)])
                for idx, rinv, qd, half, qd_mod, qdinv in steps]
                for F in self.mesh_tables.level(base)]
        return self._rs_slots[l]

    def _mod_raise_data(self, data, l0: int):
        base = []
        for x, S in zip(data, self.mesh_tables.level(l0)):
            with _on(S.device):
                base.append(inv(x, S, S.rows_q))
        coeffs = all_gather(base, self.mesh, 1, tag="raise")
        out = Blocks()
        for c, S, consts in zip(coeffs, self.mesh_tables.slots,
                                self._raise_consts_slots(l0)):
            with _on(S.device):
                out.append(fwd(_k_raise_rows(c.to(I64), *consts), S,
                               S.rows_q))
        return out

    def _raise_consts_slots(self, l0: int) -> list:
        """Per slot, _k_raise_rows' constants for a raise from l0 limbs
        onto its rows of the full chain, on its device: w, dinv and the
        primes of the base rows; its columns of Cw and DmodR, its primes
        and the chain index of its first row."""
        if l0 not in self._raise_slots:
            w, Cw, dinv, DmodR = self.base._raise_consts(l0)
            q_lo = self.tables(l0).q_p
            out = []
            for (lo, _), S in zip(self.mesh_tables.q_blocks,
                                  self.mesh_tables.slots):
                rows = S.rows_q.long().to(Cw.device)
                out.append(tuple(t.to(S.device) for t in (
                    w, dinv, q_lo, Cw[:, rows], DmodR[rows])) + (S.q_p, lo))
            self._raise_slots[l0] = out
        return self._raise_slots[l0]

    def sync(self):
        """Wait for every slot's device."""
        for d in dict.fromkeys(self.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ---------------- keys ----------------
    def gen_rotation_keys(self, indices: list[int]):
        """Make the keys on the wrapped context and place their blocks
        (under a budget the keys are only registered: the key store makes
        each one's blocks on first use)."""
        self.base.gen_rotation_keys(indices)
        for kk in self.rot_keys.pinned():
            self.mesh_tables.blocks(kk)

    def gen_conj_key(self):
        """Make the conjugation key on the wrapped context and place its
        blocks."""
        self.base.gen_conj_key()
        self.mesh_tables.blocks("conj")


def _rescale_block(x: torch.Tensor, coeffs: torch.Tensor, F, steps
                   ) -> torch.Tensor:
    """One slot's rescale of its kept rows x [k, lq, n] (F: its tables at
    the lower level) from the gathered coefficient rows [k, comp, n] of
    the dropped primes: _kj_rescale's steps, the rows still to drop
    updated in coefficient form."""
    lc = coeffs.to(I64)
    p = _col(F.q_p)
    for j, rinv, qd, half, qd_mod, qdinv, rest in steps:
        v = lc[:, j:j + 1] * rinv % qd                     # plain [k, 1, n]
        for jj, pd, qm, qi, rm in rest:
            r = v % pd
            r = torch.where(v > half, sub_mod(r, qm, pd), r)
            lc[:, jj:jj + 1] = sub_mod(lc[:, jj:jj + 1], r * rm % pd,
                                       pd) * qi % pd
        if F.lq:
            r = v % p
            r = torch.where(v > half, sub_mod(r, _col(qd_mod), p), r)
            rn = fwd(r * _col(F.rmod) % p, F, F.rows_q)
            x = (sub_mod(x, rn, p) * _col(qdinv) % p).to(I32)
    return _i32(x)


def shard_context(ctx: CkksContext, mesh: Mesh) -> ShardedContext:
    """ctx's evaluator on the mesh: the counterpart of JAX's
    shard_context_tables followed by ordinary calls.  Shard its
    ciphertexts with ShardedContext.shard (or shard_ciphertext at the full
    level)."""
    return ShardedContext(ctx, mesh)
