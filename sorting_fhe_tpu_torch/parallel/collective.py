"""Explicit-collective CKKS key switch over a limb-sharded mesh.

Counterpart of sorting_fhe_tpu/parallel/collective.py: the communication
of a key switch is spelled out, exactly two gathers per op, and the rest
is row-local.

* Digit decomposition: each slot inverse-NTTs its own q rows, converts
  them to plain digit residues xhat and **all_gathers** the [l, n] xhat
  once; the CRT extension onto its own ext rows (its q rows, then its
  special rows) is then local.  (D-1)/D * l * n * 4 bytes received per
  slot.
* ModDown: each slot inverse-NTTs its special rows and **all_gathers** the
  [k, ksp, n] plain residues; the correction of its q rows is local.

Everything else is row-local: the tensor product, the forward NTT, the
automorphism (an evaluation-domain permutation of each row), the key
inner product against the slot's key rows and the final add.  A key
switch is `decompose` (phase 1, the digit gather, the extension) and
`keyswitch` (the inner product, the ModDown gather, phase 3): hoisted
rotations share one `decompose`, as the single-device context's
fast_rotation_precompute does.

The constants are the context's _LevelTables of the op's limb count,
sliced by rows (parallel/mesh.SlotTables): the formulas of the
single-device _kj_decompose and _k_ks_moddown (core/ckks.py), whose key
inner product and ModDown tail are the same functions
(core/cuda_keyswitch.py), so the results equal the single-device ops bit
for bit, and the JAX ShardedKeyswitch's too (its Shoup forms give the
same canonical residues).  The NTTs are core/cuda_ntt's with the slot's
chain rows: the hand-written kernels on a card, the plain versions on
the CPU; a slot with no rows of a kind launches nothing for them.  The
phases take any level and ragged blocks; `ShardedKeyswitch`, the JAX
module's demonstrator, keeps its contract: the full limb count, rows
dividing the mesh.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.ckks import _col, _i32, _k_mult3
from ..core.cuda_basis import base_conv
from ..core.cuda_keyswitch import ks_inner, moddown_tail
from ..core.cuda_ntt import ntt_fwd, ntt_inv
from ..core.rns import add_mod
from .mesh import (Blocks, Mesh, ShardedCiphertext, all_gather,
                   shard_context_tables)

I32 = torch.int32
I64 = torch.int64


def _on(device: torch.device):
    """Launch on `device`'s current stream: the kernels' launchers take
    the current CUDA device's context."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def fwd(x: torch.Tensor, S, rows: torch.Tensor) -> torch.Tensor:
    """K1 on the slot's chain `rows` of x (int32), nothing for no rows."""
    x = _i32(x)
    return ntt_fwd(x, S.ntt, rows) if rows.numel() else x


def inv(x: torch.Tensor, S, rows: torch.Tensor) -> torch.Tensor:
    """K2 on the slot's chain `rows` of x (int32), nothing for no rows."""
    x = _i32(x)
    return ntt_inv(x, S.ntt, rows) if rows.numel() else x


def _phase1(c1: torch.Tensor, S) -> tuple:
    """One slot's digit residues: the inverse NTT (K2) of its q rows of
    c1 [lq, n] and xhat = [x (D_j / q_a)^-1]_{q_a}.  Returns the
    Montgomery coefficients (int32; the in-digit rows copy them) and xhat
    (int32, what the digit gather moves)."""
    cc = inv(c1, S, S.rows_q)
    xhat = cc * S.dig_in.reshape(-1, 1) % S.q_p.reshape(-1, 1)
    return cc, xhat.to(I32)


def _extend(cc: torch.Tensor, xhat: torch.Tensor, S) -> torch.Tensor:
    """One slot's hoisted digits from the gathered xhat [l, n]: the CRT
    extension of every digit onto the slot's ext rows (one base_conv),
    whose in-digit q rows are exact copies of cc chosen by the slot's
    local digit ids, and the forward NTT (K1).  int32 [ndig, ext rows,
    n]."""
    lq = cc.shape[0]
    ext = base_conv(xhat[None], S.dig_conv, S.ext_p, S.alpha)[0]
    for j in range(ext.shape[0]):
        ext[j, :lq] = torch.where(S.in_digit[j], cc, ext[j, :lq])
    return fwd(ext, S, S.rows_ext)


def _inner(ext: torch.Tensor, key: torch.Tensor, perm, S) -> tuple:
    """One slot's key switch up to ModDown's gather: the inner product of
    its digits, read through the automorphism perm (rotations only), with
    its rows of its full-level key block [>= ndig, 2, bq + special rows,
    n] (core/cuda_keyswitch.ks_inner), the inverse NTT (K2) of its special
    rows and their xhat.  Returns the inner product's q rows (int32 [2,
    lq, n]) and the special xhat (int32 [2, special rows, n], what the
    ModDown gather moves)."""
    acc_q, acc_sp = ks_inner(ext, key, S.ext_p, S.ext_rinv, S.lq, S.bq,
                             perm)
    spc = inv(acc_sp, S, S.rows_sp).to(I64)
    xs = spc * _col(S.md_in) % _col(S.sp_p)
    return acc_q, xs.to(I32)


def _phase3(acc_q: torch.Tensor, xs: torch.Tensor, S) -> torch.Tensor:
    """One slot's ModDown from the gathered special xhat [2, ksp, n]: the
    conversion onto its q rows, the forward NTT (K1), then the subtraction
    and the multiply by P^-1 (core/cuda_keyswitch.moddown_tail).  Returns
    int32 [2, lq, n]."""
    if not S.lq:
        return acc_q
    conv = base_conv(xs, S.md_conv, S.q_p, xs.shape[1])[:, 0]
    return moddown_tail(acc_q, fwd(conv, S, S.rows_q), S.q_p, S.md_pinv)


def decompose(c1s: list, slots: list, mesh: Mesh) -> Blocks:
    """Every slot's hoisted ext digits of one poly (c1s: its [lq, n]
    block per slot): phase 1, the digit gather, the extension."""
    p1 = []
    for c1, S in zip(c1s, slots):
        with _on(S.device):
            p1.append(_phase1(c1, S))
    xhat = all_gather([x for _, x in p1], mesh, 0, tag="digit")
    out = Blocks()
    for (cc, _), xh, S in zip(p1, xhat, slots):
        with _on(S.device):
            out.append(_extend(cc, xh, S))
    return out


def keyswitch(exts: list, keys: list, perms: list, slots: list,
              mesh: Mesh) -> Blocks:
    """ModDown(<exts, key>) as one int32 [2, lq, n] per slot: the inner
    product with each slot's full-level key block (its rows at the level
    read in place), the ModDown gather, phase 3."""
    p2 = []
    for ext, key, perm, S in zip(exts, keys, perms, slots):
        with _on(S.device):
            p2.append(_inner(ext, key, perm, S))
    xs = all_gather([x for _, x in p2], mesh, 1, tag="moddown")
    out = Blocks()
    for (acc_q, _), x, S in zip(p2, xs, slots):
        with _on(S.device):
            out.append(_phase3(acc_q, x, S))
    return out


def collective_bytes(n: int, D: int, lq: int, ksp: int, k: int = 1) -> dict:
    """Bytes moved by the explicit collectives of ONE key switch at lq q
    rows (per slot receive volume) on D slots, for k stacked polys."""
    gather1 = (D - 1) * lq * n * 4 // D          # digit xhat
    gather2 = (D - 1) * k * ksp * n * 4 // D     # moddown sp xhat
    return {"digit_allgather_B": gather1, "moddown_allgather_B": gather2,
            "total_B": gather1 + gather2}


def comm_budget(census: dict, n: int, D: int, lq: int, ksp: int) -> dict:
    """Projected per-sort receive volume: the designed collective bytes of
    a key switch at lq q rows x the key-switch op census (every
    key-switch consumer moves exactly the two designed gathers;
    everything else is row-local).  census: a CkksContext.op_counts
    dict."""
    b = collective_bytes(n, D, lq, ksp, k=2)
    ops = {op: census.get(op, 0)
           for op in ("mult_relin", "square_relin", "rotate_fused",
                      "fast_rotate", "relin3")}
    n_ks = sum(ops.values())
    # hoisted rotations share ONE digit gather per decompose: count the
    # moddown gather per op but the digit gather per decompose
    n_dig = n_ks - ops["fast_rotate"] + census.get("decompose", 0)
    total = (n_dig * b["digit_allgather_B"]
             + n_ks * b["moddown_allgather_B"])
    return {"keyswitch_ops": n_ks, "digit_gathers": n_dig,
            "digit_allgather_B": b["digit_allgather_B"],
            "moddown_allgather_B": b["moddown_allgather_B"],
            "total_receive_B": int(total),
            "total_receive_GB": round(total / 1e9, 3)}


class ShardedKeyswitch:
    """mult_relin and rotate of one context at the FULL limb count on a
    mesh whose size divides the q and special row counts, with the two
    designed gathers per op (the JAX module's demonstrator; the
    row-sharded evaluator, parallel/evaluator.py, runs the same phases at
    every level on ragged blocks)."""

    def __init__(self, ctx, mesh: Mesh):
        P = ctx.params
        D = mesh.size
        lq, ksp = P.nq, P.num_special
        if lq % D or ksp % D:
            raise ValueError(f"lq={lq} and ksp={ksp} must divide mesh size "
                             f"{D}")
        self.ctx, self.mesh = ctx, mesh
        self.lq, self.ksp, self.D = lq, ksp, D
        tables = getattr(ctx, "mesh_tables", None)
        if tables is None or tables.mesh is not mesh:
            shard_context_tables(ctx, mesh)
        self.tables = ctx.mesh_tables

    # ------------------------------------------------------------------
    def collective_bytes(self, k: int = 1) -> dict:
        return collective_bytes(self.ctx.n, self.D, self.lq, self.ksp, k)

    def comm_budget(self, census: dict) -> dict:
        return comm_budget(census, self.ctx.n, self.D, self.lq, self.ksp)

    # ------------------------------------------------------------------
    def _check(self, ct: ShardedCiphertext):
        if ct.limbs != self.lq or len(ct.blocks) != self.D:
            raise ValueError(f"the demonstrator operates at the full limb "
                             f"count {self.lq} on {self.D} slots, got "
                             f"{ct.limbs} limbs in {len(ct.blocks)} blocks")

    def _keyswitch(self, c1s: list, keys: list, perms: list) -> Blocks:
        slots = self.tables.slots
        return keyswitch(decompose(c1s, slots, self.mesh), keys, perms,
                         slots, self.mesh)

    def mult_relin(self, a: ShardedCiphertext,
                   b: ShardedCiphertext) -> ShardedCiphertext:
        """Explicit-collective EvalMultAndRelinearize at full level."""
        self._check(a)
        self._check(b)
        slots = self.tables.slots
        d = []
        for x, y, S in zip(a.blocks, b.blocks, slots):
            with _on(S.device):
                d.append(_k_mult3(x, y, S.q_p, S.q_rinv))
        dd = self._keyswitch([x[2] for x in d], self.tables.blocks("relin"),
                             [None] * self.D)
        blocks = Blocks()
        for x, y, S in zip(d, dd, slots):
            with _on(S.device):
                blocks.append(add_mod(x[:2], y, _col(S.q_p)).to(I32))
        self.ctx.mult_count += 1
        self.ctx.op_counts["mult_relin"] += 1
        return ShardedCiphertext(blocks, a.scale * b.scale, 2, a.slots)

    def rotate(self, ct: ShardedCiphertext, k: int) -> ShardedCiphertext:
        """Explicit-collective fused EvalRotate at full level."""
        self._check(ct)
        ctx = self.ctx
        kk = k % (ctx.n // 2)
        if kk == 0 or k % ct.slots == 0:
            return ct
        if kk not in ctx.rot_keys:
            raise KeyError(f"missing rotation key {k}")
        slots = self.tables.slots
        keys = self.tables.blocks(kk)
        perms = [ctx._perm(kk, S.device) for S in slots]
        dd = self._keyswitch([c[1] for c in ct.blocks], keys, perms)
        blocks = Blocks()
        for c, y, perm, S in zip(ct.blocks, dd, perms, slots):
            with _on(S.device):
                c0 = add_mod(c[0:1].index_select(-1, perm), y[0:1],
                             _col(S.q_p))
                blocks.append(torch.cat([c0, y[1:2]], dim=0).to(I32))
        ctx.rot_count += 1
        ctx.op_counts["rotate_fused"] += 1
        return ShardedCiphertext(blocks, ct.scale, ct.noise_deg, ct.slots)
