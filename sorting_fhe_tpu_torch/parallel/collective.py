"""Explicit-collective CKKS key switch over a limb-sharded mesh.

Counterpart of sorting_fhe_tpu/parallel/collective.py: the communication
of a key switch is spelled out, exactly two gathers per op, and the rest
is row-local.

* Digit decomposition: each slot inverse-NTTs its own q rows, converts
  them to plain digit residues xhat and **all_gathers** the [lq, n] xhat
  once; the CRT extension onto its own ext rows (its q rows, then its
  special rows) is then local.  (D-1)/D * lq * n * 4 bytes received per
  slot.
* ModDown: each slot inverse-NTTs its special rows and **all_gathers** the
  [k, ksp, n] plain residues; the correction of its q rows is local.

Everything else is row-local: the tensor product, the forward NTT, the
automorphism (an evaluation-domain permutation of each row), the key
inner product against the slot's key rows and the final add.  Each op is
three phase functions of one slot's block (`_phase1`, `_phase2`,
`_phase3`) with the two gathers between them.

The constants are the context's _LevelTables at the full limb count,
sliced by rows (parallel/mesh.SlotTables): the formulas of the
single-device _kj_decompose, _k_ks_inner and _k_moddown
(core/ckks.py), so the results equal the single-device ops bit for bit,
and the JAX ShardedKeyswitch's too (its Shoup forms give the same
canonical residues).  The NTTs are core/cuda_ntt's with the slot's chain
rows: the hand-written kernels on a card, the plain versions on the CPU.
Shapes must divide the mesh: lq % D == 0 and ksp % D == 0, at the full
limb count only, as in the JAX module.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.ckks import _col, _i32, _k_mult3
from ..core.cuda_ntt import ntt_fwd, ntt_inv
from ..core.rns import add_mod, sub_mod
from .mesh import Mesh, ShardedCiphertext, all_gather, shard_context_tables

I32 = torch.int32
I64 = torch.int64


def _on(device: torch.device):
    """Launch on `device`'s current stream: the kernels' launchers take
    the current CUDA device's context."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _phase1(c1: torch.Tensor, S) -> tuple:
    """One slot's digit residues: the inverse NTT (K2) of its q rows of
    c1 [bq, n] and xhat = [x (D_j / q_a)^-1]_{q_a}.  Returns the
    Montgomery coefficients (int64; the in-digit rows copy them) and xhat
    (int32, what gather 1 moves)."""
    cc = ntt_inv(_i32(c1), S.ntt, S.rows_q).to(I64)
    xhat = cc * S.dig_in.reshape(-1, 1) % S.q_p.reshape(-1, 1)
    return cc, xhat.to(I32)


def _phase2(cc: torch.Tensor, xhat: torch.Tensor, key: torch.Tensor, perm,
            S) -> tuple:
    """One slot's key switch up to ModDown's gather, from the gathered
    xhat [lq, n]: the CRT extension of every digit onto the slot's ext
    rows, whose in-digit q rows are exact copies of cc chosen by the
    slot's local digit ids; the forward NTT (K1); the automorphism (perm,
    rotate only); the inner product with the slot's key rows [dnum, 2,
    ext rows, n]; the inverse NTT (K2) of its special rows and their
    xhat.  Returns the inner product's q rows (int64 [2, bq, n]) and the
    special xhat (int32 [2, bs, n], what gather 2 moves)."""
    bq, n = cc.shape
    pe = S.ext_p.reshape(-1, 1)
    xh = xhat.to(I64)
    ext = torch.empty((len(S.digit_spans), pe.shape[0], n), dtype=I32,
                      device=cc.device)
    for j, (lo, hi) in enumerate(S.digit_spans):
        acc = torch.zeros((pe.shape[0], n), dtype=I64, device=cc.device)
        for a in range(lo, hi):                    # terms < p: no overflow
            acc += xh[a] * S.dig_conv[a].reshape(-1, 1) % pe
        acc %= pe
        acc[:bq] = torch.where(S.in_digit[j], cc, acc[:bq])
        ext[j] = acc
    ext = ntt_fwd(ext, S.ntt, S.rows_ext)
    if perm is not None:
        ext = ext.index_select(-1, perm)
    pe = _col(S.ext_p)
    acc = None
    for j in range(ext.shape[0]):
        term = ext[j][None].to(I64) * key[j] % pe
        acc = term if acc is None else acc.add_(term)
    acc = acc % pe * _col(S.ext_rinv) % pe
    spc = ntt_inv(_i32(acc[:, bq:]), S.ntt, S.rows_sp).to(I64)
    xs = spc * _col(S.md_in) % _col(S.sp_p)
    return acc[:, :bq], xs.to(I32)


def _phase3(acc_q: torch.Tensor, xs: torch.Tensor, S) -> torch.Tensor:
    """One slot's ModDown from the gathered special xhat [2, ksp, n]: the
    conversion onto its q rows, the forward NTT (K1), the subtraction and
    the multiply by P^-1.  Returns int64 [2, bq, n]."""
    qp = _col(S.q_p)
    xs = xs.to(I64)
    conv = torch.zeros_like(acc_q)
    for a in range(xs.shape[1]):
        conv += xs[:, a:a + 1] * _col(S.md_conv[a]) % qp
    conv %= qp
    convn = ntt_fwd(_i32(conv), S.ntt, S.rows_q)
    return sub_mod(acc_q, convn, qp) * _col(S.md_pinv) % qp


class ShardedKeyswitch:
    """mult_relin and rotate of one context at the FULL limb count on a
    mesh, with the two designed gathers per op (the demonstrator config;
    lower levels would shard the same way where lq and ksp divide the
    mesh)."""

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
        self._perms: dict = {}

    # ------------------------------------------------------------------
    def collective_bytes(self, k: int = 1) -> dict:
        """Bytes moved by the explicit collectives of ONE key switch (per
        slot receive volume), for k stacked polys."""
        n, D = self.ctx.n, self.D
        gather1 = (D - 1) * self.lq * n * 4 // D          # digit xhat
        gather2 = (D - 1) * k * self.ksp * n * 4 // D     # moddown sp xhat
        return {"digit_allgather_B": gather1,
                "moddown_allgather_B": gather2,
                "total_B": gather1 + gather2}

    def comm_budget(self, census: dict) -> dict:
        """Projected per-sort receive volume: the designed collective
        bytes x the key-switch op census (every key-switch consumer moves
        exactly the two designed gathers; everything else is row-local).
        census: a CkksContext.op_counts dict."""
        b = self.collective_bytes(k=2)
        ops = {op: census.get(op, 0)
               for op in ("mult_relin", "square_relin", "rotate_fused",
                          "fast_rotate", "relin3")}
        n_ks = sum(ops.values())
        # hoisted rotations share ONE digit gather per decompose: count
        # the moddown gather per op but the digit gather per decompose
        n_dig = n_ks - ops["fast_rotate"] + census.get("decompose", 0)
        total = (n_dig * b["digit_allgather_B"]
                 + n_ks * b["moddown_allgather_B"])
        return {"keyswitch_ops": n_ks, "digit_gathers": n_dig,
                "digit_allgather_B": b["digit_allgather_B"],
                "moddown_allgather_B": b["moddown_allgather_B"],
                "total_receive_B": int(total),
                "total_receive_GB": round(total / 1e9, 3)}

    # ------------------------------------------------------------------
    def _check(self, ct: ShardedCiphertext):
        if ct.limbs != self.lq or len(ct.blocks) != self.D:
            raise ValueError(f"the demonstrator operates at the full limb "
                             f"count {self.lq} on {self.D} slots, got "
                             f"{ct.limbs} limbs in {len(ct.blocks)} blocks")

    def _keyswitch(self, c1s: list, keys: list, perms: list) -> list:
        """Phase 1, gather 1, phase 2, gather 2, phase 3 over every slot:
        ModDown(<decompose(c1), key>) as one int64 [2, bq, n] per slot."""
        slots = self.tables.slots
        p1 = []
        for c1, S in zip(c1s, slots):
            with _on(S.device):
                p1.append(_phase1(c1, S))
        xhat = all_gather([x for _, x in p1], self.mesh, 0, tag="digit")
        p2 = []
        for (cc, _), xh, key, perm, S in zip(p1, xhat, keys, perms, slots):
            with _on(S.device):
                p2.append(_phase2(cc, xh, key, perm, S))
        del p1, xhat
        xs = all_gather([x for _, x in p2], self.mesh, 1, tag="moddown")
        out = []
        for (acc_q, _), x, S in zip(p2, xs, slots):
            with _on(S.device):
                out.append(_phase3(acc_q, x, S))
        return out

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
        dd = self._keyswitch([x[2] for x in d], self.tables.key_blocks(
            "relin", self.ctx.relin_key), [None] * self.D)
        blocks = []
        for x, y, S in zip(d, dd, slots):
            with _on(S.device):
                blocks.append(add_mod(x[:2], y, _col(S.q_p)).to(I32))
        self.ctx.mult_count += 1
        self.ctx.op_counts["mult_relin"] += 1
        return ShardedCiphertext(blocks, a.scale * b.scale, 2, a.slots,
                                 a.limbs)

    def _perm(self, kk: int, device: torch.device) -> torch.Tensor:
        if (kk, device) not in self._perms:
            self._perms[kk, device] = self.ctx._perm(kk).to(device)
        return self._perms[kk, device]

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
        keys = self.tables.keys.get(kk) or self.tables.key_blocks(
            kk, ctx.rot_keys[kk])
        perms = [self._perm(kk, S.device) for S in slots]
        dd = self._keyswitch([c[1] for c in ct.blocks], keys, perms)
        blocks = []
        for c, y, perm, S in zip(ct.blocks, dd, perms, slots):
            with _on(S.device):
                c0 = add_mod(c[0:1].index_select(-1, perm), y[0:1],
                             _col(S.q_p))
                blocks.append(torch.cat([c0, y[1:2]], dim=0).to(I32))
        ctx.rot_count += 1
        ctx.op_counts["rotate_fused"] += 1
        return ShardedCiphertext(blocks, ct.scale, ct.noise_deg, ct.slots,
                                 ct.limbs)
