"""Limb-sharded placement of a CKKS context on a mesh of devices.

Counterpart of sorting_fhe_tpu/parallel/mesh.py.  A `Mesh` is a list of
torch devices, its slots, along one axis, "limb": the RNS row axis of
[k, limbs, n] ciphertexts, [dnum, 2, rows, n] key-switching keys and
[rows, n] tables is cut into one contiguous block of rows per slot.  A
list that repeats one device is a virtual mesh on that device, as the
JAX tests run on 8 virtual CPU devices; distinct CUDA devices make a real
one.  The mesh is a single controller, as `shard_map` over a JAX mesh
is: one process holds every slot's block, and the one collective,
`all_gather`, copies every block to every slot's device (peer copies
between cards, copies within device memory on one card).

The one difference from the JAX module: there, `shard_context_tables`
re-places the context's own arrays, and GSPMD then runs every algorithm
unchanged on the sharded context.  No PyTorch compiler infers those
gathers, so here the context's single-device tensors and ops are left as
they are, and `shard_context_tables` keeps the slots' row blocks beside
them, on `ctx.mesh_tables`, where the explicit key switch of
parallel/collective.py reads them.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.ckks import Ciphertext
from ..core.device import resolve_device

I32 = torch.int32


@dataclass
class Mesh:
    """Slots along one mesh axis; `gather_log` records every all_gather
    (tag, gathered shape, dtype, bytes received per slot)."""
    devices: list
    axis: str = "limb"
    gather_log: list = field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    """torch.device with the index a CUDA tensor reports (cuda -> cuda:i)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, axis: str = "limb",
              devices=None) -> Mesh:
    """A mesh over `devices` (default: every CUDA device torch finds; with
    none, this raises: a CPU mesh is asked for by passing CPU devices,
    e.g. [torch.device("cpu")] * 8), cut to the first n_devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch finds no CUDA device; pass devices="
                "[torch.device('cpu')] * k for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, axis)


def limb_sharding(mesh: Mesh) -> tuple:
    """[k, limbs, n] ciphertext data sharded over the limb axis.  A
    sharding is a spec, as JAX's PartitionSpec: the mesh axis at the
    dimension cut into one block per slot, None where the dimension is
    whole; dimensions past the spec are whole."""
    return (None, mesh.axis, None)


def key_sharding(mesh: Mesh) -> tuple:
    """[dnum, 2, rows, n] key-switching keys sharded over the row axis."""
    return (None, None, mesh.axis, None)


def table_sharding(mesh: Mesh) -> tuple:
    """[limbs, n] tables sharded like the data."""
    return (mesh.axis, None)


def replicated(mesh: Mesh) -> tuple:
    return ()


def _spec(shape, mesh: Mesh, sharding: tuple) -> tuple:
    """The spec `_put` places with: a dimension that the sharding splits
    and the mesh size does not divide stays whole (replicated), as key and
    table row counts are set by the crypto depth, not by the mesh."""
    spec = tuple(sharding) + (None,) * (len(shape) - len(sharding))
    return tuple(s if s is None or shape[i] % mesh.size == 0 else None
                 for i, s in enumerate(spec))


def _put(t: torch.Tensor, mesh: Mesh, sharding: tuple) -> list:
    """One tensor per slot, on that slot's device: the slot's block of the
    split dimension, or the whole tensor where `_spec` replicates it."""
    split = [i for i, s in enumerate(_spec(t.shape, mesh, sharding))
             if s is not None]
    if not split:
        return [t.to(d) for d in mesh.devices]
    (dim,) = split
    b = t.shape[dim] // mesh.size
    return [t.narrow(dim, i * b, b).to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def all_gather(blocks: list, mesh: Mesh, axis: int, tag: str) -> list:
    """The mesh's one collective (JAX's tiled all_gather): for each slot,
    every slot's block copied to its device and concatenated along `axis`
    in slot order.  Appends the call to mesh.gather_log, with the bytes
    each slot receives from the others, (D-1)/D of the gathered tensor
    for equal blocks, as ShardedKeyswitch.collective_bytes counts them."""
    out = [torch.cat([b.to(d) for b in blocks], dim=axis)
           for d in mesh.devices]
    total = out[0].numel() * out[0].element_size()
    mesh.gather_log.append({
        "tag": tag, "shape": list(out[0].shape), "dtype": str(out[0].dtype),
        "bytes_per_slot": (mesh.size - 1) * total // mesh.size})
    return out


@dataclass
class ShardedCiphertext:
    """A ciphertext as one row block per slot, each on its slot's device:
    int32 [k, limbs / D, n] (the whole [k, limbs, n] on every slot where
    D does not divide limbs), NTT + Montgomery domain."""
    blocks: list
    scale: float
    noise_deg: int
    slots: int
    limbs: int

    @property
    def k(self) -> int:
        return self.blocks[0].shape[0]

    def gather(self, device=None) -> Ciphertext:
        """The port's Ciphertext on `device` (the first slot's by default),
        bit for bit the data that was sharded."""
        device = self.blocks[0].device if device is None else device
        if self.blocks[0].shape[1] == self.limbs:
            data = self.blocks[0].to(device)
        else:
            data = torch.cat([b.to(device) for b in self.blocks], dim=1)
        return Ciphertext(data, self.scale, self.noise_deg, self.slots)


def shard_ciphertext(ct: Ciphertext, mesh: Mesh) -> ShardedCiphertext:
    """Place a Ciphertext's data on the mesh, limb-sharded."""
    return ShardedCiphertext(_put(ct.data, mesh, limb_sharding(mesh)),
                             ct.scale, ct.noise_deg, ct.slots, ct.limbs)


def _row_blocks(count: int, mesh: Mesh) -> list:
    """Each slot's indices of `count` rows, as _put places a [count]
    vector: a block of count / D rows, or every row where D does not
    divide count.  Host int64 tensors."""
    return [b.cpu() for b in _put(torch.arange(count), mesh,
                                  (mesh.axis,))]


class SlotTables:
    """One slot's share of the full-level tables, on its device.

    Rows: its q rows `rows_q` and its special rows `rows_sp` (chain rows
    nq + i); its ext rows are the two blocks in that order.  Constants are
    the context's _LevelTables at the full limb count, sliced by those
    rows: the primes, 2^-32 mod p of the ext rows, the digit decomposition
    (dig_in per q row; dig_conv [lq, ext rows], every digit's rows a over
    the slot's columns; the digit spans and, per digit, which of the
    slot's q rows lie in it) and ModDown (md_in per special row, md_conv
    [ksp, q rows], md_pinv per q row).  `ntt` is the chain's NttContext on
    the slot's device: the NTT wrappers take the chain rows."""

    def __init__(self, P, T, rq, rs, device, ntt):
        """rq, rs: host int64 indices of the slot's q and special rows."""
        l = T.l
        here = T.q_p.device
        q, s = rq.to(here), rs.to(here)
        e = torch.cat([q, l + s])              # the slot's ext columns

        def on(x):
            return x.to(device)

        self.device = device
        self.ntt = ntt
        self.rows_q = on(rq.to(I32))
        self.rows_sp = on((P.nq + rs).to(I32))
        self.rows_ext = torch.cat([self.rows_q, self.rows_sp])
        self.q_p, self.sp_p, self.ext_p = on(T.q_p[q]), on(T.sp_p[s]), \
            on(T.ext_p[e])
        self.q_rinv, self.ext_rinv = on(T.q_rinv[q]), on(T.ext_rinv[e])
        self.dig_in = on(torch.cat(T.dig_in)[q])
        self.dig_conv = on(torch.cat(T.dig_conv)[:, e])
        self.digit_spans = [(d[0], d[-1] + 1) for d in T.digits]
        digit_of = np.empty(l, dtype=np.int64)
        for j, d in enumerate(T.digits):
            digit_of[d] = j
        local = torch.from_numpy(digit_of[rq.numpy()])   # local digit ids
        self.in_digit = on(torch.stack([(local == j).reshape(-1, 1)
                                        for j in range(T.ndig)]))
        self.md_in = on(T.md_in[s])
        self.md_conv = on(T.md_conv[:, q])
        self.md_pinv = on(T.md_pinv[q])


class MeshTables:
    """Every slot's SlotTables at the full limb count, and the key blocks:
    a [dnum, 2, nq + ksp, n] key as one [dnum, 2, ext rows, n] block per
    slot (its q rows, then its special rows), taken when the key is first
    placed."""

    def __init__(self, ctx, mesh: Mesh):
        P = ctx.params
        T = ctx.tables(P.nq)
        self.mesh = mesh
        ntts = {}
        for d in mesh.devices:
            if d not in ntts:
                ntts[d] = _ntt_on(P.ntt, d)
        self.slots = [SlotTables(P, T, rq, rs, d, ntts[d]) for rq, rs, d in
                      zip(_row_blocks(P.nq, mesh),
                          _row_blocks(P.num_special, mesh), mesh.devices)]
        self.keys: dict = {}
        self.key_blocks("relin", ctx.relin_key)
        for kk in list(ctx.rot_keys):
            self.key_blocks(kk, ctx.rot_keys[kk])

    def key_blocks(self, tag, key: torch.Tensor) -> list:
        """The slots' blocks of the key placed under `tag` (a rotation
        index or "relin"), placing `key` on first use."""
        if tag not in self.keys:
            self.keys[tag] = [
                key.index_select(2, S.rows_ext.to(key.device).long()).to(
                    S.device) for S in self.slots]
        return self.keys[tag]


def _ntt_on(ntt, device: torch.device):
    """The NttContext with its tables on `device` (itself if there)."""
    if ntt.p.device == device:
        return ntt
    out = copy.copy(ntt)
    for name in ("p", "psi", "psi_sh", "ipsi", "ipsi_sh", "n_inv",
                 "n_inv_sh"):
        setattr(out, name, getattr(ntt, name).to(device))
    return out


def shard_context_tables(ctx, mesh: Mesh):
    """Give every slot its row blocks of the full-level tables and keys
    (MeshTables) and keep them on ctx.mesh_tables; the context's own
    tensors and ops are unchanged.  Returns the context."""
    ctx.mesh_tables = MeshTables(ctx, mesh)
    return ctx
