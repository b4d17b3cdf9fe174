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

Row ownership is fixed by the full chain: slot i owns the contiguous
block of ceil(nq / D) q rows (and ceil(ksp / D) special rows) that starts
at i * ceil(nq / D); the last blocks may be shorter or empty.  At level l
a slot holds the rows of its block that are below l, so dropping levels
narrows blocks and never moves rows between slots.

The one difference from the JAX module: there, `shard_context_tables`
re-places the context's own arrays, and GSPMD then runs every algorithm
unchanged on the sharded context.  No PyTorch compiler infers those
gathers, so here `shard_context_tables` keeps the slots' row blocks of
the tables and keys beside the context's own tensors, on
`ctx.mesh_tables`, where the explicit key switch (parallel/collective.py)
and the row-sharded evaluator (parallel/evaluator.py) read them.
"""

from __future__ import annotations

import collections
import copy
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.ckks import Ciphertext
from ..core.device import resolve_device

I32 = torch.int32


@dataclass
class Mesh:
    """Slots along one mesh axis.  Every all_gather is recorded in
    `gather_log` (tag, gathered shape, dtype, bytes received per slot)
    and added to `gathers` (per tag: the count and the summed bytes per
    slot), which a long run reads instead of the log."""
    devices: list
    axis: str = "limb"
    gather_log: list = field(default_factory=list)
    gathers: dict = field(default_factory=lambda: collections.defaultdict(
        lambda: {"count": 0, "bytes_per_slot": 0}))

    @property
    def size(self) -> int:
        return len(self.devices)

    def clear_gathers(self):
        """Empty the log and the per-tag totals."""
        self.gather_log.clear()
        self.gathers.clear()


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
    and the mesh size does not divide stays whole (replicated), as JAX
    places key and table row counts set by the crypto depth."""
    spec = tuple(sharding) + (None,) * (len(shape) - len(sharding))
    return tuple(s if s is None or shape[i] % mesh.size == 0 else None
                 for i, s in enumerate(spec))


def _put(t: torch.Tensor, mesh: Mesh, sharding: tuple) -> list:
    """One tensor per slot, on that slot's device: the slot's block of the
    split dimension, or the whole tensor where `_spec` replicates it (the
    JAX placement; the evaluator's ragged row blocks are `split_rows`)."""
    split = [i for i, s in enumerate(_spec(t.shape, mesh, sharding))
             if s is not None]
    if not split:
        return [t.to(d) for d in mesh.devices]
    (dim,) = split
    b = t.shape[dim] // mesh.size
    return [t.narrow(dim, i * b, b).to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def row_blocks(count: int, slots: int) -> list:
    """(lo, hi) of each slot's contiguous block of `count` rows: ceil(count
    / slots) rows each, the last blocks shorter or empty."""
    b = -(-count // slots)
    return [(min(i * b, count), min((i + 1) * b, count))
            for i in range(slots)]


class Blocks(list):
    """One tensor per slot, each the slot's rows (dimension -2) of one
    logical [..., rows, n] tensor; `shape` is the logical shape."""

    @property
    def shape(self) -> tuple:
        first = self[0]
        return tuple(first.shape[:-2]) + (
            sum(b.shape[-2] for b in self), first.shape[-1])


def split_rows(t: torch.Tensor, mesh: Mesh, count: int | None = None
               ) -> Blocks:
    """t's rows (dimension -2) as ragged row blocks on the mesh's devices:
    slot i takes the rows of its block of row_blocks(count) that t has
    (count: the row count that fixes ownership, t's own by default)."""
    rows = t.shape[-2]
    out = Blocks()
    for (lo, hi), d in zip(row_blocks(count or rows, mesh.size),
                           mesh.devices):
        lo, hi = min(lo, rows), min(hi, rows)
        out.append(t.narrow(-2, lo, hi - lo).to(d).contiguous())
    return out


def all_gather(blocks: list, mesh: Mesh, axis: int, tag: str) -> list:
    """The mesh's one collective (JAX's tiled all_gather): for each slot,
    every slot's block copied to its device and concatenated along `axis`
    in slot order.  Logs the call on the mesh with the bytes each slot
    receives from the others, on average over the slots: (D-1)/D of the
    gathered tensor, whatever the blocks' sizes (what
    ShardedKeyswitch.collective_bytes counts)."""
    out = [torch.cat([b.to(d) for b in blocks], dim=axis)
           for d in mesh.devices]
    total = out[0].numel() * out[0].element_size()
    received = (mesh.size - 1) * total // mesh.size
    mesh.gather_log.append({
        "tag": tag, "shape": list(out[0].shape), "dtype": str(out[0].dtype),
        "bytes_per_slot": received})
    mesh.gathers[tag]["count"] += 1
    mesh.gathers[tag]["bytes_per_slot"] += received
    return out


class ShardedCiphertext(Ciphertext):
    """A ciphertext whose data is Blocks: int32 [k, rows, n] per slot, each
    on its slot's device, NTT + Montgomery domain.  `limbs`, `k`, the
    metadata and dataclasses.replace work as on a Ciphertext."""

    @property
    def blocks(self) -> Blocks:
        return self.data

    def gather(self, device=None) -> Ciphertext:
        """The port's Ciphertext on `device` (the first slot's by default),
        bit for bit the data that was sharded."""
        device = self.data[0].device if device is None else device
        return Ciphertext(torch.cat([b.to(device) for b in self.data], dim=1),
                          self.scale, self.noise_deg, self.slots)


def shard_ciphertext(ct: Ciphertext, mesh: Mesh,
                     count: int | None = None) -> ShardedCiphertext:
    """Place a Ciphertext's data on the mesh in ragged row blocks (count:
    the row count that fixes ownership, the chain's nq for a ciphertext
    below the full level; ct.limbs by default)."""
    return ShardedCiphertext(split_rows(ct.data, mesh, count), ct.scale,
                             ct.noise_deg, ct.slots)


class SlotTables:
    """One slot's share of the tables of limb count l, on its device.

    Rows: its q rows below l, `rows_q` (`lq` of them, from its block of
    `bq` rows), and its special rows `rows_sp` (chain rows nq + i); its
    ext rows are the two in that order.  Constants are the context's
    _LevelTables of limb count l sliced by those rows: the primes,
    2^-32 mod p of the ext rows, R mod q (`rmod`), the primes as Python
    ints (`q_host`), the digit decomposition of level l (dig_in per q
    row; dig_conv [l, ext rows], every digit's rows over the slot's
    columns; the digit width `alpha` and, per digit, which of the slot's
    q rows lie in it) and ModDown (md_in per special row, md_conv [ksp, q
    rows], md_pinv per q row).  `ntt` is the chain's NttContext on the
    slot's device: the NTT wrappers take the chain rows."""

    def __init__(self, P, T, rq, rs, bq, device, ntt):
        """rq, rs: host int64 indices of the slot's q rows below T.l and of
        its special rows; bq: the size of its q block."""
        l = T.l
        here = T.q_p.device
        q, s = rq.to(here), rs.to(here)
        e = torch.cat([q, l + s])              # the slot's ext columns

        def on(x):
            return x.to(device)

        self.l, self.lq, self.bq = l, len(rq), bq
        self.device = device
        self.ntt = ntt
        self.q_host = [P.q[i] for i in rq.tolist()]
        self.rows_q = on(rq.to(I32))
        self.rows_sp = on((P.nq + rs).to(I32))
        self.rows_ext = torch.cat([self.rows_q, self.rows_sp])
        self.q_p, self.sp_p, self.ext_p = on(T.q_p[q]), on(T.sp_p[s]), \
            on(T.ext_p[e])
        self.q_rinv, self.ext_rinv = on(T.q_rinv[q]), on(T.ext_rinv[e])
        self.rmod = on(T.rmod[q])
        self.dig_in = on(T.dig_in[q])
        self.dig_conv = on(T.dig_conv[:, e])
        self.alpha = T.alpha
        digit_of = np.empty(l, dtype=np.int64)
        for j, d in enumerate(T.digits):
            digit_of[d] = j
        local = torch.from_numpy(digit_of[rq.numpy()])   # local digit ids
        self.in_digit = on(torch.stack([(local == j).reshape(-1, 1)
                                        for j in range(T.ndig)]))
        self.md_in = on(T.md_in[s])
        self.md_conv = on(T.md_conv[:, q])
        self.md_pinv = on(T.md_pinv[q])


class KeyBlocks(Blocks):
    """A [dnum, 2, nq + ksp, n] key as one [dnum, 2, bq + bs, n] block per
    slot of `mesh` (its q rows, then its special rows; `q_rows` gives each
    slot's bq).  Every row of the key lies in one block, so `nbytes` is
    the whole key's: the key store counts a streamed key's blocks as it
    counts the key on one device."""

    def __init__(self, blocks, mesh: Mesh, q_rows: list):
        super().__init__(blocks)
        self.mesh, self.q_rows = mesh, q_rows

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self)

    def whole(self, device=None) -> torch.Tensor:
        """The key with its rows in chain order, on `device` (the first
        slot's by default)."""
        device = self[0].device if device is None else device
        return torch.cat([b[:, :, :r].to(device)
                          for b, r in zip(self, self.q_rows)]
                         + [b[:, :, r:].to(device)
                            for b, r in zip(self, self.q_rows)], dim=2)


class MeshTables:
    """Every slot's SlotTables, made per limb count on first use and kept
    (`level(l)`; `slots` is the full level's), and the keys' slot blocks
    (KeyBlocks), which follow row_blocks(nq) and row_blocks(ksp).

    `keys` keeps the blocks of the relinearisation, conjugation and
    pinned rotation keys, placed on first use.  A streamed rotation key
    (the key store's budget path) is never kept here: the store's hook
    (CkksContext._regen_rot_key) splits each key it makes into this
    mesh's blocks, the store keeps those in place of the whole key, and
    they leave with its eviction; the cached whole keys of the store are
    dropped here, as they are not in that form."""

    def __init__(self, ctx, mesh: Mesh):
        P = ctx.params
        self.mesh = mesh
        self._ctx = weakref.ref(ctx)     # the context keeps this object
        self.q_blocks = row_blocks(P.nq, mesh.size)
        self.sp_blocks = row_blocks(P.num_special, mesh.size)
        ntts = {}
        for d in mesh.devices:
            if d not in ntts:
                ntts[d] = _ntt_on(P.ntt, d)
        self.ntts = [ntts[d] for d in mesh.devices]
        self._levels: dict = {}
        self.keys: dict = {}
        self.blocks("relin")
        ctx.rot_keys.evict_all()
        for kk in ctx.rot_keys.pinned():
            self.blocks(kk)

    def level(self, l: int) -> list:
        """The slots' SlotTables of limb count l."""
        if l not in self._levels:
            ctx = self._ctx()
            P, T = ctx.params, ctx.tables(l)
            self._levels[l] = [
                SlotTables(P, T, torch.arange(lo, max(lo, min(hi, l))),
                           torch.arange(slo, shi), hi - lo, d, ntt)
                for (lo, hi), (slo, shi), d, ntt in zip(
                    self.q_blocks, self.sp_blocks, self.mesh.devices,
                    self.ntts)]
        return self._levels[l]

    @property
    def slots(self) -> list:
        return self.level(self.q_blocks[-1][1])

    def split_key(self, key: torch.Tensor) -> KeyBlocks:
        """A whole key's slot blocks, each on its slot's device."""
        nq = self.q_blocks[-1][1]
        return KeyBlocks([
            key.index_select(2, torch.cat([
                torch.arange(lo, hi), nq + torch.arange(slo, shi)]).to(
                    key.device)).to(d)
            for (lo, hi), (slo, shi), d in zip(
                self.q_blocks, self.sp_blocks, self.mesh.devices)],
            self.mesh, [hi - lo for lo, hi in self.q_blocks])

    def blocks(self, tag) -> KeyBlocks:
        """The slots' blocks of the context's key of `tag` (a rotation
        index, "relin" or "conj") as the context keeps it now: placed on
        first use and kept in `keys`, except a streamed rotation's, which
        is the key store's current entry (made again if it was evicted)."""
        if tag in self.keys:
            return self.keys[tag]
        ctx = self._ctx()
        key = ctx._key_entry(tag)
        if isinstance(key, KeyBlocks):
            if key.mesh is self.mesh:
                return key
            key = key.whole()
        blocks = self.split_key(key)
        if tag in ("relin", "conj") or ctx.rot_keys.is_pinned(tag):
            self.keys[tag] = blocks
        return blocks


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
    """Give every slot its row blocks of the tables and keys (MeshTables)
    and keep them on ctx.mesh_tables; the context's own tensors and ops
    are unchanged (parallel/evaluator.shard_context gives a context whose
    ops run on the mesh).  Under a rotation-key budget only the pinned
    keys are placed here and the key store makes the others' blocks on
    demand (the JAX function makes and pins every registered key, which
    breaks the budget).  Returns the context."""
    ctx.mesh_tables = MeshTables(ctx, mesh)
    return ctx
