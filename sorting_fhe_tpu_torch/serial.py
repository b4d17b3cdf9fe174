"""Serialization: the five-artifact client/server protocol.

Counterpart of sorting_fhe_tpu/serial.py, with the same wire format, so
files cross between the two packages both ways.  The reference persists
CryptoContext, public key, eval-mult key, rotation keys and ciphertexts
with OpenFHE's Serial::{Serialize,Deserialize}ToFile (sort.h:1-5,31-102):
that file-level boundary is the system's client/server protocol.  The
client makes keys and encrypts, the server computes blind, the client
decrypts (SURVEY.md §5.4).

  context      -> JSON of CkksConfig, less `seed` (primes re-derived
                  deterministically)
  public key   -> .npz  {b, a}                       uint64 [nq, n]
  relin key    -> .npz  {k}            uint32 [dnum, 2, nq+nsp, n] (NTT+Mont)
  rotation set -> .npz  {r<idx>: key}  same layout per index (+ conj)
  ciphertext   -> .npz  {data, scale, noise_deg, slots}   (logical limbs)

Residues cross through core/interop.py (int32 tensors <-> uint32 arrays,
the same bits).  Three differences from the JAX package's writer and
loader, none of which changes what a file means to the server:

  * the context file leaves out the client's `seed`: the secret key and
    the encryption noise are drawn from it (core/keys.py), so whoever
    holds a context file that names it rebuilds the secret bit for bit.
    A loader that finds no seed takes the config's default: an
    evaluation-only context makes no secret.  The default seed is public
    too, so a client that keeps its secret draws its seed from OS
    entropy (`secrets.randbits(63)`).
  * members are stored, not deflated (np.savez): uniform residues below
    a 30-bit prime compress by under 1%, and zlib writes them at about
    20 MB/s, which is minutes for the ~10 GB key set of a ring-2^17
    sort.  np.load reads both forms.
  * load_ciphertext keeps the file's limb count: this package runs every
    op at the exact limb count and never pads to a bucket.

A context file written by the JAX package may carry `limb_pad`, which
this package ignores, and `rot_key_budget_mb`, which CkksContext takes as
the JAX package does: a client context streams its keys under it, and an
evaluation-only context pins the keys it loads.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .core.params import CkksConfig
from .core.ckks import CkksContext, Ciphertext
from .core.interop import residues_to_numpy, residues_to_torch

_MAGIC = "sorting-fhe-tpu"
_VERSION = 1


# ---------------------------------------------------------------------------
# context (= CCParams)
# ---------------------------------------------------------------------------
def save_context(path, cfg: CkksConfig) -> None:
    """The config as JSON, without the seed the client's secret comes
    from (see the module docstring)."""
    d = dataclasses.asdict(cfg)
    del d["seed"]
    d["__magic__"] = _MAGIC
    d["__version__"] = _VERSION
    Path(path).write_text(json.dumps(d, indent=1))


def load_config(path) -> CkksConfig:
    d = json.loads(Path(path).read_text())
    if d.pop("__magic__", None) != _MAGIC:
        raise ValueError(f"{path}: not a {_MAGIC} context file")
    d.pop("__version__", None)
    return CkksConfig(**d)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
def save_public_key(path, ctx: CkksContext) -> None:
    b, a = ctx.encryptor.pk
    np.savez(path, b=np.asarray(b, dtype=np.uint64),
             a=np.asarray(a, dtype=np.uint64))


def load_public_key(path):
    z = np.load(path)
    return z["b"], z["a"]


def save_relin_key(path, ctx: CkksContext) -> None:
    np.savez(path, k=residues_to_numpy(ctx.relin_key))


def load_relin_key(path) -> np.ndarray:
    return np.load(path)["k"]


def save_rotation_keys(path, ctx: CkksContext) -> None:
    """All rotation keys the context holds, plus the conjugation key if
    generated (bootstrap needs it)."""
    arrs = {f"r{idx}": residues_to_numpy(key)
            for idx, key in ctx.rot_keys.items()}
    if ctx.conj_key is not None:
        arrs["conj"] = residues_to_numpy(ctx.conj_key)
    np.savez(path, **arrs)


def load_rotation_keys(path):
    """-> (rot_keys dict, conj_key or None), uint32 arrays."""
    z = np.load(path)
    rot = {}
    conj = None
    for name in z.files:
        if name == "conj":
            conj = z[name]
        else:
            rot[int(name[1:])] = z[name]
    return rot, conj


# ---------------------------------------------------------------------------
# ciphertexts
# ---------------------------------------------------------------------------
def save_ciphertext(path, ct: Ciphertext) -> None:
    np.savez(path, data=residues_to_numpy(ct.data),
             scale=np.float64(ct.scale),
             noise_deg=np.int64(ct.noise_deg),
             slots=np.int64(ct.slots))


def load_ciphertext(path, device="cuda") -> Ciphertext:
    z = np.load(path)
    return Ciphertext(residues_to_torch(z["data"], device), float(z["scale"]),
                      int(z["noise_deg"]), int(z["slots"]))


# ---------------------------------------------------------------------------
# whole-keyring convenience
# ---------------------------------------------------------------------------
def save_eval_material(dirpath, ctx: CkksContext, prefix: str = "") -> dict:
    """Write context + public/relin/rotation keys; returns the path map
    (the reference CLI's --cc/--key_pub/--key_mult/--key_rot quartet)."""
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    paths = {
        "cc": d / f"{prefix}cc.json",
        "key_pub": d / f"{prefix}key_pub.npz",
        "key_mult": d / f"{prefix}key_mult.npz",
        "key_rot": d / f"{prefix}key_rot.npz",
    }
    save_context(paths["cc"], ctx.cfg)
    save_public_key(paths["key_pub"], ctx)
    save_relin_key(paths["key_mult"], ctx)
    save_rotation_keys(paths["key_rot"], ctx)
    return {k: str(v) for k, v in paths.items()}


def load_eval_context(cc, key_pub, key_mult, key_rot,
                      device="cuda") -> CkksContext:
    """Server-side deserialization -> evaluation-only context on `device`
    (sort.h:31-74 initCC equivalent)."""
    cfg = load_config(cc)
    pk = load_public_key(key_pub)
    rk = load_relin_key(key_mult)
    rot, conj = load_rotation_keys(key_rot)
    return CkksContext.for_evaluation(cfg, pk, rk, rot, conj_key=conj,
                                      device=device)
