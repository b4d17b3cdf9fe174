"""Wrappers for the hand-written Hopper NTT kernels (csrc/ntt.cu).

Counterpart of sorting_fhe_tpu/core/pallas_ntt.py:

  K1 `ntt_fwd(x, tabs, rows)`  replaces ntt_fwd_pallas / _fwd_kernel
  K2 `ntt_inv(x, tabs, rows)`  replaces ntt_inv_pallas / _inv_kernel

`x` is int32 [..., L, n] (canonical residues), `tabs` the NttContext of the
whole chain, `rows` an int32 [L] tensor naming the chain row (prime and
twiddle row) of each of the L limbs.  The result is a new int32 tensor in
the same order as the plain versions ntt.ntt_fwd_t / ntt_inv_t.

Dispatch is on the tensor's device: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel or raises.  There is no fallback from
the kernel to the plain version.  Rings up to 2^18 (MAX_LOGN) are taken.

Each call is at most two kernel launches (csrc/ntt.cu: a column pass over
[R, C] tiles and a chunk pass).  The C side plans them; `launch_plan`
reads that plan back from the built library.

The kernels are compiled with nvcc for sm_90a into a shared library with
a plain C interface, at first CUDA use, from this package's sources only,
into `_build/` beside the package (rebuilt when the source hash changes),
and loaded with ctypes.  Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .ntt import NttContext, ntt_fwd_t, ntt_inv_t

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

MAX_LOGN = 18              # the ring-2^18 tier: 7 column stages
PLAN_KEYS = ("logc", "logw", "col_blocks", "chunk_blocks", "col_smem",
             "chunk_smem")

_lib = None
build_info: dict = {}      # filled by build(): path, seconds, ptxas report


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> ctypes.CDLL:
    """Compile (if the source changed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libntt_{digest}.so"
    t0 = time.perf_counter()
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".libntt_{digest}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
        report = res.stderr
    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ntt_fwd_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, cll, ci,
                                   vp]
    lib.ntt_fwd_launch.restype = ci
    lib.ntt_inv_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                   cll, ci, vp]
    lib.ntt_inv_launch.restype = ci
    lib.ntt_plan.argtypes = [cll, ci, ctypes.POINTER(cll)]
    lib.ntt_plan.restype = ci
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      ptxas=report)
    _lib = lib
    return lib


def launch_plan(limbs: int, logn: int) -> dict:
    """The kernels' launch plan for `limbs` limbs of 2^logn residues, as
    the built library computes it (make_plan in csrc/ntt.cu): chunk
    2^logc, column tile width 2^logw, blocks and dynamic shared-memory
    bytes of each pass (no column pass when logn <= logc)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = build().ntt_plan(limbs, logn, out)
    if err:
        raise ValueError(f"ntt_plan({limbs}, {logn}): cudaError {err}")
    return dict(zip(PLAN_KEYS, out))


def _check(x: torch.Tensor, tabs: NttContext, rows: torch.Tensor):
    if x.dtype != torch.int32:
        raise TypeError(f"NTT input must be int32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != tabs.n:
        raise ValueError(f"NTT input must be [..., L, {tabs.n}], "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("NTT input must be contiguous")
    if rows.dtype != torch.int32 or rows.dim() != 1 \
            or rows.numel() != x.shape[-2]:
        raise ValueError(f"rows must be int32 [{x.shape[-2]}], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device != x.device or tabs.p.device != x.device:
        raise ValueError(f"devices differ: x {x.device}, rows "
                         f"{rows.device}, tables {tabs.p.device}")


def _kernel_lib(x: torch.Tensor, tabs: NttContext) -> ctypes.CDLL:
    """The built library, for an input the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"no NTT kernel for device {x.device}")
    if tabs.logn > MAX_LOGN:
        raise ValueError(f"ring 2^{tabs.logn} is above the kernels' "
                         f"2^{MAX_LOGN}")
    return build()


def _dims(x: torch.Tensor, tabs: NttContext) -> tuple:
    """The launch functions' trailing arguments: L, LP, limbs, logn, stream."""
    return (x.shape[-2], len(tabs.primes), x.numel() // tabs.n, tabs.logn,
            torch.cuda.current_stream(x.device).cuda_stream)


def ntt_fwd(x: torch.Tensor, tabs: NttContext,
            rows: torch.Tensor) -> torch.Tensor:
    """K1: forward negacyclic NTT of every limb of x (natural ->
    bit-reversed order)."""
    _check(x, tabs, rows)
    if x.device.type == "cpu":
        r = rows.long()
        return ntt_fwd_t(x, tabs.p[r], tabs.psi[r])
    lib = _kernel_lib(x, tabs)
    out = torch.empty_like(x)
    err = lib.ntt_fwd_launch(x.data_ptr(), out.data_ptr(), rows.data_ptr(),
                             tabs.p.data_ptr(), tabs.psi.data_ptr(),
                             tabs.psi_sh.data_ptr(), *_dims(x, tabs))
    if err:
        raise RuntimeError(f"ntt_fwd kernel launch failed: cudaError {err}")
    ntt_fwd.launches += 1
    return out


def ntt_inv(x: torch.Tensor, tabs: NttContext,
            rows: torch.Tensor) -> torch.Tensor:
    """K2: inverse negacyclic NTT of every limb of x (bit-reversed ->
    natural order), n^-1 included."""
    _check(x, tabs, rows)
    if x.device.type == "cpu":
        r = rows.long()
        return ntt_inv_t(x, tabs.p[r], tabs.ipsi[r], tabs.n_inv[r])
    lib = _kernel_lib(x, tabs)
    out = torch.empty_like(x)
    err = lib.ntt_inv_launch(x.data_ptr(), out.data_ptr(), rows.data_ptr(),
                             tabs.p.data_ptr(), tabs.ipsi.data_ptr(),
                             tabs.ipsi_sh.data_ptr(), tabs.n_inv.data_ptr(),
                             tabs.n_inv_sh.data_ptr(), *_dims(x, tabs))
    if err:
        raise RuntimeError(f"ntt_inv kernel launch failed: cudaError {err}")
    ntt_inv.launches += 1
    return out


def reset_launch_counts():
    """Launch counts: raised once per kernel call on a CUDA tensor, nowhere
    else."""
    for fn in (ntt_fwd, ntt_inv):
        fn.launches = 0


reset_launch_counts()
