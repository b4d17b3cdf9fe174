"""The port's hand-written CUDA kernels: one library, one launcher and one
launch counter.

Every csrc/*.cu is compiled with nvcc for sm_90a into one shared library
with a plain C interface, at first CUDA use, from this package's sources
only, into `_build/libkernels_<digest>.so` beside the package (rebuilt
when the sources' hash changes), and loaded with ctypes.  Nothing is
compiled or loaded at import time.

SIGNATURES gives each C entry point's argument types; every entry point
returns a cudaError.  Kernel `k` is the entry point `k_launch`, whose
last argument is the stream: `launch(k, device, *args)` appends the
device's current stream, raises on an error and counts the call in
`launches`, keyed by k.  KERNELS names them all, in SIGNATURES' order.

The wrappers (core/cuda_ntt.py, cuda_basis.py, cuda_keyswitch.py,
cuda_rescale.py) keep
each kernel's plain version, its own preconditions, its output and one
`launch` call.  They share the device rule (`kernel_device`: the CPU
runs the plain version, a CUDA device the kernel, any other device
raises) and the input checks (`residues`, `tables`).

Adding a kernel touches four files: its csrc/*.cu, its line in
SIGNATURES, its wrapper and its caller.  What counts launches (driver.py,
bench.py, experiments.py, chip_smoke.py) reads `launches` over KERNELS
and needs no edit.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "ntt_plan": [_cll, _ci, ctypes.POINTER(_cll)],
    "ntt_fwd_launch": [_vp] * 6 + [_ci, _ci, _cll, _ci, _vp],
    "ntt_inv_launch": [_vp] * 8 + [_ci, _ci, _cll, _ci, _vp],
    "base_conv_launch": [_vp] * 6 + [_ci] * 6 + [_vp],
    "ks_inner_launch": [_vp] * 7 + [_ci] * 6 + [_vp],
    "moddown_tail_launch": [_vp] * 5 + [_ci] * 4 + [_vp],
    "rescale_lift_launch": [_vp] * 4 + [_ci] * 4 + [_vp],
}
KERNELS = tuple(name.removesuffix("_launch") for name in SIGNATURES
                if name.endswith("_launch"))

launches: collections.Counter = collections.Counter()
build_info: dict = {}      # filled by build(): path, seconds, ptxas report
_lib = None


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


def load(path) -> ctypes.CDLL:
    """The library at `path` with SIGNATURES applied to the entry points
    it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _ci
    return lib


def build() -> ctypes.CDLL:
    """Compile (if a source changed) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(b"".join(src.read_bytes()
                                     for src in SOURCES)).hexdigest()[:16]
    so = BUILD_DIR / f"libkernels_{digest}.so"
    t0 = time.perf_counter()
    report = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".libkernels_{digest}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
        report = res.stderr
    _lib = load(so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      ptxas=report)
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Kernel `name` (entry point name_launch) on `device`'s current
    stream, counted in `launches`."""
    err = getattr(build(), f"{name}_launch")(
        *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def reset():
    """Zero every kernel's launch count."""
    launches.clear()


def kernel_device(name: str, device: torch.device) -> bool:
    """The device rule: False on the CPU (the plain version runs), True on
    a CUDA device (the kernel runs or the call raises); any other device
    raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    return True


def residues(name: str, t_name: str, t: torch.Tensor, dims=None,
             device=None, row_view: bool = False):
    """Raise unless `t` is contiguous int32 (canonical residues) with
    `dims` dimensions (any, for None) on `device` (any, for None).  With
    `row_view`, `t` [K, l, n] may also be the first l rows of a
    contiguous [K, la, n] (strides (la n, n, 1)): `row_pitch` gives la."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: {t_name} must be int32, got {t.dtype}")
    ok = t.is_contiguous() or (row_view and row_pitch(t) is not None)
    if (dims is not None and t.dim() != dims) or not ok:
        raise ValueError(f"{name}: {t_name} must be contiguous"
                         f"{' or a row view' if row_view else ''} with "
                         f"{dims or 'any'} dimensions, got {tuple(t.shape)}"
                         f" strides {t.stride()}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: devices differ: {device}, {t_name} "
                         f"{t.device}")


def row_pitch(t: torch.Tensor):
    """la where the 3-dimensional `t` [K, l, n] lies in a contiguous [K, la,
    n] as its first l rows (la = l for a contiguous t), else None."""
    if t.dim() != 3:
        return None
    K, l, n = t.shape
    s0, s1, s2 = t.stride()
    if s2 != 1 or (s1 != n and l > 1) or s0 % n:
        return None
    la = s0 // n if K > 1 else l
    return la if la >= l else None


def tables(name: str, device: torch.device, **named):
    """Raise unless each of `named` (t_name: (tensor, shape)) is a
    contiguous int64 tensor of that shape on `device`."""
    for t_name, (t, shape) in named.items():
        if t.dtype != torch.int64 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous int64 "
                             f"{list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: devices differ: {device}, {t_name} "
                             f"{t.device}")
