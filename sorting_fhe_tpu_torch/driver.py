"""Blind-evaluation driver: the reference's SortContext + CLI.

Counterpart of sorting_fhe_tpu/driver.py (sort.h:15-103 and
main.cpp:9-44), the FHERMA-competition-style harness: deserialize the
crypto context, public key, eval-mult key, rotation keys and input
ciphertext from files, run a sort WITHOUT the secret key, serialize the
output.

    python -m sorting_fhe_tpu_torch --cc cc.json --key_pub key_pub.npz \\
        --key_mult key_mult.npz --key_rot key_rot.npz \\
        --input ct.npz --output out.npz [--algo direct] [--N 128] [--cpu]

The reference CLI fixes N=128 (main.cpp:36) and DirectSort with
CompositeSignConfig(4,3,3) (sort.h:86); both are flags here.  The server
runs on the card unless --cpu asks for the CPU; its stderr lines give
the seconds of loading and of the sort, and the sort's NTT kernel
launches (and peak device memory on the card).  It computes what the
JAX package's driver computes from the same files, faults included: the
sorter is built on whatever keys the files hold, without the minimal
key mode (so a minimal key set leaves rotations uncovered), and the
fixed sign (4,3,3) spends 9 levels more than the registry's (3,3,2).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import serial
from .core import cuda_ntt
from .core.ckks import CkksContext, Ciphertext
from .ops.sign import SignConfig, CompositeSignConfig


class SortContext:
    """Deserialize -> blind sort -> serialize (sort.h:15-103)."""

    ALGOS = ("direct", "hybrid", "hybrid1", "hybrid2", "bitonic")

    def __init__(self, cc_file, pub_key_file, mult_key_file, rot_key_file,
                 array_file, output_file, device="cuda"):
        self.ctx: CkksContext = serial.load_eval_context(
            cc_file, pub_key_file, mult_key_file, rot_key_file,
            device=device)
        self.input_ct: Ciphertext = serial.load_ciphertext(
            array_file, device=self.ctx.device)
        self.output_file = output_file
        self.output_ct: Ciphertext | None = None

    def eval(self, algo: str, N: int,
             sign: tuple[int, int, int] = (4, 3, 3),
             mult_depth: int | None = None) -> Ciphertext:
        """Run the requested pipeline on the deserialized ciphertext
        (sort.h:76-95 eval; sign default = reference's Cfg(4,3,3))."""
        cfg = SignConfig(CompositeSignConfig(*sign),
                         mult_depth=mult_depth or self.ctx.cfg.mult_depth)
        rot_available = sorted(self.ctx.rot_keys)
        if algo == "bitonic":
            from .models.bitonic import BitonicSort
            model = BitonicSort(self.ctx, N, rot_indices=rot_available)
            self.output_ct = model.sort(self.input_ct, cfg)
        elif algo in ("direct", "hybrid", "hybrid1", "hybrid2"):
            from .models.direct_sort import DirectSort
            model = DirectSort(self.ctx, N, rot_indices=rot_available)
            fn = {"direct": model.sort, "hybrid": model.sort_hybrid,
                  "hybrid1": model.sort_hybrid1,
                  "hybrid2": model.sort_hybrid2}[algo]
            self.output_ct = fn(self.input_ct, cfg)
        else:
            raise ValueError(f"unknown algo {algo!r}; one of {self.ALGOS}")
        return self.output_ct

    def serialize_output(self) -> None:
        """Write the result ciphertext (sort.h:97-102)."""
        if self.output_ct is None:
            raise RuntimeError("call eval() first")
        serial.save_ciphertext(self.output_file, self.output_ct)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sorting_fhe_tpu_torch",
        description="Blind homomorphic sort over serialized CKKS artifacts")
    ap.add_argument("--cc", required=True, help="context params JSON")
    ap.add_argument("--key_pub", required=True, help="public key .npz")
    ap.add_argument("--key_mult", required=True, help="relin key .npz")
    ap.add_argument("--key_rot", required=True, help="rotation keys .npz")
    ap.add_argument("--input", required=True, help="input ciphertext .npz")
    ap.add_argument("--output", required=True, help="output ciphertext .npz")
    ap.add_argument("--algo", default="direct", choices=SortContext.ALGOS)
    ap.add_argument("--N", type=int, default=128,
                    help="array size (reference fixes 128, main.cpp:36)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    args = ap.parse_args(argv)

    t0 = time.time()
    sc = SortContext(args.cc, args.key_pub, args.key_mult, args.key_rot,
                     args.input, args.output,
                     device="cpu" if args.cpu else "cuda")
    sc.ctx.sync()
    print(f"[driver] context + keys + input deserialized in "
          f"{time.time()-t0:.3f}s", file=sys.stderr)
    fwd0, inv0 = cuda_ntt.ntt_fwd.launches, cuda_ntt.ntt_inv.launches
    dev = sc.ctx.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    sc.eval(args.algo, args.N)
    sc.ctx.sync()
    peak = (f" peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB"
            if dev.type == "cuda" else "")
    print(f"[driver] {args.algo} sort N={args.N}: {time.time()-t0:.3f}s "
          f"(mults={sc.ctx.mult_count} rots={sc.ctx.rot_count}) "
          f"launches K1={cuda_ntt.ntt_fwd.launches - fwd0} "
          f"K2={cuda_ntt.ntt_inv.launches - inv0}{peak}", file=sys.stderr)
    sc.serialize_output()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
