"""The index arithmetic of the two-pass NTT kernels (csrc/ntt.cu), checked
without a card.

`_two_pass` is a pure-torch model of the kernels: the same passes in the
same order (K1 columns then chunks, K2 chunks then columns with n^-1 on
the last step), the same radix-2^K register steps, tuples and twiddle
indices, vectorised over tuples instead of threads.  At a small chunk it
must be bit-equal to the plain versions ntt_fwd_t / ntt_inv_t, which
tests/test_torch_ntt.py holds to the JAX package.  The launch plan itself
is made on the C side; tests/test_torch_cuda.py checks it on the card.
"""

import numpy as np
import pytest
import torch

from sorting_fhe_tpu_torch.core import nt
from sorting_fhe_tpu_torch.core.ntt import NttContext, ntt_fwd_t, ntt_inv_t

torch.set_num_threads(1)   # one thread per test worker: six share the cores


def _step(v, p, tw, c, fwd, K, j, loge, tw_shift, ninv=None):
    """One register step on v [..., lanes, 2^loge] (elements last), with
    chunk index c [lanes] (zeros for the column pass)."""
    logt0 = loge - 1 - j
    logq = logt0 - (K - 1) if fwd else j
    tup = torch.arange(1 << (loge - K))
    G = tup >> logq
    base = (G << (logt0 + 1 if fwd else j + K)) + (tup & ((1 << logq) - 1))
    idx = [base + (k << logq) for k in range(1 << K)]
    e = [v[..., i] for i in idx]                     # [..., lanes, tuples]
    c = c.reshape(-1, 1)
    for m in range(K):
        if fwd:
            half = 1 << (K - 1 - m)
            tw0 = (1 << (tw_shift + j + m)) + (c << (j + m)) + (G << m)
        else:
            half, s = 1 << m, j + m
            tw0 = ((1 << (tw_shift - 1 - s)) + (c << (loge - 1 - s))
                   + (G << (K - 1 - m)))
        for k in range(1 << K):
            if k & half:
                continue
            if fwd:
                w = tw[:, tw0 + (k >> (K - m))]      # [L, lanes, tuples]
                u, t = e[k], e[k + half] * w % p
                e[k], e[k + half] = (u + t) % p, (u - t) % p
            else:
                w = tw[:, tw0 + (k >> (m + 1))]
                u, t = e[k], e[k + half]
                e[k], e[k + half] = (u + t) % p, (u - t) * w % p
    out = v.clone()
    for i, ek in zip(idx, e):
        out[..., i] = ek * ninv % p if ninv is not None else ek
    return out


def _radix_steps(stages):
    """Stages per register step of a pass (run_steps in csrc/ntt.cu):
    threes, then the rest."""
    return [3] * (stages // 3) + ([stages % 3] if stages % 3 else [])


def _pass(v, p, tw, c, fwd, loge, tw_shift, ninv=None):
    j = 0
    for K in _radix_steps(loge):
        last = j + K == loge
        v = _step(v, p, tw, c, fwd, K, j, loge, tw_shift,
                  ninv if last else None)
        j += K
    return v


def _two_pass(x, p, tw, ninv, logc, fwd):
    """x int32 [..., L, n]; p, ninv [L]; tw [L, n] (the limbs' rows)."""
    lead, (L, n) = x.shape[:-2], x.shape[-2:]
    logn = n.bit_length() - 1
    logr = logn - logc
    v = x.long().reshape((-1, L, 1 << logr, 1 << logc))
    pb = p.long().reshape(L, 1, 1)
    tw = tw.long()
    nb = ninv.long().reshape(L, 1, 1)
    chunks, cols = torch.arange(1 << logr), torch.zeros(1 << logc, dtype=int)

    def columns(v, scale):
        t = v.transpose(-1, -2)                      # lanes = columns
        t = _pass(t, pb, tw, cols, fwd, logr, 0 if fwd else logr,
                  nb if scale else None)
        return t.transpose(-1, -2)

    def chunk(v, scale):
        return _pass(v, pb, tw, chunks, fwd, logc,
                     logn - logc if fwd else logn, nb if scale else None)

    if fwd:
        v = chunk(columns(v, False), False) if logr else chunk(v, False)
    else:
        v = columns(chunk(v, False), True) if logr else chunk(v, True)
    return v.reshape(lead + (L, n)).to(torch.int32)


# every split of up to 11 stages into 1..6 chunk stages and the column rest
# that covers each register step shape (K = 1, 2, 3 and their mixes)
SPLITS = [(1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 2), (4, 4),
          (5, 2), (5, 3), (6, 3), (6, 6), (7, 3), (7, 4), (7, 5), (8, 4),
          (8, 6), (9, 5), (9, 6), (10, 4), (10, 5), (11, 6)]


@pytest.mark.parametrize("logn,logc", SPLITS)
def test_two_pass_model_bit_equal_to_plain(logn, logc):
    """Row subset [4, 1, 5] under a leading dim of 2; logn = logc has no
    column pass (n^-1 then goes with the chunk pass)."""
    n = 1 << logn
    primes = nt.find_ntt_primes(28, 6, n)
    tabs = NttContext(primes, n, "cpu")
    r = torch.tensor([4, 1, 5])
    p = np.asarray([primes[i] for i in r], np.uint64).reshape(-1, 1)
    x = np.random.default_rng(logn).integers(0, 1 << 62, (2, 3, n),
                                             dtype=np.uint64) % p
    x = torch.from_numpy(x.astype(np.int32))
    f = _two_pass(x, tabs.p[r], tabs.psi[r], tabs.n_inv[r], logc, True)
    assert torch.equal(f, ntt_fwd_t(x, tabs.p[r], tabs.psi[r]))
    i = _two_pass(f, tabs.p[r], tabs.ipsi[r], tabs.n_inv[r], logc, False)
    assert torch.equal(i, ntt_inv_t(f, tabs.p[r], tabs.ipsi[r],
                                    tabs.n_inv[r]))
    assert torch.equal(i, x)
