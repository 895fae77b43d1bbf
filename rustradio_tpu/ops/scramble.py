"""G3RUH-style LFSR scrambling (reference src/descrambler.rs).

The reference clocks a shift register per bit.  Descrambling is
feed-forward:  with mask bits {j} and register length L, the register bit j
at time n holds x[n-1-(L-j)], so

    out[n] = x[n] ^ XOR_{j in mask} x[n - (L - j) - 1]

— a pure windowed XOR (vectorized on device; the seed contributes only to
the first L+1 outputs and is handled by the carried history).

Scrambling is a true feedback recurrence; over GF(2) the state advance is
linear, so it block-parallelizes (the SURVEY hard-parts plan): with
register state s and per-bit update s' = A s + e_L x (A = shift +
feedback row), a whole block of B bits is the affine map

    out = C s + T x        (C[i] = c A^i,  T[i,j] = w[i-1-j] Toeplitz,
    s_B  = A^B s + U x      w[d] = c A^d e_L — the impulse response)

over GF(2).  All four matrices are precomputed bit matrices; on device
the block outputs are two 0/1 matmuls (EXACT even at reduced matmul
precision — 0/1 inputs are exact in TF32 and bf16, and the f32
accumulator holds every count below 2^24) plus a
tiny per-block state scan.  ``scramble`` dispatches to this for long
inputs; the per-bit ``lax.scan`` form remains the reference semantics
(bit-equality asserted in tests/test_ops.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _mask_delays(mask: int, length: int) -> list[int]:
    """Delays d such that out[n] ^= x[n-d]: d = L - j + 1 per mask bit j."""
    return [length - j + 1 for j in range(64) if (mask >> j) & 1]


def descramble(x, mask: int = 0x21, length: int = 16, history=None):
    """Feed-forward LFSR descramble; matches reference next_descramble
    (src/descrambler.rs:33-38) with seed 0.

    ``history``: the previous length+1 input bits (for streaming), oldest
    first; defaults to zeros (== seed 0).
    """
    x = jnp.asarray(x, jnp.uint8)
    h = length + 1
    if history is None:
        hist = jnp.zeros(h, jnp.uint8)
    else:
        hist = jnp.asarray(history, jnp.uint8)
    xp = jnp.concatenate([hist, x])
    out = x
    for d in _mask_delays(mask, length):
        out = out ^ xp[h - d : h - d + x.shape[0]]
    return out


def scramble(x, mask: int = 0x21, length: int = 16, seed: int = 0, state=None,
             block: int | None = 512):
    """LFSR scramble (reference next_scramble, src/descrambler.rs:39-45).

    Returns (out, final_state).  Inputs longer than ~2 blocks run the
    GF(2) block-parallel form (see module docstring) — bit-identical to
    the per-bit scan, which handles short inputs and the tail.  Pass
    ``block=None`` to force the sequential scan.
    """
    x = jnp.asarray(x, jnp.uint8)
    if state is None:
        s0 = jnp.asarray(
            [(seed >> j) & 1 for j in range(length + 1)], jnp.uint8
        )
    else:
        s0 = jnp.asarray(state, jnp.uint8)

    n = int(x.shape[0])
    if block and n >= 2 * block:
        nb = n // block
        head, tail = x[: nb * block], x[nb * block :]
        out_h, s_mid = _scramble_blocked(head, s0, mask, length, block)
        out_t, s_fin = _scramble_scan(tail, s_mid, mask, length)
        return jnp.concatenate([out_h, out_t]), s_fin
    return _scramble_scan(x, s0, mask, length)


def _scramble_scan(x, s0, mask: int, length: int):
    mask_arr = jnp.asarray(
        [(mask >> j) & 1 for j in range(length + 1)], jnp.uint8
    )

    def step(s, xi):
        ret = s[0]
        tmp = (jnp.sum((s & mask_arr).astype(jnp.int32)) % 2).astype(jnp.uint8) ^ xi
        s = jnp.concatenate([s[1:], tmp[None]])
        return s, ret

    s, out = jax.lax.scan(step, s0, x)
    return out, s


@functools.lru_cache(maxsize=8)
def _scramble_mats(mask: int, length: int, block: int):
    """GF(2) block matrices (C, T, M, U) for a B-bit scrambler step; see
    module docstring.  Pure numpy, cached per (mask, length, B)."""
    L1 = length + 1
    A = np.zeros((L1, L1), np.uint8)
    for j in range(length):
        A[j, j + 1] = 1  # s'[j] = s[j+1]
    A[length] = [(mask >> j) & 1 for j in range(L1)]  # s'[L] = m.s (+ x)
    B = block
    # powers of A: pows[i] = A^i mod 2, i = 0..B
    pows = [np.eye(L1, dtype=np.uint8)]
    for _ in range(B):
        pows.append((pows[-1] @ A) % 2)
    C = np.stack([p[0] for p in pows[:B]])          # (B, L1): c A^i
    w = np.array([p[0, length] for p in pows], np.uint8)  # c A^d e_L
    i, j = np.ogrid[:B, :B]
    d = i - 1 - j
    T = np.where(d >= 0, w[np.clip(d, 0, B)], 0).astype(np.uint8)  # (B, B)
    M = pows[B]                                      # (L1, L1): A^B
    U = np.stack([pows[B - 1 - jj][:, length] for jj in range(B)], axis=1)
    return C, T, M, U                                # U: (L1, B)


def _scramble_blocked(x, s0, mask: int, length: int, block: int):
    """x of length nb*block -> (out, state) identical to the scan."""
    C, T, M, U = _scramble_mats(mask, length, block)
    nb = x.shape[0] // block
    X = x.reshape(nb, block).astype(jnp.float32)
    # per-block state injections V[k] = U x_k, then the tiny state chain
    # s_{k+1} = M s_k + V[k] (all mod 2).  These f32 dots stay at default
    # precision: even where that is TF32 (or one bf16 pass) the 0/1
    # operands are exact, products accumulate in f32, and every sum is a
    # count below 2^24, so the result is exact.
    V = jnp.dot(X, jnp.asarray(U.T, jnp.float32)).astype(jnp.int32) & 1
    Mt = jnp.asarray(M.T, jnp.float32)

    def step(s, v):
        s2 = (jnp.dot(s.astype(jnp.float32), Mt).astype(jnp.int32) & 1) ^ v
        return s2, s

    s_fin, S = jax.lax.scan(step, s0.astype(jnp.int32), V, unroll=8)
    # out = C s_k + T x_k per block, batched into two matmuls
    out = jnp.dot(X, jnp.asarray(T.T, jnp.float32))
    out = out + jnp.dot(S.astype(jnp.float32), jnp.asarray(C.T, jnp.float32))
    out = (out.astype(jnp.int32) & 1).astype(jnp.uint8)
    return out.reshape(-1), s_fin.astype(jnp.uint8)


def descramble_numpy(x: np.ndarray, mask: int = 0x21, length: int = 16) -> np.ndarray:
    """Host golden model: literal port of the reference LFSR semantics."""
    shift_reg = 0
    out = np.empty_like(x)
    for n, i in enumerate(x):
        ret = (bin(shift_reg & mask).count("1") & 1) ^ int(i)
        shift_reg = (shift_reg >> 1) | (int(i) << length)
        out[n] = ret
    return out
