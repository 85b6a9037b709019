"""Vectorized k-mer codec.

Device replacement for the reference's per-kmer string path
(``encode_kmer_plain`` normalise_kmers_multi_large.c:1118-1126, ``reverse_complement``
:1160-1173, ``get_canonical_kmer`` :1175-1180, ``sequence_to_hash`` window loop
:1459-1499).

Design notes:

- Bases are 2-bit codes A=0, C=1, G=2, T=3 (reference ``base_map`` :150-153). A k-mer
  code is the big-endian concatenation of its base codes — identical to the
  reference's rolling ``encoded = (encoded << 2) | base`` (:1123). Comparing codes is
  therefore equivalent to comparing the k-mer strings (A<C<G<T is order-preserving),
  so canonical = min(code, revcomp_code) matches the reference's string ``strcmp``
  canonicalization exactly.
- JAX runs with 32-bit integers by default, so a code is carried as a pair of
  uint32 planes ``(hi, lo)`` with ``code = hi * 2^32 + lo``. k <= 31 needs <= 62 bits; for
  k <= 16 the hi plane is constant zero and XLA folds it away.
- All L-k+1 windows of a read are produced with k static shifted adds over the
  [reads, windows] plane — pure elementwise work, no gather, no strings. This is the batched
  equivalent of the reference's innermost hot loop (an O(k) strncpy+encode per
  window, :1464-1498) at ~10^3x the parallelism.
- The all-A k-mer encodes to 0 and the reference silently drops it from both the
  numerator and denominator of the coverage ratio (``if (hash == 0) continue;``
  :1483-1484). `window_validity` reproduces that.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "encode_windows",
    "encode_windows_canonical",
    "window_validity",
    "decode_codes",
    "revcomp_codes",
]


def _shift_or(hi, lo, col, shift):
    """OR a base column into the (hi, lo) planes at 2-bit position `shift`."""
    if shift >= 32:
        return hi | (col << jnp.uint32(shift - 32)), lo
    return hi, lo | (col << jnp.uint32(shift))


def encode_windows(bases: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Encode every k-window of every read.

    Args:
      bases: [R, L] integer array of 2-bit base codes (values 0..3; padding bytes may
        hold any value in 0..3 — mask with `window_validity`).
      k: k-mer size (static, 5..31).

    Returns:
      (hi, lo): uint32 [R, W] planes, W = L - k + 1; code = hi*2^32 + lo with the
      window's FIRST base in the most-significant position.
    """
    R, L = bases.shape
    W = L - k + 1
    b = bases.astype(jnp.uint32)
    hi = jnp.zeros((R, W), jnp.uint32)
    lo = jnp.zeros((R, W), jnp.uint32)
    for j in range(k):
        col = jax.lax.slice_in_dim(b, j, j + W, axis=1)
        hi, lo = _shift_or(hi, lo, col, 2 * (k - 1 - j))
    return hi, lo


def _encode_windows_rc(bases: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Encode the reverse complement of every k-window.

    The rc of window bases b_0..b_{k-1} is comp(b_{k-1})..comp(b_0), and
    comp(b) = 3 - b = b XOR 3. So base j of the window lands at 2-bit position 2*j
    (instead of 2*(k-1-j)) with a complement — one fused pass, no reversal gather.
    """
    R, L = bases.shape
    W = L - k + 1
    b = bases.astype(jnp.uint32)
    three = jnp.uint32(3)
    hi = jnp.zeros((R, W), jnp.uint32)
    lo = jnp.zeros((R, W), jnp.uint32)
    for j in range(k):
        col = jax.lax.slice_in_dim(b, j, j + W, axis=1) ^ three
        hi, lo = _shift_or(hi, lo, col, 2 * j)
    return hi, lo


def encode_windows_canonical(
    bases: jax.Array, k: int, canonical: bool
) -> tuple[jax.Array, jax.Array]:
    """Encode windows, optionally canonicalized to min(code, revcomp_code).

    Equivalent to the reference's `get_canonical_kmer` string-min (:1175-1180)
    because the 2-bit encoding is order-preserving.
    """
    hi, lo = encode_windows(bases, k)
    if not canonical:
        return hi, lo
    rhi, rlo = _encode_windows_rc(bases, k)
    take_rc = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return jnp.where(take_rc, rhi, hi), jnp.where(take_rc, rlo, lo)


def window_validity(
    lengths: jax.Array, hi: jax.Array, lo: jax.Array, k: int
) -> jax.Array:
    """Boolean [R, W] mask of windows that the reference would count.

    A window at offset i of a read of length len is real iff i <= len - k
    (``for (i = 0; i <= strlen(seq) - K; i++)`` :1464), and the all-A code 0 is
    dropped (:1483-1484). Reads shorter than k (the host encodes these as length 0)
    produce no valid windows at all.
    """
    W = hi.shape[-1]
    win = jax.lax.broadcasted_iota(jnp.int32, hi.shape, hi.ndim - 1)
    in_read = win <= (lengths[..., None].astype(jnp.int32) - k)
    nonzero = (hi | lo) != jnp.uint32(0)
    del W
    return in_read & nonzero


def revcomp_codes(hi: np.ndarray, lo: np.ndarray, k: int):
    """Host-side (numpy) reverse complement of packed codes; used by tests."""
    code = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    out = np.zeros_like(code)
    for _ in range(k):
        out = (out << np.uint64(2)) | ((code & np.uint64(3)) ^ np.uint64(3))
        code >>= np.uint64(2)
    return (out >> np.uint64(32)).astype(np.uint32), (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)


_REV_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_codes(hi: np.ndarray, lo: np.ndarray, k: int) -> list[str]:
    """Host-side decode of packed codes to strings (reference decode_kmer_plain
    :1128-1136); used for the -P k-mer table dump and tests."""
    code = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(
        np.uint64
    )
    n = code.shape[0]
    out = np.empty((n, k), dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[:, i] = _REV_BASE[(code & np.uint64(3)).astype(np.int64)]
        code >>= np.uint64(2)
    return [bytes(row).decode() for row in out]
