"""Threefry-2x32 random draws in numpy, as `jax.random` makes them.

vcf_tpu seeds its k-means++ (ops/vq.py) with `jax.random`: a key from
`PRNGKey(seed)`, `split`, `randint` and `categorical`.  The port draws
the same numbers without JAX: this module reimplements the threefry2x32
hash and the "partitionable" counter layout that jax 0.9.0 uses
(`jax_threefry_partitionable=True`: element i of a draw hashes the
64-bit counter i, split into (high, low) 32-bit words, and the two
output words are XORed), and on it `split`, `random_bits`, `randint`,
`uniform`, `gumbel` and `categorical`.

The bits, `randint` and `uniform` are exact: they are integer
operations and one float32 mantissa trick.  `gumbel` is -log(-log(u))
in float32, and float32 `log` is not correctly rounded: numpy's and
XLA's differ in the last bit on about a fifth of inputs.  So the noise
may differ from jax's by an ulp, and a `categorical` draw (an argmax of
logits + noise) can differ only where its top two candidates lie within
a few ulp of each other (ROADMAP C2).

A key is a (2,) uint32 array, as `jax.random.PRNGKey` returns it.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF) of
    its 32-bit value, i.e. (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under `key`; returns the two uint32 output words."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = [k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA)]
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _counters(shape) -> tuple:
    """The (high, low) words of a 64-bit iota over `shape`."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(0xFFFFFFFF)
                                               ).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`num` new keys, (num, 2) uint32."""
    b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits a value, uint32 of `shape`."""
    b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def randint(key: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 values in [minval, maxval): two 32-bit draws folded modulo
    the span, as jax.random.randint folds them."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval) if maxval > minval else _U32(1)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 values in [minval, maxval): 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled and shifted."""
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)


def _log32(x: np.ndarray) -> np.ndarray:
    """float32 log, correctly rounded (through float64): host-independent,
    and nearer XLA's than numpy's float32 log (28,445 against 45,667 of
    200,000 uniforms differ in the last bit)."""
    return np.log(x.astype(np.float64)).astype(np.float32)


def gumbel(key: np.ndarray, shape) -> np.ndarray:
    """float32 standard Gumbel noise, -log(-log(u)) with u uniform in
    [tiny, 1) (jax's "low" mode)."""
    u = uniform(key, shape, np.finfo(np.float32).tiny, 1.0)
    return -_log32(-_log32(u))


def categorical(key: np.ndarray, logits: np.ndarray) -> int:
    """An index drawn from softmax(logits) over the last axis of a 1-D
    float32 array: argmax(logits + gumbel), the first on ties."""
    logits = np.asarray(logits, np.float32)
    return int(np.argmax(gumbel(key, logits.shape) + logits))
