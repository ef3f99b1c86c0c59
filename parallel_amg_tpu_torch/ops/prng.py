"""The JAX package's uniform draw, reproduced in numpy.

``uniform(shape, seed, dtype)`` equals
``jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype)`` bit for bit
(checked against JAX 0.9.0 with ``jax_threefry_partitionable=True``, its
default): threefry2x32 under the key (0, seed) hashes the counter pair
(hi, lo) of each flat row-major index; the random bits are the XOR of the two
output words. A float32 draw keeps the top 23 bits as the mantissa of a
number in [1, 2) and subtracts 1. A bfloat16 draw (7 mantissa bits, so JAX
draws 8-bit words) keeps the low byte of the XOR, shifts it right by one
into the mantissa of a bf16 in [1, 2) and subtracts 1, as
``jax._src.random._uniform`` does for ``nmant < 8``.

``permutation(n, seed)`` equals ``jax.random.permutation(PRNGKey(seed), n)``
bit for bit: ⌈3·ln(max(1, n)) / ln(2³²−1)⌉ rounds, each of which splits the
key (threefry2x32 of the counters 0 and 1 under the current key: the next
key and the subkey), draws n 32-bit words under the subkey and applies a
stable argsort of them to the running permutation.

The PMIS weights, the power-iteration start vector and the distance-2 MIS
weights of the distributed SA setup come from here, so the port's setups
pick the same C/F splits, aggregates and λ estimates as the JAX package.
The draw runs on the host and its caller copies it to the device.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_MIN_CHUNK = 1 << 16  # values a thread hashes at once, at least


def _rotl(v, r: int, tmp):
    np.left_shift(v, np.uint32(r), out=tmp)
    np.right_shift(v, np.uint32(32 - r), out=v)
    np.bitwise_or(v, tmp, out=v)


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1), in place;
    the key words are Python ints below 2³²."""
    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    tmp = np.empty_like(x0)
    x0 += ks[0]
    x1 += ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            _rotl(x1, r, tmp)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} is outside [0, 2**32)")
    return seed


def _random_bits32(n: int, seed: int, key=None) -> np.ndarray:
    """(n,) uint32: ``jax.random.bits(PRNGKey(seed), (n,), uint32)``, or
    the same draw under the key pair ``key`` when given."""
    k0, k1 = (0, _check_seed(seed)) if key is None else key
    out = np.empty(n, np.uint32)
    # numpy's ufuncs release the GIL: chunks hash in parallel on the host,
    # about four a thread
    workers = min(os.cpu_count() or 1, 8)
    size = max(_MIN_CHUNK, -(-n // (4 * workers)))

    def chunk(s):
        e = min(n, s + size)
        idx = np.arange(s, e, dtype=np.uint64)
        x0 = (idx >> np.uint64(32)).astype(np.uint32)
        x1 = idx.astype(np.uint32)
        with np.errstate(over="ignore"):
            b0, b1 = _threefry2x32(k0, k1, x0, x1)
        np.bitwise_xor(b0, b1, out=out[s:e])

    starts = range(0, n, size)
    with ThreadPoolExecutor(max(1, min(len(starts), workers))) as ex:
        list(ex.map(chunk, starts))
    return out


def uniform(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    """A CPU tensor of ``shape``, uniform in [0, 1), equal bit for bit to
    ``jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype)`` for
    float32 and bfloat16."""
    shape = tuple(int(d) for d in shape)
    bits = _random_bits32(int(np.prod(shape, dtype=np.int64)), seed)
    if dtype in (torch.float32, torch.float64):
        # JAX without x64 draws float64 as float32
        f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
        return torch.from_numpy(f - np.float32(1.0)).reshape(shape).to(dtype)
    if dtype == torch.bfloat16:
        h = (((bits & np.uint32(0xFF)) >> np.uint32(1)).astype(np.uint16)
             | np.uint16(0x3F80))
        one = torch.from_numpy(h.view(np.int16)).view(torch.bfloat16)
        return (one - 1.0).reshape(shape)
    raise TypeError(f"uniform draws float32, float64 or bfloat16, "
                    f"not {dtype}")


def _split_key(k0: int, k1: int):
    """(next key, subkey) of ``jax.random.split(key)``: threefry2x32 of the
    counter pairs (0, 0) and (0, 1) under the key."""
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(k0, k1, np.zeros(2, np.uint32),
                             np.arange(2, dtype=np.uint32))
    return (int(a[0]), int(b[0])), (int(a[1]), int(b[1]))


def permutation(n: int, seed: int) -> torch.Tensor:
    """A CPU int64 tensor equal to
    ``jax.random.permutation(jax.random.PRNGKey(seed), n)``."""
    n = int(n)
    key = (0, _check_seed(seed))
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        key, sub = _split_key(*key)
        bits = _random_bits32(n, 0, key=sub)
        x = x[np.argsort(bits, kind="stable")]
    return torch.from_numpy(x)
