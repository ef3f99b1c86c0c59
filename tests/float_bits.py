"""Bit-for-bit comparison of float32 arrays, shared by the port's tests that
hold it to the JAX package's float32 results."""

import numpy as np


def bits(a):
    """The float32 bits of an array (a torch CPU tensor or anything numpy
    takes) as int32."""
    a = a.numpy() if hasattr(a, "numpy") else a
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def bits_equal(mine, theirs) -> bool:
    """The same shape and float32 bits."""
    w, jw = bits(mine), bits(theirs)
    return w.shape == jw.shape and np.array_equal(w, jw)


def assert_bits(mine, theirs, what: str = ""):
    """Assert the same shape and float32 bits, naming how many floats differ."""
    w, jw = bits(mine), bits(theirs)
    assert w.shape == jw.shape, f"{what} shapes {w.shape} and {jw.shape}"
    assert np.array_equal(w, jw), f"{what} {int((w != jw).sum())} of {w.size} floats differ"
