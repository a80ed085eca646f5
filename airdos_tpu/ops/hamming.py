"""Batched Hamming distance over 256-bit ORB descriptors.

Replaces the reference's scalar 8x32-bit popcount loop
(ORBmatcher.cc:1647-1663, DescriptorDistance) with dense popcount matrices:
all candidate pairs at once; XLA fuses xor -> popcount -> sum into one
loop, so the [N, M, 8] intermediate never reaches device memory.
Distances are in [0, 256]; invalid descriptors should be pre-masked by
the caller.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance between aligned descriptor arrays.
    a, b: uint32 [..., 8].  Returns int32 [...]."""
    x = jax.lax.population_count(jnp.bitwise_xor(a, b))
    return jnp.sum(x, axis=-1).astype(jnp.int32)


def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances.

    a: uint32 [N, 8], b: uint32 [M, 8].  Returns int32 [N, M].
    """
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
