"""BoW-guided descriptor matching (SearchByBoW).

Rebuild of ORBmatcher::SearchByBoW (reference: src/ORBmatcher.cc:159-288
KF<->Frame, 522-655 KF<->KF): candidates restricted to features sharing the
same vocabulary node at the feature-grouping level, best Hamming with
NN-ratio and rotation-histogram checks.

Dense form: the node restriction is one equality mask over the dense N1 x N2
Hamming matrix — the tree walk already produced per-feature node ids.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from airdos_tpu.matching.projection import _resolve_unique, _rotation_consistency
from airdos_tpu.ops.hamming import hamming_matrix

TH_LOW = 50
BIG = 1 << 10


class BowMatches(NamedTuple):
    idx2: jnp.ndarray       # [N1] best match in set 2 (-1 none)
    n_matches: jnp.ndarray
    idx1_of_2: jnp.ndarray  # [N2] winning feature in set 1 (-1)


def match_by_bow(desc1, nodes1, valid1, ang1,
                 desc2, nodes2, valid2, ang2,
                 nn_ratio: float = 0.7,
                 check_rotation: bool = True) -> BowMatches:
    """Features of two images with per-feature vocabulary node ids."""
    N1 = desc1.shape[0]
    N2 = desc2.shape[0]
    same_node = nodes1[:, None] == nodes2[None, :]
    ok = same_node & valid1[:, None] & valid2[None, :] & \
        (nodes1 >= 0)[:, None] & (nodes2 >= 0)[None, :]
    D = jnp.where(ok, hamming_matrix(desc1, desc2), BIG)
    best = jnp.argmin(D, axis=1).astype(jnp.int32)
    bdist = jnp.take_along_axis(D, best[:, None], axis=1)[:, 0]
    D2 = D.at[jnp.arange(N1), best].set(BIG)
    sdist = jnp.min(D2, axis=1)
    has = (bdist < TH_LOW) & \
        (bdist.astype(jnp.float32) < nn_ratio * sdist.astype(jnp.float32))
    if check_rotation:
        has = _rotation_consistency(ang1, ang2[best], has)
    idx2, idx1_of_2, n = _resolve_unique(best, bdist, has, N2)
    return BowMatches(idx2=idx2, n_matches=n, idx1_of_2=idx1_of_2)
