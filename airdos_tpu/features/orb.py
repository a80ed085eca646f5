"""ORB feature extraction pipeline, jit-compiled end to end.

Behavioral rebuild of the reference's ORBextractor::operator()
(ORBextractor.cc:1054-1119): scale pyramid (+ AirDOS mask pyramid) -> FAST
with two thresholds -> spatially distributed keypoint selection ->
intensity-centroid orientation -> Gaussian blur -> rBRIEF descriptors ->
coordinates rescaled to level 0.

Static-shape redesign:
- FAST is a dense vectorized score map, not per-cell scalar loops.
- The reference's quadtree distribution (DistributeOctTree,
  ORBextractor.cc:541-765) is replaced by a shape-static equivalent:
  3x3 NMS, then best-corner-per-cell on a fixed grid sized to ~2x the level
  quota, then global top-K — same spatial-spread intent, fixed shapes.
- Orientation moments are per-keypoint patch gathers contracted with the
  circular-moment kernels (only the patches at keypoints are touched).
- All levels are processed inside one jit; output is exactly n_features
  padded slots with a validity mask.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from airdos_tpu.ops.brief import compute_descriptors, pack_u32
from airdos_tpu.ops.fast import fast_score_map, nms_strict
from airdos_tpu.ops.filters import gaussian_blur7
from airdos_tpu.ops.orientation import keypoint_angles
from airdos_tpu.ops.pyramid import build_pyramid, level_shapes

# Keypoint coordinates live in [EDGE, dim - EDGE) at each level, like the
# reference's EDGE_THRESHOLD=19 with FAST pattern margin 3 (minBorder = 16).
MIN_BORDER = 16
INI_BOOST = 1000.0     # selection boost for corners passing the high threshold


class OrbFeatures(NamedTuple):
    xy: jnp.ndarray        # [N, 2] float32, level-0 pixel coords
    response: jnp.ndarray  # [N] float32 FAST score
    angle: jnp.ndarray     # [N] float32 degrees [0, 360)
    octave: jnp.ndarray    # [N] int32 pyramid level
    desc: jnp.ndarray      # [N, 32] uint8 (cv2-compatible layout)
    desc32: jnp.ndarray    # [N, 8] uint32 packed for Hamming
    valid: jnp.ndarray     # [N] bool

    @property
    def n_slots(self) -> int:
        return self.xy.shape[0]


def level_quotas(n_features: int, n_levels: int, scale_factor: float) -> Tuple[int, ...]:
    """Per-level feature budget, geometric split like the reference
    (ORBextractor.cc constructor): level l gets ~ n * (1/f)^l, normalized."""
    inv = 1.0 / scale_factor
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    quotas = [int(round(first * inv ** l)) for l in range(n_levels - 1)]
    quotas.append(max(0, n_features - sum(quotas)))
    return tuple(quotas)


def _cell_size_for(h: int, w: int, quota: int) -> int:
    """Static cell size giving at least ~2x quota cells (min 8 px)."""
    if quota <= 0:
        return max(8, min(h, w))
    target_cells = 2 * quota
    cs = int(np.sqrt(h * w / target_cells))
    return int(np.clip(cs, 8, 64))


def _select_level_keypoints(score: jnp.ndarray, quota: int, cell: int,
                            ini_th: float, min_th: float):
    """NMS + per-cell best + top-K.  Returns xs, ys [quota] int32 and
    response [quota] float32 (0 response = invalid slot)."""
    h, w = score.shape
    # threshold at the low threshold, then cv2-style strict NMS
    s = nms_strict(jnp.where(score > min_th, score, 0.0))
    # prefer high-threshold corners (reference: retry semantics)
    sel = jnp.where(s > ini_th, s + INI_BOOST, s)

    ncy, ncx = -(-h // cell), -(-w // cell)
    pad_h, pad_w = ncy * cell - h, ncx * cell - w
    sp = jnp.pad(sel, ((0, pad_h), (0, pad_w)))
    cells = sp.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(ncy, ncx, cell * cell)
    best_in_cell = jnp.argmax(cells, axis=-1)                  # [ncy, ncx]
    best_score = jnp.max(cells, axis=-1)
    cy = jax.lax.broadcasted_iota(jnp.int32, (ncy, ncx), 0)
    cx = jax.lax.broadcasted_iota(jnp.int32, (ncy, ncx), 1)
    ys_cell = cy * cell + best_in_cell // cell
    xs_cell = cx * cell + best_in_cell % cell

    # Spatially-fair selection, the quadtree's guarantee (reference
    # ORBextractor::DistributeOctTree, ORBextractor.cc:452-644): breadth-
    # first region splitting keeps EVERY image region with corners
    # represented; response only breaks ties locally.  A plain global
    # top-K over cell responses is NOT that — in scenes where one region
    # is uniformly sharper (e.g. frontal far texture vs slanted ground),
    # it hands the whole budget to the sharp region (measured: 140/150
    # features in the far half, 10 on the floor, and forward translation
    # went unobservable).  Equivalent static-shape scheme: rank cells
    # within coarse blocks (4x4 cells) by response, then round-robin
    # across blocks — every block's best cell first, then every second-
    # best, ... — so each occupied ~50 px block gets features before any
    # block gets its r-th.
    BY = BX = 4
    nby, nbx = -(-ncy // BY), -(-ncx // BX)
    bs = jnp.pad(best_score, ((0, nby * BY - ncy), (0, nbx * BX - ncx)))
    blocks = bs.reshape(nby, BY, nbx, BX).transpose(0, 2, 1, 3) \
               .reshape(nby * nbx, BY * BX)
    order = jnp.argsort(-blocks, axis=-1)
    ranks = jnp.zeros_like(order).at[
        jnp.arange(nby * nbx)[:, None], order].set(
        jnp.broadcast_to(jnp.arange(BY * BX)[None, :], order.shape))
    ranks = jnp.where(blocks > 0, ranks, BY * BX)        # empty cells last
    # back to the [ncy, ncx] cell grid
    ranks = ranks.reshape(nby, nbx, BY, BX).transpose(0, 2, 1, 3) \
                 .reshape(nby * BY, nbx * BX)[:ncy, :ncx]
    key = best_score - ranks.astype(best_score.dtype) * (2.0 * INI_BOOST)

    flat_key = key.reshape(-1)
    k = min(quota, flat_key.shape[0])
    _, top_idx = jax.lax.top_k(flat_key, k)
    top_scores = best_score.reshape(-1)[top_idx]
    xs = xs_cell.reshape(-1)[top_idx]
    ys = ys_cell.reshape(-1)[top_idx]
    resp = jnp.where(top_scores > 0, top_scores % INI_BOOST, 0.0)
    if k < quota:  # pad (static)
        pad = quota - k
        xs = jnp.pad(xs, (0, pad))
        ys = jnp.pad(ys, (0, pad))
        resp = jnp.pad(resp, (0, pad))
    return xs, ys, resp


class OrbExtractor:
    """Compiles one extraction program per image geometry."""

    def __init__(self, n_features: int = 1500, scale_factor: float = 1.2,
                 n_levels: int = 8, ini_th: int = 12, min_th: int = 7):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = float(ini_th)
        self.min_th = float(min_th)
        self.quotas = level_quotas(n_features, n_levels, scale_factor)
        self._jitted = jax.jit(self._extract)

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** l for l in range(self.n_levels))

    @property
    def sigma2(self) -> np.ndarray:
        """Per-level measurement variance (scale^2), reference mvLevelSigma2."""
        return np.asarray([s * s for s in self.scales], np.float32)

    def __call__(self, img: jnp.ndarray, mask: Optional[jnp.ndarray] = None) -> OrbFeatures:
        h, w = img.shape
        if mask is None:
            mask = jnp.ones((h, w), jnp.float32)
        return self._jitted(img, mask)

    def _extract(self, img: jnp.ndarray, mask: jnp.ndarray) -> OrbFeatures:
        pyr = build_pyramid(img, mask, self.n_levels, self.scale_factor)
        return self._extract_from_pyramid(pyr)

    def _extract_from_pyramid(self, pyr) -> OrbFeatures:
        out_xy, out_resp, out_ang, out_oct, out_desc = [], [], [], [], []
        for lvl in range(self.n_levels):
            im = pyr.images[lvl]
            m = pyr.masks[lvl]
            h, w = im.shape
            quota = self.quotas[lvl]
            score = fast_score_map(im) * m
            # restrict to the detection border
            yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
            xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
            inside = ((yy >= MIN_BORDER) & (yy < h - MIN_BORDER) &
                      (xx >= MIN_BORDER) & (xx < w - MIN_BORDER))
            score = jnp.where(inside, score, 0.0)

            cell = _cell_size_for(h - 2 * MIN_BORDER, w - 2 * MIN_BORDER, quota)
            xs, ys, resp = _select_level_keypoints(
                score, quota, cell, self.ini_th, self.min_th)

            ang = keypoint_angles(im, xs, ys)
            blurred = gaussian_blur7(im)
            desc = compute_descriptors(blurred, xs, ys, ang)

            scale = self.scale_factor ** lvl
            xy0 = jnp.stack([xs.astype(jnp.float32), ys.astype(jnp.float32)],
                            axis=-1) * scale
            out_xy.append(xy0)
            out_resp.append(resp)
            out_ang.append(ang)
            out_oct.append(jnp.full((quota,), lvl, jnp.int32))
            out_desc.append(desc)

        xy = jnp.concatenate(out_xy, axis=0)
        resp = jnp.concatenate(out_resp, axis=0)
        ang = jnp.concatenate(out_ang, axis=0)
        octv = jnp.concatenate(out_oct, axis=0)
        desc = jnp.concatenate(out_desc, axis=0)
        # pad the slot count to a multiple of 128: every matcher and the
        # fused step are compiled for these padded shapes
        n = xy.shape[0]
        pad = (-n) % 128
        if pad:
            xy = jnp.pad(xy, ((0, pad), (0, 0)))
            resp = jnp.pad(resp, (0, pad))
            ang = jnp.pad(ang, (0, pad))
            octv = jnp.pad(octv, (0, pad))
            desc = jnp.pad(desc, ((0, pad), (0, 0)))
        valid = resp > 0
        return OrbFeatures(xy=xy, response=resp, angle=ang, octave=octv,
                           desc=desc, desc32=pack_u32(desc), valid=valid)
