"""MIP pyramids of image textures, built on the host.

The port's copy of the JAX package's ``ops/mipmap.py`` (reference
src/core/mipmap.rs): a non-power-of-two image is resampled up to powers of
two by a separable 4-tap Lanczos filter (mipmap.rs:56-196, resample_weights)
and each level below is the 2x2 box of the one above.  numpy, as in the
JAX package; ``scene/builder.py`` stacks every level into the scene's
texture atlas, one rect per (texture, level), and ``ops/texture.py``
reads them (``trilinear_lookup``).
"""

from __future__ import annotations

import numpy as np

MAX_LEVELS = 12


def _lanczos(x, tau=2.0):
    x = np.abs(x)
    return np.where(x < 1e-5, 1.0, np.where(x > 1.0, 0.0, np.sinc(x) * np.sinc(x / tau)))


def _resample_weights(old_res, new_res):
    """4-tap Lanczos magnification weights (mipmap.rs resample_weights):
    (first tap (new_res,) int32, weights (new_res, 4) f32)."""
    assert new_res >= old_res
    filter_width = 2.0
    first = np.zeros(new_res, np.int32)
    w = np.zeros((new_res, 4), np.float64)
    for i in range(new_res):
        center = (i + 0.5) * old_res / new_res
        first[i] = int(np.floor(center - filter_width + 0.5))
        for j in range(4):
            pos = first[i] + j + 0.5
            w[i, j] = _lanczos((pos - center) / filter_width)
        s = w[i].sum()
        if s != 0:
            w[i] /= s
    return first, w.astype(np.float32)


def _wrap_idx(idx, n, wrap):
    """Tap indices under the wrap mode: 0 repeat, else clamped (the black
    mode's outside is handled by the lookup's bounds)."""
    if wrap == 0:
        return np.mod(idx, n)
    return np.clip(idx, 0, n - 1)


def resample_pow2(img, wrap=0):
    """(H, W, 3) resampled to power-of-two sides with the separable
    Lanczos filter, negative results clamped to 0."""
    h, w = img.shape[:2]
    w2 = 1 << int(np.ceil(np.log2(max(w, 1))))
    h2 = 1 << int(np.ceil(np.log2(max(h, 1))))
    if w2 == w and h2 == h:
        return img.astype(np.float32)
    out = img.astype(np.float64)
    if w2 != w:
        first, wt = _resample_weights(w, w2)
        cols = _wrap_idx(first[:, None] + np.arange(4)[None, :], w, wrap)  # (w2, 4)
        out = (out[:, cols, :] * wt[None, :, :, None]).sum(2)
    if h2 != h:
        first, wt = _resample_weights(h, h2)
        rows = _wrap_idx(first[:, None] + np.arange(4)[None, :], h, wrap)
        out = (out[rows, :, :] * wt[:, :, None, None]).sum(1)
    return np.maximum(out, 0.0).astype(np.float32)


def build_pyramid(img, wrap=0, max_levels=MAX_LEVELS):
    """The MIP chain of (H, W, 3) img: level 0 the power-of-two resample,
    each next level the 2x2 box of the one before, down to one texel on the
    shorter side or max_levels levels."""
    base = resample_pow2(np.asarray(img, np.float32), wrap)
    levels = [base]
    cur = base
    while min(cur.shape[0], cur.shape[1]) > 1 and len(levels) < max_levels:
        h, w = cur.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        ys = np.minimum(2 * np.arange(nh), h - 1)
        xs = np.minimum(2 * np.arange(nw), w - 1)
        ys1 = np.minimum(ys + 1, h - 1)
        xs1 = np.minimum(xs + 1, w - 1)
        cur = 0.25 * (cur[np.ix_(ys, xs)] + cur[np.ix_(ys, xs1)]
                      + cur[np.ix_(ys1, xs)] + cur[np.ix_(ys1, xs1)])
        levels.append(cur.astype(np.float32))
    return levels
