"""Colormap helpers of the enrichment landscapes.

Port of ``safepy_tpu/colormaps.py:15-41`` (reference
``safepy/safe_colormaps.py``): a piecewise-linear normalizer through five
anchors for the diverging attribute maps, and the domain palette (black
first, the rest of an hsv sweep shuffled by a seedable generator).

The card's machine has no matplotlib, so importing this module imports
none: :func:`get_colors` imports it when called, and
:class:`MidpointRangeNormalize` (a ``matplotlib.colors.Normalize``) is
built on first access through the module's ``__getattr__``.
"""

from __future__ import annotations

import numpy as np


def get_colors(colormap="hsv", n=10, seed=None):
    """n domain RGBA colors: black first, the rest drawn from ``colormap``
    and shuffled by ``np.random.default_rng(seed)`` (``colormaps.py:29-41``;
    the same seed gives the JAX package's colors)."""
    import matplotlib
    cmap = matplotlib.colormaps[colormap]

    rgb = [(0, 0, 0, 1)]
    for c in np.arange(1, n):
        rgb.append(cmap(c / n))
    rgb = np.asarray(rgb)

    rng = np.random.default_rng(seed)
    rng.shuffle(rgb[1:])
    return rgb


def _build_normalize():
    import matplotlib.colors as colors

    class MidpointRangeNormalize(colors.Normalize):
        """Piecewise-linear normalize through (vmin, mid[0], mid[1],
        mid[2], vmax) (``colormaps.py:15-26``)."""

        def __init__(self, vmin=None, vmax=None, midrange=None, clip=False):
            self.midrange = midrange
            colors.Normalize.__init__(self, vmin, vmax, clip)

        def __call__(self, value, clip=None):
            anchors = np.array([self.vmin, *self.midrange, self.vmax],
                               dtype=float)
            quarters = np.linspace(0.0, 1.0, anchors.size)
            return np.ma.masked_invalid(np.interp(value, anchors, quarters))

    MidpointRangeNormalize.__module__ = __name__
    MidpointRangeNormalize.__qualname__ = "MidpointRangeNormalize"
    return MidpointRangeNormalize


def __getattr__(name):
    if name == "MidpointRangeNormalize":
        cls = _build_normalize()
        globals()[name] = cls  # built once
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
