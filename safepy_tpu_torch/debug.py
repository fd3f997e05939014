"""Input checks of the port.

Port of the host checks of ``safepy_tpu/debug.py``: so far
:func:`validate_attributes` (``:50``), which ``SAFE.load_attributes`` runs
on every attribute matrix it loads, as JAX's does (``safe.py:416-419``).
"""

from __future__ import annotations

import logging

import numpy as np


class ValidationError(ValueError):
    """An input that would silently corrupt the results (``debug.py:22``)."""


def validate_attributes(node2attribute: np.ndarray, num_nodes: int,
                        warn: bool = True) -> None:
    """Raise :class:`ValidationError` unless ``node2attribute`` is a 2-D
    matrix with a row for each of the ``num_nodes`` nodes and no +/-inf
    (NaN marks a missing value); warn about columns that are all NaN
    (``debug.py:50-73``)."""
    if node2attribute.ndim != 2:
        raise ValidationError(f"attribute matrix must be 2-D, got "
                               f"{node2attribute.shape}")
    if node2attribute.shape[0] != num_nodes:
        raise ValidationError(
            f"attribute matrix has {node2attribute.shape[0]} rows for "
            f"{num_nodes} network nodes — misaligned labels?")
    # two nan-reductions find an inf without an (N, A) boolean temporary
    if node2attribute.size:
        with np.errstate(invalid="ignore"):
            lo = np.nanmin(node2attribute)
            hi = np.nanmax(node2attribute)
        if np.isinf(lo) or np.isinf(hi):
            raise ValidationError("attribute matrix contains +/-inf; use NaN "
                                  "for missing values")
    if warn:
        all_nan = np.all(np.isnan(node2attribute), axis=0)
        if all_nan.any():
            logging.warning("%d attribute column(s) are entirely NaN and will "
                            "produce empty enrichments", int(all_nan.sum()))
