"""Input checks and NaN policing of the port.

Port of ``safepy_tpu/debug.py``:

- :func:`validate_network_arrays` (``:26``): structural checks of a dense
  Floyd-Warshall initialization (square, zero diagonal, no negative
  length, no NaN, symmetric on a seeded sample of entries);
- :func:`validate_attributes` (``:50``), which ``SAFE.load_attributes``
  runs on every attribute matrix it loads, as JAX's does
  (``safe.py:416-419``);
- :func:`checkify_pipeline` (``:76``), the counterpart of JAX's
  ``checkify`` wrapper: it runs a function and raises
  :class:`ValidationError` when a floating tensor it returns holds NaN.
"""

from __future__ import annotations

import logging

import numpy as np
import torch


class ValidationError(ValueError):
    """An input that would silently corrupt the results (``debug.py:22``)."""


def validate_network_arrays(dist0) -> None:
    """Raise :class:`ValidationError` unless ``dist0`` (numpy, or a tensor)
    is a square FW initialization with an exactly zero diagonal, no
    negative length, no NaN (+inf marks a non-edge) and, on up to 4,096
    entries drawn by ``default_rng(0)``, symmetric (``debug.py:26-47``)."""
    if isinstance(dist0, torch.Tensor):
        dist0 = dist0.cpu().numpy()
    dist0 = np.asarray(dist0)
    if dist0.ndim != 2 or dist0.shape[0] != dist0.shape[1]:
        raise ValidationError(f"distance init must be square, got "
                              f"{dist0.shape}")
    if not np.all(np.diagonal(dist0) == 0):
        raise ValidationError("distance init diagonal must be exactly 0")
    finite = np.isfinite(dist0)
    if np.any(dist0[finite] < 0):
        raise ValidationError("negative edge lengths are not allowed "
                              "(min-plus shortest paths require >= 0)")
    if np.isnan(dist0).any():
        raise ValidationError("distance init contains NaN (use +inf for "
                              "non-edges)")
    # a sample keeps the check O(N) at any N
    n = dist0.shape[0]
    rng = np.random.default_rng(0)
    ii = rng.integers(0, n, min(4096, n * 4))
    jj = rng.integers(0, n, ii.size)
    if not np.array_equal(dist0[ii, jj], dist0[jj, ii]):
        raise ValidationError("distance init is not symmetric")


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


def _floating_outputs(out):
    """The floating tensors and numpy arrays in ``out`` (nested tuples,
    lists and dict values)."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, np.ndarray):
        return [out] if out.dtype.kind in "fc" else []
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _floating_outputs(x)]
    if isinstance(out, dict):
        return [t for x in out.values() for t in _floating_outputs(x)]
    return []


def checkify_pipeline(fn):
    """Wrap ``fn`` so that it raises :class:`ValidationError` when a
    floating tensor (or numpy array) it returns holds NaN; returns the
    wrapper, which returns ``fn``'s output (``debug.py:76-88``).

    Each device's tensors are reduced on that device (one ``isnan().any()``
    a tensor, stacked) and read with one sync. This sees what ``fn``
    returns, where JAX's ``checkify`` instruments the traced program: a NaN
    made and dropped inside ``fn`` passes here. Out-of-range indices, the
    other half of JAX's checks, raise in torch itself (an ``IndexError`` on
    the host, a device assert on the card).
    """
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        by_device = {}
        for t in _floating_outputs(out):
            if isinstance(t, np.ndarray):
                if np.isnan(t).any():
                    raise ValidationError("a returned array holds NaN")
            else:
                by_device.setdefault(t.device, []).append(
                    torch.isnan(t).any())
        for flags in by_device.values():
            if bool(torch.stack(flags).any()):
                raise ValidationError("a returned tensor holds NaN")
        return out

    return run
