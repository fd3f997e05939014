"""Operands of the op-level surface onto the device they compute on.

Each JAX entry point of ``safepy_tpu.ops`` turns its operands into device
arrays with ``jnp.asarray`` (e.g. ``safepy_tpu/ops/apsp.py:120``), so numpy
input computes on the accelerator. :func:`on_device` does the same for the
port's entry points: a tensor stays on its device; any other operand (numpy
array, list, scalar) goes, in its own dtype as ``jnp.asarray`` keeps it, to
the device of the call's first tensor operand, else of its generator, else
to the card. Where that is the card and there is none, it raises before
anything is allocated: the host is asked for with CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def on_device(name: str, *operands, generator: torch.Generator | None = None):
    """``operands`` as tensors on the call's device (see the module doc),
    in order; ``None`` stays ``None``. ``name`` is the entry point, for the
    error message."""
    device = next((x.device for x in operands if isinstance(x, torch.Tensor)),
                  None)
    if device is None:
        device = (generator.device if generator is not None
                  else torch.device("cuda"))
    if all(x is None or isinstance(x, torch.Tensor) for x in operands):
        return operands
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} computes array-likes on the card, and no "
                           "CUDA device is available; pass CPU tensors to "
                           "compute on the host")
    return tuple(x if x is None or isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x), device=device)
                 for x in operands)
