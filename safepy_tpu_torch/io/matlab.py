"""MATLAB sessions of the legacy SAFE inputs.

Port of ``safepy_tpu/io/matlab.py``: ``scipy.io.loadmat`` with every
mat-struct turned into a nested dict.
"""

from __future__ import annotations


def load_mat(filename: str) -> dict:
    """loadmat with the mat_struct entries converted to nested dicts."""
    import scipy.io as spio

    data = spio.loadmat(filename, struct_as_record=False, squeeze_me=True)
    for key in data:
        if isinstance(data[key], spio.matlab.mat_struct):
            data[key] = _to_dict(data[key], spio.matlab.mat_struct)
    return data


def _to_dict(matobj, mat_struct) -> dict:
    out = {}
    for field in matobj._fieldnames:
        elem = matobj.__dict__[field]
        out[field] = (_to_dict(elem, mat_struct)
                      if isinstance(elem, mat_struct) else elem)
    return out
