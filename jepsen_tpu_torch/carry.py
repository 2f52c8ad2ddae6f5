"""Moving a dense-engine carry between the two packages.

The dense engine's carry is the whole state of a search between two
chunks: ``(e, table, slot_f, slot_a, slot_b, slot_occ, att, count,
max_count)``, with the JAX package's layout and dtypes. A JAX carry
fetched to the host is a tuple of numpy arrays; `carry_from_numpy` turns
it into the port's carry on a device, and `carry_to_numpy` turns the
port's carry back, so a search can start in one package and resume in
the other.
"""

from __future__ import annotations

import numpy as np
import torch

# (name, dtype, rank) per carry element, in carry order
LAYOUT = (("e", torch.int32, 0), ("table", torch.bool, 2),
          ("slot_f", torch.int32, 1), ("slot_a", torch.int32, 1),
          ("slot_b", torch.int32, 1), ("slot_occ", torch.bool, 1),
          ("att", torch.int32, 0), ("count", torch.int32, 0),
          ("max_count", torch.int32, 0))

_NP = {torch.int32: np.int32, torch.bool: np.bool_}


def carry_from_numpy(carry, device) -> tuple:
    """A port carry on `device` from a host carry of numpy arrays (or
    numpy scalars). Raises on a wrong length, dtype or rank rather than
    converting: a carry that does not have the layout is not a carry."""
    if len(carry) != len(LAYOUT):
        raise ValueError(f"a dense carry has {len(LAYOUT)} elements, "
                         f"got {len(carry)}")
    out = []
    for c, (name, dtype, rank) in zip(carry, LAYOUT):
        a = np.asarray(c)
        if a.dtype != _NP[dtype] or a.ndim != rank:
            raise TypeError(f"carry element {name}: want {dtype} of rank "
                            f"{rank}, got {a.dtype} of rank {a.ndim}")
        out.append(torch.from_numpy(np.array(a, copy=True)).to(device))
    p = out[2].shape[0]
    if any(t.shape != (p,) for t in out[3:6]) \
            or out[1].shape[1] != 1 << p:
        raise ValueError("carry slot arrays and table width disagree: "
                         f"P={p}, table {tuple(out[1].shape)}")
    return tuple(out)


def carry_to_numpy(carry) -> tuple:
    """The host copy of a port carry: numpy arrays with the JAX
    package's dtypes (0-d arrays for the scalars)."""
    return tuple(c.detach().cpu().numpy() for c in carry)
