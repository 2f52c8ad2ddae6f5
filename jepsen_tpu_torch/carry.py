"""Moving an engine carry between the two packages.

A carry is the whole state of a search between two chunks, with the JAX
package's layout and dtypes:

  * dense: ``(e, table, slot_f, slot_a, slot_b, slot_occ, att, count,
    max_count)``;
  * sort: ``(e, masks, states, valid, slot_f, slot_a, slot_b, slot_occ,
    overflow, att, count, max_count)``. The JAX carry holds the masks
    as uint32 words; the port holds the same bit patterns as int32
    (torch has no shifts on uint32), so they are viewed, not converted,
    on the way.

A JAX carry fetched to the host is a tuple of numpy arrays;
`carry_from_numpy` turns it into the port's carry on a device, and
`carry_to_numpy` turns the port's carry back, so a search can start in
one package and resume in the other. The layout is told by the length.

A batched carry (the JAX package's vmapped carry, `check_chunk_batch`'s)
has a leading B on every element: pass ``batch=True`` to
`carry_from_numpy`; `carry_to_numpy` takes either.
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
SORT_LAYOUT = (("e", torch.int32, 0), ("masks", torch.int32, 2),
               ("states", torch.int32, 1), ("valid", torch.bool, 1),
               ("slot_f", torch.int32, 1), ("slot_a", torch.int32, 1),
               ("slot_b", torch.int32, 1), ("slot_occ", torch.bool, 1),
               ("overflow", torch.bool, 0), ("att", torch.int32, 0),
               ("count", torch.int32, 0), ("max_count", torch.int32, 0))
_LAYOUTS = {len(LAYOUT): LAYOUT, len(SORT_LAYOUT): SORT_LAYOUT}
MASKS = 1   # the sort carry's uint32 element

_NP = {torch.int32: np.int32, torch.bool: np.bool_}


def _layout(carry) -> tuple:
    layout = _LAYOUTS.get(len(carry))
    if layout is None:
        raise ValueError(f"a carry has {len(LAYOUT)} (dense) or "
                         f"{len(SORT_LAYOUT)} (sort) elements, got "
                         f"{len(carry)}")
    return layout


def carry_from_numpy(carry, device, batch: bool = False) -> tuple:
    """A port carry on `device` from a host carry of numpy arrays (or
    numpy scalars); batch=True for a batched carry, each element with a
    leading B. Raises on a wrong length, dtype, rank or batch size rather
    than converting: a carry that does not have the layout is not a
    carry."""
    layout = _layout(carry)
    sort = layout is SORT_LAYOUT
    lead = int(batch)
    out = []
    for i, (c, (name, dtype, rank)) in enumerate(zip(carry, layout)):
        a = np.asarray(c)
        want = np.uint32 if sort and i == MASKS else _NP[dtype]
        if a.dtype != want or a.ndim != rank + lead:
            raise TypeError(f"carry element {name}: want {np.dtype(want)} "
                            f"of rank {rank + lead}, got {a.dtype} of rank "
                            f"{a.ndim}")
        a = np.array(a, copy=True)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(device))
    b = tuple(out[0].shape)           # () or (B,)
    if any(t.shape[:lead] != b for t in out):
        raise ValueError(f"carry elements disagree on the batch size: "
                         f"{[tuple(t.shape) for t in out]}")
    if sort:
        p, f = out[4].shape[lead], out[2].shape[lead]
        if any(t.shape[lead:] != (p,) for t in out[5:8]) \
                or out[3].shape[lead:] != (f,) \
                or out[1].shape[lead:] != (f, max(1, (p + 31) // 32)):
            raise ValueError("carry slot arrays and frontier disagree: "
                             f"P={p}, F={f}, masks {tuple(out[1].shape)}")
        return tuple(out)
    p = out[2].shape[lead]
    if any(t.shape[lead:] != (p,) for t in out[3:6]) \
            or out[1].shape[-1] != 1 << p:
        raise ValueError("carry slot arrays and table width disagree: "
                         f"P={p}, table {tuple(out[1].shape)}")
    return tuple(out)


def carry_to_numpy(carry) -> tuple:
    """The host copy of a port carry, batched or not: numpy arrays with
    the JAX package's dtypes (0-d arrays for the scalars of one carry;
    uint32 sort masks)."""
    out = tuple(c.detach().cpu().numpy() for c in carry)
    if _layout(carry) is SORT_LAYOUT:
        out = out[:MASKS] + (out[MASKS].view(np.uint32),) + out[MASKS + 1:]
    return out
