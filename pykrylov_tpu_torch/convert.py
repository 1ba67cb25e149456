"""Carry stored matrices from the JAX package into this one.

The JAX package's sparse containers (``pykrylov_tpu.sparse.formats``) are
NamedTuples with the same field names as this package's.  Pass one with
its fields readable by ``np.asarray`` (its device arrays are) and get this
package's container holding the same values on ``device``, so that both
packages multiply by bit-identical stored matrices.  Nothing here imports
JAX: the container kind is recognised by its field names.  A BELL
container (``pykrylov_tpu.sparse.bell.BELL``) becomes this package's
:class:`~.sparse.bell.BELL` with the same arrays, plus the kernel's group
map built from its ``blocks``.
"""

from __future__ import annotations

import numpy as np

from .sparse import bell as B
from .sparse import formats as F
from .sparse.linop import SparseOperator
from .utils.types import to_tensor

__all__ = ["from_numpy", "operator_from_numpy"]

_KINDS = {frozenset(cls._fields): cls for cls in (F.COO, F.CSR, F.ELL,
                                                   F.DIA)}
_BELL_FIELDS = frozenset(B.BELL._fields) - {"grp_ptr", "grp_idx"}


def from_numpy(container, device="cuda"):
    """This package's COO/CSR/ELL/DIA/BELL container with the fields of
    ``container`` (a NamedTuple or a mapping of field names to arrays) as
    tensors on ``device``.  Index arrays of COO/CSR/ELL/DIA become int64
    (a BELL keeps the dtypes its kernel reads); bfloat16 values are
    carried bit for bit."""
    fields = (container._asdict() if hasattr(container, "_asdict")
              else dict(container))
    if frozenset(fields) == _BELL_FIELDS:
        return _bell(fields, device)
    cls = _KINDS.get(frozenset(fields))
    if cls is None:
        raise TypeError("no container has the fields %s" % sorted(fields))
    out = {}
    for name, value in fields.items():
        if name in ("shape", "offsets"):
            out[name] = tuple(int(v) for v in np.asarray(value))
        elif name == "data":
            out[name] = to_tensor(np.asarray(value), device=device)
        else:
            out[name] = to_tensor(np.asarray(value, dtype=np.int64),
                                  device=device)
    return cls(**out)


def operator_from_numpy(fwd, bwd=None, symmetric=False, fmt=None,
                        device="cuda"):
    """A :class:`~.sparse.linop.SparseOperator` over the converted
    containers: ``fwd`` for A and ``bwd`` (optional) for A^T, as the JAX
    package's ``SparseOperator.params`` holds them.  ``fmt="cuda-dia"``
    sends a DIA container's products through the CUDA kernel."""
    return SparseOperator(
        from_numpy(fwd, device),
        None if bwd is None else from_numpy(bwd, device),
        symmetric=symmetric, fmt=fmt)


def _bell(fields, device):
    """This package's BELL from a JAX BELL container's fields, with the
    arrays on ``device`` (``None``: NumPy arrays)."""
    arrays = ("data", "lanes", "bands", "blocks", "band_lo", "sp_row",
              "sp_col", "sp_val", "seg")
    out = {}
    for name, value in fields.items():
        if name in arrays:
            out[name] = None if value is None else np.asarray(value)
        elif name in ("shape", "padded_shape"):
            out[name] = tuple(int(v) for v in value)
        elif name == "idx_fmt":
            out[name] = str(value)
        else:
            out[name] = int(value)
    b = B.BELL(**out)
    grp_ptr, grp_idx = B._group_map(b.blocks, b.nblk)
    b = b._replace(grp_ptr=grp_ptr, grp_idx=grp_idx)
    return b if device is None else B.bell_to_device(b, device)
