"""DIA (diagonal) storage — the gather-free format for banded matrices.

No reference counterpart (the reference has only COO); this is an
addition of this library: for matrices whose nonzeros live on a bounded
set of diagonals (the BASELINE.md config-2 family and most
stencil/regridding operators), storing one contiguous array per diagonal
turns SpMV into shifted multiply-adds — no gather, no scatter, pure
memory-streaming work at ~4 bytes/nnz of data instead of the ~8+ of
ELL/CSR.

``offsets`` are static (part of the pytree treedef) so XLA sees fixed
shifts; ``data[d, i]`` holds ``A[i, i + offsets[d]]`` (row-oriented DIA).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .coo import SparseCOO

__all__ = ["SparseDIA", "to_dia", "dia_to_coo"]

Array = Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseDIA:
    """Diagonal storage: ``data (ndiag, nrows)``, static ``offsets``."""

    data: Array = dataclasses.field(metadata=dict(static=False))
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def nnz_stored(self) -> int:
        """Stored slots (includes explicit zeros inside the band)."""
        n = 0
        for off in self.offsets:
            n += max(0, min(self.nrows, self.ncols - off) - max(0, -off))
        return n

    def to_dense(self) -> Array:
        out = jnp.zeros(self.shape, self.data.dtype)
        rows = jnp.arange(self.nrows)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < self.ncols)
            out = out.at[rows, jnp.clip(cols, 0, self.ncols - 1)].add(
                jnp.where(ok, self.data[d], 0))
        return out


def dia_to_coo(dia: SparseDIA) -> SparseCOO:
    """DIA -> COO (eager): emits in-band slots with nonzero values."""
    data = np.asarray(dia.data)
    n, m = dia.shape
    rows, cols, vals = [], [], []
    for d, off in enumerate(dia.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        seg = data[d, lo:hi]
        nz = np.nonzero(seg)[0]
        rows.append(nz + lo)
        cols.append(nz + lo + off)
        vals.append(seg[nz])
    if rows:
        idx = np.stack([np.concatenate(rows), np.concatenate(cols)], 1)
        v = np.concatenate(vals)
    else:
        idx, v = np.zeros((0, 2), np.int64), np.zeros((0,))
    return SparseCOO.from_arrays(idx.astype(np.int32), v, dia.shape,
                                 check=False)


def to_dia(a: SparseCOO, offsets: Sequence[int] | None = None) -> SparseDIA:
    """COO → DIA (host-side, eager). ``offsets`` defaults to every diagonal
    that holds at least one nonzero."""
    idx, vals = a.to_lists()
    idx = np.asarray(idx, np.int64).reshape(len(vals), 2)
    vals = np.asarray(vals)
    offs = idx[:, 1] - idx[:, 0]
    if offsets is None:
        offsets = tuple(int(o) for o in np.unique(offs))
    else:
        offsets = tuple(int(o) for o in offsets)
    pos = {o: d for d, o in enumerate(offsets)}
    data = np.zeros((len(offsets), a.shape[0]), vals.dtype)
    for (i, j), v in zip(idx, vals):
        o = int(j - i)
        if o not in pos:
            raise ValueError(f"entry ({i},{j}) not on a listed diagonal")
        data[pos[o], i] += v
    return SparseDIA(data=jnp.asarray(data), offsets=offsets,
                     shape=a.shape)
