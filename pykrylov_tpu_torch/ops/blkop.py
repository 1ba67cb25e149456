"""Block operators.

Counterpart of ``pykrylov_tpu/ops/blkop.py``, after the reference block
layer (``linop/blkop.py``): a 2-D grid of operators acting on conformally
split vectors, a block-diagonal variant, and preconditioner aliases
exposing ``solve``.  A product slices the input at fixed offsets, applies
each block and concatenates; on an (n, K) block each sub-operator's native
block rule runs (one SpMM launch a kernel-backed block), so a block of
kernel operators stays on the kernels.

Parity notes:
  * symmetric/hermitian construction auto-fills the lower triangle with
    ``.T``/``.H`` twins (``blkop.py:21-42``);
  * ``__getitem__`` returns sub-block operators for slice indexing
    (``blkop.py:122-144``, ``blkop.py:237-243``);
  * ``BlockDiagonalLinearOperator`` is symmetric iff all blocks are
    (``blkop.py:162-165``).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseLinearOperator, LinearOperator, ShapeError, _apply_any
from ..utils.types import result_type

__all__ = [
    "BlockLinearOperator",
    "BlockDiagonalLinearOperator",
    "BlockHorizontalLinearOperator",
    "BlockVerticalLinearOperator",
    "BlockPreconditioner",
    "BlockDiagonalPreconditioner",
]


def _offsets(sizes):
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return offs


def _grid_product(grid, rule, col_sizes):
    """``x -> [sum_j rule(grid[i][j])(x_j)]_i`` for a vector or a block;
    ``grid`` is called for the current grid at each product."""
    offs = _offsets(col_sizes)

    def mv(x):
        parts = []
        for row in grid():
            acc = None
            for j, op in enumerate(row):
                y = _apply_any(op, rule(op), x[offs[j]:offs[j + 1]])
                acc = y if acc is None else acc + y
            parts.append(acc)
        return torch.cat(parts)
    return mv


def _transposed(grid):
    return [list(col) for col in zip(*grid)]


class BlockLinearOperator(LinearOperator):
    """General block operator from a 2-D grid (list of lists) of operators.

    In symmetric/hermitian mode, pass only the upper triangle of each row;
    the lower triangle is completed with transposed/adjoint twins.
    """

    def __init__(self, blocks, symmetric=False, hermitian=False, **kwargs):
        if symmetric or hermitian:
            # upper-triangular input: row i has (nrow - i) blocks
            nrow = len(blocks)
            full = [[None] * nrow for _ in range(nrow)]
            for i, row in enumerate(blocks):
                if len(row) != nrow - i:
                    raise ShapeError("symmetric block structure must be "
                                     "upper triangular")
                for k, op in enumerate(row):
                    j = i + k
                    full[i][j] = op
                    if i != j:
                        full[j][i] = op.H if hermitian else op.T
                if not (full[i][i].symmetric
                        or (hermitian and full[i][i].hermitian)):
                    raise ValueError("diagonal blocks must be "
                                     "symmetric/hermitian")
            blocks = full
        ncol = len(blocks[0])
        for row in blocks:
            if len(row) != ncol:
                raise ShapeError("all block rows must have the same length")
        row_sizes = [row[0].nargout for row in blocks]
        col_sizes = [op.nargin for op in blocks[0]]
        for i, row in enumerate(blocks):
            for j, op in enumerate(row):
                if op.nargout != row_sizes[i] or op.nargin != col_sizes[j]:
                    raise ShapeError("block (%d,%d) has inconsistent shape"
                                     % (i, j))
        self._grid = [list(row) for row in blocks]
        self._row_sizes, self._col_sizes = row_sizes, col_sizes
        ops = [op for row in blocks for op in row]
        mv = _grid_product(lambda: self._grid, lambda op: op._mv, col_sizes)
        rmv = _grid_product(lambda: _transposed(self._grid),
                            lambda op: op._rmv, row_sizes)
        hmv = _grid_product(lambda: _transposed(self._grid),
                            lambda op: op._hmv, row_sizes)
        super().__init__(sum(col_sizes), sum(row_sizes), matvec=mv,
                         matvec_transp=rmv, matvec_adj=hmv,
                         symmetric=symmetric, hermitian=hermitian,
                         dtype=result_type(*[op.dtype for op in ops]),
                         device=ops[0].device, matmat=mv, matmat_transp=rmv,
                         **kwargs)

    @property
    def blocks(self):
        """The grid of blocks as a tuple of tuples."""
        return tuple(tuple(row) for row in self._grid)

    @property
    def params(self):
        return tuple(p for row in self._grid for op in row
                     for p in op.params)

    def __getitem__(self, indices):
        grid = np.empty((len(self._grid), len(self._grid[0])), dtype=object)
        for i, row in enumerate(self._grid):
            for j, op in enumerate(row):
                grid[i, j] = op
        sub = grid[indices]
        if isinstance(sub, np.ndarray):
            if sub.ndim == 1:
                # a 1-D selection is a block ROW unless the column index
                # was the scalar one: blk[0] / blk[0, :] -> 1xk row;
                # blk[:, 0] / blk[[0,1], 1] -> kx1 column
                if isinstance(indices, tuple) and np.isscalar(indices[1]):
                    sub = sub.reshape(-1, 1)
                else:
                    sub = sub.reshape(1, -1)
            return BlockLinearOperator([list(r) for r in sub])
        return sub

    def __setitem__(self, indices, val):
        i, j = indices
        if not isinstance(val, BaseLinearOperator):
            raise ValueError("block must be a linear operator")
        if val.shape != (self._row_sizes[i], self._col_sizes[j]):
            raise ShapeError(
                "block (%d,%d) must have shape %s, got %s"
                % (i, j, (self._row_sizes[i], self._col_sizes[j]),
                   val.shape))
        self._grid[i][j] = val
        # the products read the grid when they run; the twins are dropped
        # as in the JAX package, which rebuilds them against the new grid
        self._transpose_of = self._adjoint_of = self._conjugate_of = None

    def __contains__(self, op):
        return any(op is b or op == b for row in self._grid for b in row)

    def __iter__(self):
        for row in self._grid:
            yield from row


class BlockDiagonalLinearOperator(LinearOperator):
    """Block-diagonal operator from a 1-D list of blocks
    (``blkop.py:154-256``)."""

    def __init__(self, blocks, **kwargs):
        blocks = list(blocks)
        for op in blocks:
            if not isinstance(op, BaseLinearOperator):
                raise ValueError("blocks must be linear operators")
        self._blocks = blocks
        col_offs = _offsets([op.nargin for op in blocks])
        row_offs = _offsets([op.nargout for op in blocks])

        def diag_product(rule, offs):
            def mv(x):
                return torch.cat([
                    _apply_any(op, rule(op), x[offs[j]:offs[j + 1]])
                    for j, op in enumerate(self._blocks)])
            return mv

        mv = diag_product(lambda op: op._mv, col_offs)
        rmv = diag_product(lambda op: op._rmv, row_offs)
        super().__init__(
            col_offs[-1], row_offs[-1], matvec=mv, matvec_transp=rmv,
            matvec_adj=diag_product(lambda op: op._hmv, row_offs),
            symmetric=all(op.symmetric for op in blocks),
            hermitian=all(op.hermitian for op in blocks),
            dtype=result_type(*[op.dtype for op in blocks]),
            device=blocks[0].device, matmat=mv, matmat_transp=rmv, **kwargs)

    @property
    def blocks(self):
        return tuple(self._blocks)

    @property
    def params(self):
        return tuple(p for op in self._blocks for p in op.params)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return BlockDiagonalLinearOperator(self._blocks[idx])
        return self._blocks[idx]

    def __setitem__(self, idx, ops):
        blocks = list(self._blocks)
        blocks[idx] = ops
        if isinstance(idx, slice):
            self.__init__(blocks)
        else:
            if not isinstance(ops, BaseLinearOperator):
                raise ValueError("block must be a linear operator")
            self._blocks = blocks

    def __iter__(self):
        return iter(self._blocks)


def BlockHorizontalLinearOperator(blocks, **kwargs):
    """A 1 x k row of blocks as a single operator."""
    return BlockLinearOperator([list(blocks)], **kwargs)


def BlockVerticalLinearOperator(blocks, **kwargs):
    """A k x 1 column of blocks as a single operator."""
    return BlockLinearOperator([[b] for b in blocks], **kwargs)


class BlockPreconditioner(BlockLinearOperator):
    """Block operator with a ``solve`` alias for preconditioning
    (``blkop.py:259-266``)."""

    def solve(self, x):
        return self.__call__(x)


class BlockDiagonalPreconditioner(BlockDiagonalLinearOperator):
    """Block-diagonal preconditioner with ``solve``
    (``blkop.py:269-276``)."""

    def solve(self, x):
        return self.__call__(x)
