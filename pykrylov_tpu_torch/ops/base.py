"""Linear operators over torch tensors.

Counterpart of ``pykrylov_tpu/ops/base.py``.  The JAX package makes every
operator a pytree of parameters plus pure ``(params, x)`` functions so that
solvers can take it through ``jit``.  PyTorch runs eagerly, so here an
operator is a plain Python object whose products are closures over tensors
held on an explicit ``device``.  The semantics are the reference's
(``linop/linop.py``), as in the JAX package:

  * shape/dtype/symmetric/hermitian metadata and dtype promotion through all
    algebra (``linop.py:307-452``);
  * ``op.T`` / ``op.H`` are linked twins: ``op.T.T is op``
    (``linop.py:148-204``);
  * missing transpose/adjoint rules are inferred by conjugation for complex
    dtypes (``linop.py:211-254``);
  * scalar*op, op*op (the transpose reverses the order), op+op, op-op,
    op/scalar, op**k, -op, and 0*op -> ZeroOperator;
  * shape-checked application raising ``ShapeError`` (``linop.py:271-298``);
  * a host-side application counter ``nMatvec``.

A 2-D operand ``(n, K)`` goes through the operator's native block product
(``matmat=``) when it has one, so a sparse kernel streams A once for all K
columns (``ops/base.py:183-221,267-296,347-374`` of the JAX package); the
rule propagates through ``.T``/``.H``, scaling, products, sums and powers,
and an operator without one is applied column by column.

``params`` holds the tensors an operator's products read (a derived
operator collects its children's), through which the differentiable
solves reach a dense or diagonal operator's entries.  The module also
holds the COO, pysparse-adapter and reduced operators and ``sqrt``
(``linop.py:560-754``).
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..utils.ranks import rows
from ..utils.types import as_dtype, result_type, to_tensor

__all__ = [
    "ShapeError",
    "BaseLinearOperator",
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "ZeroOperator",
    "MatrixOperator",
    "CoordLinearOperator",
    "PysparseLinearOperator",
    "ReducedLinearOperator",
    "SymmetricallyReducedLinearOperator",
    "linop_from_ndarray",
    "aslinearoperator",
    "sqrt",
]


class ShapeError(ValueError):
    """Raised when operator/vector dimensions do not agree.

    Parity: ``linop/linop.py:626-635``.
    """


def _is_scalar(x):
    """Python/NumPy scalars and 0-d tensors or arrays."""
    if isinstance(x, numbers.Number):
        return True
    return isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim == 0


def _scalar_value(x):
    """(Python number, dtype) of a scalar operand."""
    if isinstance(x, (torch.Tensor, np.ndarray, np.generic)):
        return x.item(), result_type(x)
    return x, result_type(x)


class BaseLinearOperator:
    """Shape/dtype/symmetry metadata plus the host-side matvec counter.

    Parity: ``linop/linop.py:14-104``.
    """

    def __init__(self, nargin, nargout, symmetric=False, hermitian=False,
                 dtype=None, name=None, device="cuda"):
        self.__nargin = int(nargin)
        self.__nargout = int(nargout)
        self.__symmetric = bool(symmetric)
        self.__hermitian = bool(hermitian)
        self.__dtype = (as_dtype(dtype) if dtype is not None
                        else torch.get_default_dtype())
        self.__device = torch.device(device)
        self._nMatvec = 0
        self.name = name

    @property
    def nargin(self):
        """Dimension of the operator's domain (length of x in A*x)."""
        return self.__nargin

    @property
    def nargout(self):
        """Dimension of the operator's range (length of A*x)."""
        return self.__nargout

    @property
    def shape(self):
        return (self.__nargout, self.__nargin)

    @property
    def symmetric(self):
        return self.__symmetric

    @property
    def hermitian(self):
        return self.__hermitian

    @property
    def dtype(self):
        return self.__dtype

    @property
    def device(self):
        """The device of the tensors the operator holds."""
        return self.__device

    @property
    def nMatvec(self):
        """Number of shape-checked applications of this operator."""
        return self._nMatvec

    def reset_counters(self):
        self._nMatvec = 0

    def __call__(self, *args, **kwargs):
        return self.__mul__(*args, **kwargs)

    def __mul__(self, x):
        raise NotImplementedError("subclass must implement __mul__")

    def __repr__(self):
        sym = "symmetric" if self.symmetric else "unsymmetric"
        return "<%s %s %dx%d %s>" % (
            self.__class__.__name__, sym, self.nargout, self.nargin,
            self.dtype)


def _apply_fn(fn, x):
    if fn is None:
        raise NotImplementedError("operator does not define this product")
    return fn(x)


def _conj_mv(inner):
    def mv(x):
        return torch.conj(_apply_fn(inner, torch.conj(x))).resolve_conj()
    return mv


def _scaled(alpha, rdt, y):
    return y.to(torch.promote_types(y.dtype, rdt)) * alpha


def _block_apply(op, fn, X):
    """Apply one of ``op``'s 1-D rules to an (n, K) block: its native
    block rule when it has one, else column by column."""
    mm = op._mm_for(fn)
    if mm is not None:
        return mm(X)
    return torch.stack([_apply_fn(fn, X[:, j]) for j in range(X.shape[1])],
                       dim=1)


def _scale_mm(op, fn, value, rdt):
    return lambda X: _scaled(value, rdt, _block_apply(op, fn, X))


def _compose_mm(left, left_fn, right, right_fn):
    return lambda X: _block_apply(left, left_fn,
                                  _block_apply(right, right_fn, X))


def _add_mm(a, fa, b, fb):
    return lambda X: _block_apply(a, fa, X) + _block_apply(b, fb, X)


def _pow_mm(op, fn, k):
    def mm(X):
        for _ in range(k):
            X = _block_apply(op, fn, X)
        return X
    return mm


class LinearOperator(BaseLinearOperator):
    """A linear operator ``y = A @ x`` given by its product closures.

    Constructor mirrors the reference signature (``linop/linop.py:114``):
    ``LinearOperator(nargin, nargout, matvec, matvec_transp=None,
    matvec_adj=None, symmetric=..., hermitian=...)`` with each product a
    function of the vector alone.  ``matmat``/``matmat_transp`` are the
    optional native block products ``A @ X`` and ``A.T @ X`` on (n, K)
    blocks; a symmetric operator's transpose rule defaults to ``matmat``.

    ``params`` are the tensors the products read (the JAX package's
    ``A.params``): derived operators collect their children's, and the
    differentiable solves (:mod:`..solvers.diff`) pull a gradient back to
    those that require one.
    """

    def __init__(self, nargin, nargout, matvec, matvec_transp=None,
                 matvec_adj=None, symmetric=False, hermitian=False,
                 dtype=None, name=None, device="cuda", matmat=None,
                 matmat_transp=None, params=()):
        super().__init__(nargin, nargout, symmetric=symmetric,
                         hermitian=hermitian, dtype=dtype, name=name,
                         device=device)
        self._params = tuple(params)
        if self.symmetric and matmat_transp is None:
            matmat_transp = matmat
        self._mm = matmat
        self._rmm = matmat_transp
        mv, rmv, hmv = matvec, matvec_transp, matvec_adj
        # Fill in transpose/adjoint rules from symmetry and conjugation,
        # mirroring linop/linop.py:148-254.
        if self.symmetric and rmv is None:
            rmv = mv
        if self.hermitian and hmv is None:
            hmv = mv
        if not self.dtype.is_complex:
            # Real: transpose and adjoint coincide.
            if rmv is None and hmv is not None:
                rmv = hmv
            if hmv is None and rmv is not None:
                hmv = rmv
        else:
            if hmv is None and rmv is not None:
                hmv = _conj_mv(rmv)
            if rmv is None and hmv is not None:
                rmv = _conj_mv(hmv)
        self._mv = mv
        self._rmv = rmv
        self._hmv = hmv
        # Linked twins (built lazily; back-pointers give op.T.T is op).
        self._transpose_of = None
        self._adjoint_of = None
        self._conjugate_of = None

    def _like(self, nargin, nargout, matvec, matvec_transp=None,
              matvec_adj=None, symmetric=False, hermitian=False, dtype=None,
              suffix=None, matmat=None, matmat_transp=None, params=None):
        """A derived operator on this operator's device, reading this
        operator's ``params`` unless given others."""
        return LinearOperator(
            nargin, nargout, matvec, matvec_transp, matvec_adj,
            symmetric=symmetric, hermitian=hermitian,
            dtype=self.dtype if dtype is None else dtype,
            name=None if (self.name is None or suffix is None)
            else self.name + suffix,
            device=self.device, matmat=matmat, matmat_transp=matmat_transp,
            params=self.params if params is None else params)

    @property
    def params(self):
        """The tensors the products read (a tuple, possibly empty)."""
        return self._params

    # -- core application --------------------------------------------------
    def _as_tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return to_tensor(x, device=self.device)

    def _mm_for(self, fn):
        """The native block rule matching the 1-D rule ``fn``, or None.
        The adjoint reuses the transpose's block rule where the two 1-D
        rules are one (real dtypes)."""
        if fn is self._mv:
            return self._mm
        if fn is self._rmv or (fn is self._hmv and self._hmv is self._rmv):
            return self._rmm
        return None

    def _apply(self, fn, x, in_dim, out_dim):
        x = self._as_tensor(x)
        if x.ndim not in (1, 2) or rows(x) != in_dim:
            raise ShapeError(
                "operator %s cannot be applied to array of shape %s"
                % (repr(self), (tuple(x.shape),)))
        self._nMatvec += 1
        y = _apply_fn(fn, x) if x.ndim == 1 else _block_apply(self, fn, x)
        if rows(y) != out_dim:
            raise ShapeError(
                "operator %s produced array of leading dim %d, expected %d"
                % (repr(self), rows(y), out_dim))
        return y

    def matvec(self, x):
        """y = A @ x with shape checks (scipy-style alias: ``dot``)."""
        return self._apply(self._mv, x, self.nargin, self.nargout)

    def rmatvec(self, x):
        """y = A.H @ x — scipy.sparse.linalg compat (``linop.py:300``)."""
        return self._apply(self._hmv, x, self.nargout, self.nargin)

    dot = matvec

    def to_array(self):
        """Densify by applying to the identity (``linop.py:256-269``)."""
        eye = torch.eye(self.nargin, dtype=self.dtype, device=self.device)
        return torch.stack([_apply_fn(self._mv, eye[:, j])
                            for j in range(self.nargin)], dim=1)

    full = to_array

    # -- transpose / adjoint / conjugate ------------------------------------
    @property
    def T(self):
        if self._transpose_of is not None:
            return self._transpose_of
        if self.symmetric and self.nargin == self.nargout:
            return self
        t = self._like(
            self.nargout, self.nargin, self._rmv, self._mv,
            _conj_mv(self._mv) if self._rmv is not None else None,
            symmetric=self.symmetric, hermitian=self.hermitian, suffix=".T",
            matmat=self._rmm, matmat_transp=self._mm)
        t._transpose_of = self
        self._transpose_of = t
        return t

    @property
    def H(self):
        if self._adjoint_of is not None:
            return self._adjoint_of
        if self.hermitian and self.nargin == self.nargout:
            return self
        if not self.dtype.is_complex:
            return self.T
        h = self._like(
            self.nargout, self.nargin, self._hmv,
            _conj_mv(self._mv) if self._hmv is not None else None,
            self._mv,
            symmetric=self.symmetric, hermitian=self.hermitian, suffix=".H")
        h._adjoint_of = self
        self._adjoint_of = h
        return h

    @property
    def bar(self):
        """Complex-conjugate operator (``linop.py:206-254``)."""
        return self.conjugate()

    def conjugate(self):
        if self._conjugate_of is not None:
            return self._conjugate_of
        if not self.dtype.is_complex:
            return self
        c = self._like(
            self.nargin, self.nargout, _conj_mv(self._mv),
            _conj_mv(self._rmv) if self._rmv is not None else None,
            _conj_mv(self._hmv) if self._hmv is not None else None,
            symmetric=self.symmetric, hermitian=self.hermitian,
            suffix=".bar")
        c._conjugate_of = self
        self._conjugate_of = c
        return c

    # -- algebra -------------------------------------------------------------
    def _mul_scalar(self, alpha):
        value, adt = _scalar_value(alpha)
        rdt = result_type(self.dtype, adt)
        # 0 * op -> ZeroOperator (linop.py:307-314)
        if isinstance(alpha, numbers.Number) and value == 0:
            return ZeroOperator(self.nargin, self.nargout, dtype=rdt,
                                device=self.device)
        mv, rmv, hmv = self._mv, self._rmv, self._hmv
        conj_value = value.conjugate()
        return self._like(
            self.nargin, self.nargout,
            lambda x: _scaled(value, rdt, _apply_fn(mv, x)),
            (lambda x: _scaled(value, rdt, _apply_fn(rmv, x)))
            if rmv is not None else None,
            (lambda x: _scaled(conj_value, rdt, _apply_fn(hmv, x)))
            if hmv is not None else None,
            symmetric=self.symmetric,
            hermitian=self.hermitian and not rdt.is_complex, dtype=rdt,
            matmat=_scale_mm(self, mv, value, rdt),
            matmat_transp=_scale_mm(self, rmv, value, rdt)
            if rmv is not None else None)

    def _mul_linop(self, other):
        if self.nargin != other.nargout:
            raise ShapeError("cannot multiply %s with %s"
                             % (repr(self), repr(other)))
        a, b = self, other
        # (AB)^T = B^T A^T
        return self._like(
            other.nargin, self.nargout,
            lambda x: _apply_fn(a._mv, _apply_fn(b._mv, x)),
            (lambda x: _apply_fn(b._rmv, _apply_fn(a._rmv, x)))
            if (a._rmv is not None and b._rmv is not None) else None,
            (lambda x: _apply_fn(b._hmv, _apply_fn(a._hmv, x)))
            if (a._hmv is not None and b._hmv is not None) else None,
            dtype=result_type(self.dtype, other.dtype),
            matmat=_compose_mm(a, a._mv, b, b._mv),
            matmat_transp=_compose_mm(b, b._rmv, a, a._rmv)
            if (a._rmv is not None and b._rmv is not None) else None,
            params=a.params + b.params)

    def __mul__(self, x):
        if isinstance(x, BaseLinearOperator):
            return self._mul_linop(x)
        if _is_scalar(x):
            return self._mul_scalar(x)
        if isinstance(x, (torch.Tensor, np.ndarray, list, tuple)):
            return self._apply(self._mv, x, self.nargin, self.nargout)
        return NotImplemented

    def __rmul__(self, x):
        if _is_scalar(x):
            return self._mul_scalar(x)
        raise ValueError("cannot pre-multiply an operator by %s" % type(x))

    def __matmul__(self, x):
        return self.__mul__(x)

    def __add__(self, other):
        if not isinstance(other, BaseLinearOperator):
            raise ValueError("cannot add %s to an operator" % type(other))
        if self.shape != other.shape:
            raise ShapeError("cannot add %s and %s"
                             % (repr(self), repr(other)))
        a, b = self, other

        def both(fa, fb):
            if fa is None or fb is None:
                return None
            return lambda x: _apply_fn(fa, x) + _apply_fn(fb, x)

        return self._like(
            self.nargin, self.nargout, both(a._mv, b._mv),
            both(a._rmv, b._rmv), both(a._hmv, b._hmv),
            symmetric=a.symmetric and b.symmetric,
            hermitian=a.hermitian and b.hermitian,
            dtype=result_type(a.dtype, b.dtype),
            matmat=_add_mm(a, a._mv, b, b._mv),
            matmat_transp=_add_mm(a, a._rmv, b, b._rmv)
            if (a._rmv is not None and b._rmv is not None) else None,
            params=a.params + b.params)

    def __neg__(self):
        return self._mul_scalar(-1)

    def __sub__(self, other):
        if not isinstance(other, BaseLinearOperator):
            raise ValueError("cannot subtract %s from an operator"
                             % type(other))
        return self.__add__(-other)

    def __truediv__(self, other):
        if _is_scalar(other):
            if isinstance(other, numbers.Number) and other == 0:
                raise ZeroDivisionError("cannot divide operator by zero")
            value, _ = _scalar_value(other)
            return self._mul_scalar(1.0 / value)
        raise ValueError("cannot divide operator by %s" % type(other))

    def __pow__(self, k):
        if not isinstance(k, int) or k < 0:
            raise ValueError("power must be a nonnegative integer")
        if self.nargin != self.nargout:
            raise ShapeError("can only raise square operators to a power")
        if k == 0:
            return IdentityOperator(self.nargin, dtype=self.dtype,
                                    device=self.device)
        if k == 1:
            return self

        def power(fn):
            if fn is None:
                return None

            def mv(x):
                for _ in range(k):
                    x = _apply_fn(fn, x)
                return x
            return mv

        return self._like(self.nargin, self.nargout, power(self._mv),
                          power(self._rmv), power(self._hmv),
                          symmetric=self.symmetric,
                          hermitian=self.hermitian,
                          matmat=_pow_mm(self, self._mv, k),
                          matmat_transp=_pow_mm(self, self._rmv, k)
                          if self._rmv is not None else None)

    def _sqrt(self):
        raise NotImplementedError("no operator square root for %s"
                                  % repr(self))


# ---------------------------------------------------------------------------
# Simple concrete operators
# ---------------------------------------------------------------------------


class IdentityOperator(LinearOperator):
    """I_n (``linop.py:455-470``)."""

    def __init__(self, nargin, dtype=None, device="cuda", **kwargs):
        super().__init__(nargin, nargin, matvec=lambda x: x,
                         symmetric=True, hermitian=True, dtype=dtype,
                         device=device, **kwargs)

    def _sqrt(self):
        return self

    def __abs__(self):
        return self


class DiagonalOperator(LinearOperator):
    """diag(d) from a 1-D tensor or array (``linop.py:473-516``).

    Complex diagonals are symmetric but not hermitian; the adjoint applies
    the conjugate diagonal.
    """

    def __init__(self, diag, device="cuda", **kwargs):
        diag = to_tensor(diag, device=device).ravel()
        is_complex = diag.dtype.is_complex
        conj = diag.conj().resolve_conj() if is_complex else None
        super().__init__(rows(diag), rows(diag),
                         matvec=lambda x: diag * x,
                         matvec_adj=(lambda x: conj * x) if is_complex
                         else None,
                         symmetric=True, hermitian=not is_complex,
                         dtype=diag.dtype, device=diag.device,
                         matmat=lambda X: diag[:, None] * X, params=(diag,),
                         **kwargs)
        self.diag = diag

    def __abs__(self):
        return DiagonalOperator(self.diag.abs(), device=self.device)

    def _sqrt(self):
        # the reference refuses the square root of an indefinite diagonal
        if not self.diag.dtype.is_complex and bool((self.diag < 0).any()):
            raise ValueError("math domain error: negative diagonal entries")
        return DiagonalOperator(torch.sqrt(self.diag), device=self.device)


class ZeroOperator(LinearOperator):
    """0 of shape nargout x nargin (``linop.py:519-557``)."""

    def __init__(self, nargin, nargout, dtype=None, device="cuda",
                 **kwargs):
        dtype = as_dtype(dtype) if dtype is not None \
            else torch.get_default_dtype()

        def zeros(n):
            return lambda x: torch.zeros(
                n, dtype=torch.promote_types(dtype, x.dtype),
                device=x.device)

        super().__init__(nargin, nargout, matvec=zeros(nargout),
                         matvec_transp=zeros(nargin),
                         symmetric=(nargin == nargout),
                         hermitian=(nargin == nargout),
                         dtype=dtype, device=device, **kwargs)

    def _sqrt(self):
        return self

    def __abs__(self):
        return self


def _dense_product(A, x):
    ct = torch.promote_types(A.dtype, x.dtype)
    return torch.mv(A.to(ct), x.to(ct))


def _dense_block(A, X):
    ct = torch.promote_types(A.dtype, X.dtype)
    return torch.matmul(A.to(ct), X.to(ct))


class MatrixOperator(LinearOperator):
    """Dense-matrix operator (``linop_from_ndarray``,
    ``linop.py:723-745``); its block product is one dense matmul."""

    def __init__(self, A, symmetric=False, hermitian=False, device="cuda",
                 **kwargs):
        A = to_tensor(A, device=device)
        if A.ndim != 2:
            raise ShapeError("MatrixOperator expects a 2-D array")
        m, n = A.shape
        At = A.T
        Ah = A.conj().T.resolve_conj() if A.dtype.is_complex else At
        super().__init__(n, m, matvec=lambda x: _dense_product(A, x),
                         matvec_transp=lambda x: _dense_product(At, x),
                         matvec_adj=lambda x: _dense_product(Ah, x),
                         symmetric=symmetric, hermitian=hermitian,
                         dtype=A.dtype, device=A.device,
                         matmat=lambda X: _dense_block(A, X),
                         matmat_transp=lambda X: _dense_block(At, X),
                         params=(A,), **kwargs)
        self.matrix = A

    def to_array(self):
        return self.matrix


def linop_from_ndarray(A, symmetric=False, hermitian=False, device="cuda",
                       **kwargs):
    """Operator from a dense array or tensor (parity alias of
    :class:`MatrixOperator`; ``linop.py:723-745``)."""
    return MatrixOperator(A, symmetric=symmetric, hermitian=hermitian,
                          device=device, **kwargs)


# ---------------------------------------------------------------------------
# COO operator
# ---------------------------------------------------------------------------


def _segment_sum(vals, gather, scatter, x, n):
    """``y[scatter[e]] += vals[e] * x[gather[e]]`` for a vector or an (n,
    K) block ``x``."""
    v = vals if x.ndim == 1 else vals[:, None]
    contrib = v * x[gather]
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=contrib.dtype,
                    device=x.device)
    return y.index_add_(0, scatter, contrib)


class CoordLinearOperator(LinearOperator):
    """Operator from COO triples (vals, rows, cols) (``linop.py:638-685``).

    The reference loops over the nonzeros in Python; here a product is a
    gather and an ``index_add_`` (the JAX package's ``segment_sum``), for
    a vector or an (n, K) block alike.  With ``symmetric=True`` only one
    triangle is stored and the mirrored contribution is added on the fly,
    as in the reference.
    """

    def __init__(self, vals, rows, cols, nargin=0, nargout=0,
                 symmetric=False, device="cuda", **kwargs):
        vals = to_tensor(vals, device=device).ravel()
        rows = to_tensor(rows, device=vals.device).ravel().long()
        cols = to_tensor(cols, device=vals.device).ravel().long()
        if not (vals.shape == rows.shape == cols.shape):
            raise ShapeError("vals, rows, cols must have matching lengths")
        if nargin == 0:
            nargin = int(cols.max()) + 1 if cols.numel() else 0
        if nargout == 0:
            nargout = int(rows.max()) + 1 if rows.numel() else 0
        off = torch.where(rows != cols, vals, torch.zeros_like(vals)) \
            if symmetric else None

        def mv(x):
            y = _segment_sum(vals, cols, rows, x, nargout)
            if symmetric:
                y = y + _segment_sum(off, rows, cols, x, nargout)
            return y

        def rmv(x):
            y = _segment_sum(vals, rows, cols, x, nargin)
            if symmetric:
                y = y + _segment_sum(off, cols, rows, x, nargin)
            return y

        super().__init__(nargin, nargout, matvec=mv, matvec_transp=rmv,
                         symmetric=symmetric,
                         hermitian=symmetric and not vals.dtype.is_complex,
                         dtype=vals.dtype, device=vals.device, matmat=mv,
                         matmat_transp=rmv, params=(vals,), **kwargs)
        self.vals, self.rows, self.cols = vals, rows, cols


class PysparseLinearOperator(LinearOperator):
    """Adapter for external sparse-matrix objects (``linop.py:688-720``).

    The reference wraps pysparse matrices; this adapter accepts any host
    object exposing ``shape`` and either ``matvec(x, y)``/``matvec_transp(x,
    y)`` (the pysparse protocol) or ``A @ x`` (scipy.sparse).  A product is
    a direct host call: the vector is copied to the host, multiplied there,
    and the result copied back to the vector's device.
    """

    def __init__(self, A, device="cuda", **kwargs):
        m, n = A.shape
        dtype = np.dtype(getattr(A, "dtype", np.float64))
        issym = bool(getattr(A, "issym", False))

        def host_mv(x):
            if hasattr(A, "matvec") and not hasattr(A, "dot"):
                y = np.empty(m, dtype=dtype)
                A.matvec(x, y)
                return y
            return np.asarray(A @ x, dtype=dtype).ravel()

        def host_rmv(x):
            if issym:
                return host_mv(x)
            if hasattr(A, "matvec_transp"):
                y = np.empty(n, dtype=dtype)
                A.matvec_transp(x, y)
                return y
            return np.asarray(A.T @ x, dtype=dtype).ravel()

        def through_host(fn):
            return lambda x: to_tensor(fn(x.detach().cpu().numpy()),
                                       device=x.device)

        super().__init__(n, m, matvec=through_host(host_mv),
                         matvec_transp=through_host(host_rmv),
                         symmetric=issym, dtype=dtype, device=device,
                         **kwargs)


# ---------------------------------------------------------------------------
# Reduced operators
# ---------------------------------------------------------------------------


def _apply_any(op, fn, z):
    """``op``'s rule ``fn`` on a vector, or its block rule on a block."""
    return _apply_fn(fn, z) if z.ndim == 1 else _block_apply(op, fn, z)


def _restricted(op, fn, n_full, scatter_idx, gather_idx):
    """``x -> (op's fn)(z)[gather_idx]`` with ``z`` zero but
    ``z[scatter_idx] = x``."""
    if fn is None:
        return None

    def mv(x):
        z = torch.zeros((n_full,) + tuple(x.shape[1:]),
                        dtype=torch.promote_types(op.dtype, x.dtype),
                        device=x.device)
        z[scatter_idx] = x
        return _apply_any(op, fn, z)[gather_idx]
    return mv


def ReducedLinearOperator(op, row_indices, col_indices):
    """Restriction of ``op`` to row and column index subsets
    (``linop.py:560-591``): scatter, the full product, gather.  Not
    flagged symmetric even if ``op`` is (different index sets)."""
    ri = to_tensor(row_indices, device=op.device).ravel().long()
    ci = to_tensor(col_indices, device=op.device).ravel().long()
    mv = _restricted(op, op._mv, op.nargin, ci, ri)
    rmv = _restricted(op, op._rmv, op.nargout, ri, ci)
    return LinearOperator(ci.shape[0], ri.shape[0], matvec=mv,
                          matvec_transp=rmv, symmetric=False,
                          dtype=op.dtype, device=op.device, matmat=mv,
                          matmat_transp=rmv, params=op.params)


def SymmetricallyReducedLinearOperator(op, indices):
    """Symmetric restriction to one index set (``linop.py:594-623``)."""
    ix = to_tensor(indices, device=op.device).ravel().long()
    mv = _restricted(op, op._mv, op.nargin, ix, ix)
    rmv = _restricted(op, op._rmv, op.nargout, ix, ix)
    return LinearOperator(ix.shape[0], ix.shape[0], matvec=mv,
                          matvec_transp=rmv, symmetric=op.symmetric,
                          hermitian=op.hermitian, dtype=op.dtype,
                          device=op.device, matmat=mv, matmat_transp=rmv,
                          params=op.params)


def sqrt(op):
    """Operator square root, dispatching to ``op._sqrt``
    (``linop.py:748-754``)."""
    return op._sqrt()


def aslinearoperator(A, symmetric=False, hermitian=False):
    """Coerce A (operator / dense tensor or array) into a LinearOperator.
    A tensor stays on its device; an array goes to the card."""
    if isinstance(A, BaseLinearOperator):
        return A
    if isinstance(A, torch.Tensor):
        return MatrixOperator(A, symmetric=symmetric, hermitian=hermitian,
                              device=A.device)
    if isinstance(A, np.ndarray):
        return MatrixOperator(A, symmetric=symmetric, hermitian=hermitian)
    if callable(A):
        raise ValueError(
            "cannot infer shape from a bare callable; construct "
            "LinearOperator(nargin, nargout, matvec=...) explicitly")
    raise TypeError("cannot convert %s to a LinearOperator" % type(A))
