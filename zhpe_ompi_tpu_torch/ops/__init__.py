"""Reduction operator table (namesake: ``zhpe_ompi_tpu/ops/__init__.py``).

Re-design of ``ompi/op`` + ``ompi/mca/op`` for PyTorch:

- every predefined op carries one **torch elementwise combine** (the JAX
  package's numpy/jax.numpy pair collapses to one function, since torch
  tensors live on the host and on the card alike);
- ops that ``torch.distributed`` reduces natively carry a ``reduce_op``
  hint (SUM, MAX, MIN → ``ReduceOp.SUM/MAX/MIN``), the counterpart of the
  JAX package's ``xla_collective`` hint, so the coll layer can skip the
  algorithmic path;
- the reference's COMMUTE / FLOAT_ASSOCIATIVE flags (``ompi/op/op.h:425-460``)
  are kept: ``coll/tuned`` sends non-commutative ops to the rank-ordered
  linear algorithms;
- MINLOC/MAXLOC combine ``(values, indices)`` tuples of tensors; ties go to
  the lower index, per the MPI standard;
- ``check_datatype`` holds an op to the datatype kinds it is defined for
  (the bitwise and logical ops take integers and bools only; the pair ops
  take pair types only), ``identity_for`` gives the identity element for a
  ``torch.dtype``, and :func:`op_reduce` is ``ompi_op_reduce``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core import errors
from ..datatype.predefined import Datatype, PairDatatype


class Op:
    """A reduction operator (``ompi_op_t`` analog)."""

    def __init__(
        self,
        name: str,
        fn: Callable | None,
        *,
        commute: bool = True,
        float_assoc: bool = True,
        reduce_op: Any = None,
        allowed_kinds: str | None = None,
        pair_op: bool = False,
        identity: Any = None,
    ) -> None:
        self.name = name
        self._fn = fn
        self.commute = commute
        #: False when floating-point reassociation must be avoided (the
        #: reference's FLOAT_ASSOCIATIVE flag).
        self.float_assoc = float_assoc
        #: ``torch.distributed.ReduceOp`` this op maps to natively, or None.
        self.reduce_op = reduce_op
        #: datatype kinds this op accepts (None = any numeric).
        self.allowed_kinds = allowed_kinds
        self.pair_op = pair_op
        #: identity element: a number, or "min"/"max" for the dtype's
        #: lowest/highest value.
        self._identity = identity
        self.is_user_defined = False

    def check_datatype(self, datatype: Datatype) -> None:
        if self.pair_op:
            if not isinstance(datatype, PairDatatype):
                raise errors.OpError(
                    f"{self.name} requires a pair datatype (e.g. "
                    f"MPI_FLOAT_INT), got {datatype.name}")
            return
        if isinstance(datatype, PairDatatype):
            raise errors.OpError(
                f"{self.name} does not accept pair datatype {datatype.name}")
        kind = getattr(datatype, "kind", "u")
        if self.allowed_kinds is not None and kind not in self.allowed_kinds:
            raise errors.OpError(
                f"{self.name} not defined for datatype {datatype.name}")

    def __call__(self, a, b):
        """Elementwise combine a ⊕ b.  MPI_Reduce semantics: ``a`` is the
        incoming (remote) operand, ``b`` the accumulator — order matters for
        non-commutative user ops (cf. ompi_op_reduce(op, source, target))."""
        if self._fn is None:
            raise errors.OpError(f"{self.name} has no combine function")
        return self._fn(a, b)

    def identity_for(self, dtype: torch.dtype) -> Any:
        """Identity element for padding, as a Python number of ``dtype``'s
        kind (raises for ops without one)."""
        if self._identity is None:
            raise errors.OpError(f"{self.name} has no identity element")
        if self._identity in ("min", "max"):
            low = self._identity == "min"
            if dtype == torch.bool:
                return not low
            if dtype.is_floating_point:
                return float("-inf") if low else float("inf")
            info = torch.iinfo(dtype)
            return info.min if low else info.max
        if dtype == torch.bool:
            return bool(self._identity)
        if dtype.is_complex:
            return complex(self._identity)
        if dtype.is_floating_point:
            return float(self._identity)
        return int(self._identity)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Op({self.name})"


def _pair_combine(better):
    """MINLOC/MAXLOC combine over ``(values, indices)`` tensor pairs."""

    def fn(a, b):
        av, ai = a
        bv, bi = b
        take_a = better(av, bv) | ((av == bv) & (ai < bi))
        return torch.where(take_a, av, bv), torch.where(take_a, ai, bi)

    return fn


def _logical(kind):
    f = {"and": torch.logical_and, "or": torch.logical_or,
         "xor": torch.logical_xor}[kind]

    def fn(a, b):
        return f(a != 0, b != 0).to(a.dtype)

    return fn


_R = dist.ReduceOp

MAX = Op("MPI_MAX", torch.maximum, reduce_op=_R.MAX, identity="min")
MIN = Op("MPI_MIN", torch.minimum, reduce_op=_R.MIN, identity="max")
SUM = Op("MPI_SUM", torch.add, reduce_op=_R.SUM, identity=0)
PROD = Op("MPI_PROD", torch.mul, identity=1)
LAND = Op("MPI_LAND", _logical("and"), allowed_kinds="iub", identity=1)
BAND = Op("MPI_BAND", torch.bitwise_and, allowed_kinds="iub", identity="max")
LOR = Op("MPI_LOR", _logical("or"), allowed_kinds="iub", identity=0)
BOR = Op("MPI_BOR", torch.bitwise_or, allowed_kinds="iub", identity=0)
LXOR = Op("MPI_LXOR", _logical("xor"), allowed_kinds="iub", identity=0)
BXOR = Op("MPI_BXOR", torch.bitwise_xor, allowed_kinds="iub", identity=0)
MAXLOC = Op("MPI_MAXLOC", _pair_combine(torch.gt), pair_op=True)
MINLOC = Op("MPI_MINLOC", _pair_combine(torch.lt), pair_op=True)
REPLACE = Op("MPI_REPLACE", lambda a, b: a, commute=False)
NO_OP = Op("MPI_NO_OP", lambda a, b: b, commute=False)

PREDEFINED = {
    op.name: op
    for op in (MAX, MIN, SUM, PROD, LAND, BAND, LOR, BOR, LXOR, BXOR,
               MAXLOC, MINLOC, REPLACE, NO_OP)
}


def lookup(name: str) -> Op:
    return PREDEFINED[name]


def create_op(fn: Callable, *, commute: bool = True,
              name: str = "user_op") -> Op:
    """MPI_Op_create: register a user combine ``fn(a, b) -> a ⊕ b`` on
    tensors.  Non-commutative ops restrict the algorithm space exactly as
    the reference's ``0 == ompi_op_is_commute`` checks do."""
    op = Op(name, fn, commute=commute, float_assoc=False)
    op.is_user_defined = True
    return op


def op_reduce(op: Op, source, target, datatype: Datatype | None = None):
    """ompi_op_reduce equivalent: target = source ⊕ target (elementwise)."""
    if datatype is not None:
        op.check_datatype(datatype)
    return op(source, target)
