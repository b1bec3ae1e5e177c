"""Shared request-based-RMA plumbing for the OSC planes (namesake:
``zhpe_ompi_tpu/osc/rma_util.py``).

The in-process (`HostWindow`), wire (`AmWindow`) and direct-map
(`DirectWindow`) components expose an identical MPI_Rput/Rget surface; the
completed-request construction, the Fetch_and_op convenience and the
port's host-buffer conversions live here once so the planes cannot drift.

Window memory is host memory (numpy arrays, as in the namesake).  What
the port adds: :func:`host_array` turns an origin buffer into numpy — a
CPU tensor by ``Tensor.numpy()`` (a view), a CUDA tensor by an explicit
copy to the host — and :func:`deliver` copies a fetched result into a
caller's tensor (host to card for a CUDA one).  :func:`apply_op` runs a
port ``ops.Op`` (torch elementwise combines) on numpy operands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import errors


def completed_request(value=None):
    """A born-complete Request (local-completion semantics: the payload
    was serialized / applied before this returns)."""
    from ..pt2pt.requests import Request

    req = Request()
    req.complete(value)
    return req


def host_array(data) -> np.ndarray:
    """An origin buffer as a numpy array: numpy as given, a CPU tensor as
    its ``numpy()`` view, a tensor on another device copied to the host
    (the namesake's ``np.asarray`` of a device array).  bfloat16, which
    numpy lacks, is refused: move its bits as ``.view(torch.int16)`` or
    its values as ``.float()``."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bfloat16:
            raise errors.TypeError_(
                "bfloat16 has no numpy dtype: pass .view(torch.int16) to "
                "move the bits or .float() to move the values")
        return data.detach().cpu().resolve_conj().resolve_neg().numpy()
    return np.asarray(data)


def window_buffer(buf) -> np.ndarray:
    """A window's local memory as numpy: a numpy array as given, a CPU
    tensor as its ``numpy()`` view (RMA writes land in the tensor).  A
    window on the card is refused: window memory is host memory."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise errors.WinError(
                "window memory must be host memory (got a tensor on "
                f"{buf.device}): allocate it on the CPU and copy")
        if buf.dtype == torch.bfloat16:
            raise errors.WinError(
                "a bfloat16 window has no numpy dtype: expose "
                ".view(torch.int16) instead")
        return buf.detach().numpy()
    if not isinstance(buf, np.ndarray):
        raise errors.WinError("window buffer must be a numpy array or a "
                              "CPU tensor")
    return buf


def deliver(value: np.ndarray, out=None):
    """A fetched result, as numpy, or copied into ``out`` (a tensor,
    on the card or the CPU, or a numpy array) and ``out`` returned."""
    if out is None:
        return value
    if isinstance(out, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(value))
        out.copy_(src.reshape(out.shape))
        return out
    out[...] = value.reshape(out.shape)
    return out


def _tensor(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``x`` (a copy when ``x`` is read-only or
    strided, which ``torch.from_numpy`` cannot view safely)."""
    if not (x.flags.writeable and x.flags.c_contiguous):
        x = np.array(x, order="C")
    return torch.from_numpy(x)


_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def apply_op(op, incoming: np.ndarray, current: np.ndarray) -> np.ndarray:
    """``op(incoming, current)`` elementwise on numpy operands of one
    dtype, through the op's torch combine.  The unsigned widths torch
    cannot add (uint16/32/64) run on the signed view of their bits —
    exact modulo 2**n for the sums, products and bitwise ops — with the
    top bit flipped for MAX/MIN so the order is the unsigned one."""
    signed = _SIGNED.get(current.dtype)
    if signed is None:
        out = op(_tensor(incoming), _tensor(current))
        return out.numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out, current.dtype)
    flip = op.name in ("MPI_MAX", "MPI_MIN")
    bias = np.array(1 << (current.dtype.itemsize * 8 - 1), current.dtype)
    a, b = incoming, current
    if flip:
        a, b = a ^ bias, b ^ bias
    out = op(_tensor(a.view(signed)), _tensor(b.view(signed)))
    res = out.numpy().view(current.dtype)
    return res ^ bias if flip else res


class FetchOpMixin:
    """MPI_Fetch_and_op over the window's get_accumulate (the common
    atomic-counter idiom, single element)."""

    def fetch_and_op(self, value, target: int, offset: int = 0, op=None):
        from .. import ops as zops

        return self.get_accumulate(
            host_array(value).reshape(1), target, offset,
            op if op is not None else zops.SUM,
        )[0]
