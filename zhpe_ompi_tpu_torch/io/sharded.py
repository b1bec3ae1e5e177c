"""Sharded-array IO (namesake: ``zhpe_ompi_tpu/io/sharded.py``).

The file format is the JAX package's, byte for byte: a fixed 512-byte JSON
header (magic ``ZMPIARR1``, dtype, shape) padded with spaces, then the
array in C order.  bfloat16 is written under the header dtype
``"bfloat16"``, as the JAX package writes it, through a 16-bit integer
view: the port needs no ``ml_dtypes``.

A file view is a rank's extent of the array: :func:`load_sharded` with a
:class:`Placement` reads only that extent, onto that device, the port's
form of the namesake's per-device ``NamedSharding`` read.  With one
process per GPU a process holds whole tensors (its own shards), so
:func:`save_sharded` writes the tensor it is given.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core import errors

_MAGIC = "ZMPIARR1"
_HEADER = 512
_BF16 = "bfloat16"


@dataclass(frozen=True)
class Placement:
    """Where a loaded array goes: ``device``, and ``index`` (a basic numpy
    index, for example this rank's block ``(slice(r * b, (r + 1) * b),)``)
    to read only that extent; None reads the whole array."""

    device: Any
    index: Any = None


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return _BF16
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _header_bytes(dtype_name: str, shape) -> bytes:
    h = json.dumps({
        "magic": _MAGIC,
        "dtype": dtype_name,
        "shape": list(shape),
    }).encode()
    if len(h) > _HEADER - 1:
        raise errors.ArgError("header overflow (shape rank too large?)")
    return h + b" " * (_HEADER - len(h))


def _read_header(path: str) -> tuple[str, tuple[int, ...]]:
    with open(path, "rb") as f:
        raw = f.read(_HEADER)
    try:
        meta = json.loads(raw.decode().strip())
        if meta.get("magic") != _MAGIC:
            raise ValueError
    except (ValueError, UnicodeDecodeError):
        raise errors.ArgError(f"{path} is not a zmpi sharded-array file")
    return str(meta["dtype"]), tuple(meta["shape"])


def _host_array(arr) -> tuple[np.ndarray, str]:
    """The C-order host bytes of ``arr`` (a tensor on any device, or a
    numpy array) as a numpy array, and the header's dtype name."""
    if isinstance(arr, np.ndarray):
        return np.ascontiguousarray(arr), str(arr.dtype)
    t = torch.as_tensor(arr).detach().to("cpu").contiguous()
    name = _dtype_name(t)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def save_sharded(path: str, arr) -> None:
    """Write ``arr`` (a tensor on any device, or a numpy array): the header,
    then the data in C order.  A CUDA tensor is copied to the host first."""
    host, name = _host_array(arr)
    with open(path, "wb") as f:
        f.write(_header_bytes(name, host.shape))
        f.write(host.reshape(-1).view(np.uint8).data)


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.int16) if name == _BF16 else np.dtype(name)


def load_sharded(path: str, placement=None):
    """Read an array saved by :func:`save_sharded` (or by the JAX package's).
    Without ``placement``: a host numpy array, as the namesake returns,
    except for bfloat16, which numpy cannot hold without ``ml_dtypes``: a
    CPU ``torch.bfloat16`` tensor.  With a device (or a :class:`Placement`),
    a tensor on that device holding the whole array (or only the extent its
    ``index`` names; nothing else is read from the file)."""
    name, shape = _read_header(path)
    mm = np.memmap(path, dtype=_np_dtype(name), mode="r", offset=_HEADER,
                   shape=shape)
    if placement is None and name != _BF16:
        return np.array(mm)
    if placement is not None and not isinstance(placement, Placement):
        placement = Placement(placement)
    index = placement.index if placement is not None else None
    host = torch.from_numpy(np.array(mm if index is None else mm[index]))
    if name == _BF16:
        host = host.view(torch.bfloat16)
    return host if placement is None else host.to(placement.device)
