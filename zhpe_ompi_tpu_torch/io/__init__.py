"""IO framework (namesake: ``zhpe_ompi_tpu/io``): MPI-IO re-designed for
the host plane, after ``ompi/mca/io/ompio`` and its sub-frameworks.

- :mod:`.file` — ``File``, the single-controller MPI_File (one object sees
  every rank of a thread universe), views decoded by the datatype engine's
  ``byte_index_map``; :mod:`.wirefile` — ``WireFile``, the same surface
  for launcher-started processes, with the ``sharedfp/lockedfile``
  sidecar and collective IO aggregated over the endpoint.
- :mod:`.fs` (filesystem operations), :mod:`.fbtl` (byte transfer, with
  the async worker) and :mod:`.fcoll` (collective aggregation strategies)
  are MCA frameworks selected by priority or ``ZMPI_MCA_<fw>``.
- :mod:`.sharded` — sharded-array files; :mod:`.ckptio` — the collective
  checkpoint plane.
"""

from __future__ import annotations

from .file import (
    MODE_APPEND,
    MODE_CREATE,
    MODE_DELETE_ON_CLOSE,
    MODE_EXCL,
    MODE_RDONLY,
    MODE_RDWR,
    MODE_WRONLY,
    File,
    delete,
)
from .ckptio import CheckpointWriteError, CollectiveCheckpointer
from .sharded import Placement, load_sharded, save_sharded

__all__ = [
    "CollectiveCheckpointer",
    "CheckpointWriteError",
    "File",
    "delete",
    "MODE_RDONLY",
    "MODE_RDWR",
    "MODE_WRONLY",
    "MODE_CREATE",
    "MODE_EXCL",
    "MODE_APPEND",
    "MODE_DELETE_ON_CLOSE",
    "Placement",
    "save_sharded",
    "load_sharded",
]
