"""IO framework (namesake: ``zhpe_ompi_tpu/io``).  Ported so far: the
sharded-array files (``io/sharded.py``).  ``file``, ``fs``, ``fbtl``,
``fcoll``, ``wirefile`` and ``ckptio`` wait for the host plane."""

from .sharded import Placement, load_sharded, save_sharded

__all__ = ["Placement", "save_sharded", "load_sharded"]
