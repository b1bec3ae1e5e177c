"""Fault tolerance (namesake: ``zhpe_ompi_tpu/ft``).  Only the revoked-cid
registry of ``ulfm`` is ported so far."""
