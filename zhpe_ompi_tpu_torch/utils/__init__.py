"""Subpackage of the PyTorch port (namesake: the same path under zhpe_ompi_tpu)."""
