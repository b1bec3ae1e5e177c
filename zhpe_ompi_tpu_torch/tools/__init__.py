"""Introspection tooling (ompi_info analog) (namesake:
``zhpe_ompi_tpu/tools/__init__.py``)."""
