"""Benchmark harness pieces the port's tools call (namesake: the repo's
``benchmarks/`` directory beside ``zhpe_ompi_tpu/``)."""
