"""Runtime: init/finalize, performance counters, and the observability
substrate (namesake: ``zhpe_ompi_tpu/runtime``)."""
