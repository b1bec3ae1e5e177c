"""Pipeline parallelism: stage handoff over the framework's pt2pt shift
(namesake: ``zhpe_ompi_tpu/models/pipeline.py``).

GPipe microbatch pipelining over a 'pp' communicator: every rank owns one
block of layers; at each step it applies its block to the microbatch it
holds and hands the activations to the next stage with ``comm.shift(wrap=
False)``.  The bubble is (P-1)/(M+P-1).  Every stage runs the same
schedule, with microbatch ingestion and output recording decided by the
rank; the JAX package's ``lax.fori_loop`` is an eager loop of M + P - 1
steps here.
"""

from __future__ import annotations

from typing import Callable

import torch


def pipeline_apply(comm, stage_fn: Callable, stage_params, microbatches):
    """Run microbatches through the pipeline.

    comm         — communicator over the pipeline's P stages
    stage_fn     — (stage_params, x) -> y, this rank's layer block
    microbatches — (M, mb, ...) inputs (significant at stage 0)
    returns      — (M, mb, ...) outputs (significant at the last stage,
                   zeros elsewhere)
    """
    n = comm.size
    rank = comm.rank
    M = microbatches.shape[0]
    if n == 1:
        return torch.stack([stage_fn(stage_params, x) for x in microbatches])
    state = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(M)]
    for t in range(M + n - 1):
        # stage 0 ingests microbatch t; the others take what arrived
        x = microbatches[min(t, M - 1)] if rank == 0 else state
        y = stage_fn(stage_params, x)
        # the last stage records the microbatch that entered at t - (n-1)
        if rank == n - 1 and t >= n - 1:
            outputs[t - (n - 1)] = y
        state = comm.shift(y, 1, wrap=False)
    return torch.stack(outputs)
