"""zhpe_ompi_tpu_torch — the PyTorch and CUDA port of zhpe_ompi_tpu.

A second package beside the JAX one, with the same module paths and public
names, written for one process per NVIDIA Hopper GPU.  It imports torch and
never jax, and nothing of ``zhpe_ompi_tpu``.  The kernels the JAX package
wrote in Pallas for the TPU are hand-written CUDA here (``csrc/``), built
by ``nvcc`` on first use.

It carries the flagship transformer's forward pass and training step
(tensor, data and sequence parallelism, remat) through the framework
communicator, whose collectives compose ``coll/tuned`` over the
algorithm layer and the process group's native collectives::

    import torch.distributed as dist
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    dist.init_process_group("nccl", ...)
    tp_comm = zmpi.Communicator()              # the world group
    params = tfm.params_from_numpy(np_params, cfg)   # on CUDA
    logits = tfm.forward(params, tokens, cfg, tp_comm=tp_comm)

``init``/``host_init`` need the runtime layer and are not ported yet.
"""

from . import ops
from .comm.communicator import Communicator
from .comm.group import Group
from .core import errors
from .mca import component as mca_component
from .mca import output as mca_output
from .mca import var as mca_var
from .ops import (
    BAND,
    BOR,
    BXOR,
    LAND,
    LOR,
    LXOR,
    MAX,
    MAXLOC,
    MIN,
    MINLOC,
    PROD,
    SUM,
    create_op,
)

__version__ = "0.1.0"

__all__ = [
    "Communicator", "Group", "ops", "errors", "mca_var", "mca_component",
    "mca_output", "SUM", "MAX", "MIN", "PROD", "LAND", "LOR", "LXOR", "BAND",
    "BOR", "BXOR", "MAXLOC", "MINLOC", "create_op",
]
