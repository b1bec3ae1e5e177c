"""zhpe_ompi_tpu_torch — the PyTorch and CUDA port of zhpe_ompi_tpu.

A second package beside the JAX one, with the same module paths and public
names, written for one process per NVIDIA Hopper GPU.  It imports torch and
never jax, and nothing of ``zhpe_ompi_tpu``.  The kernels the JAX package
wrote in Pallas for the TPU are hand-written CUDA here (``csrc/``), built
by ``nvcc`` on first use.

It carries the MPI entry point (``init``/``finalize``, COMM_WORLD and
COMM_SELF, the world mesh, the hooks), communicator construction
(``dup``, ``split``, ``create_from_group``) and the ULFM methods
(``revoke``, ``shrink``, ``agree``), and the flagship transformer's forward
pass and training step (tensor, data and sequence parallelism, remat)
through the framework communicator, whose collectives compose
``coll/tuned`` over the algorithm layer and the process group's native
collectives::

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    world = zmpi.init()          # joins torchrun's job when WORLD_SIZE > 1,
                                 # else a one-rank NCCL world
    mesh = zmpi.mesh.make_mesh({"dp": world.size, "tp": 1})
    dp_comm = zmpi.Communicator(mesh.get_group("dp"))
    tp_comm = zmpi.Communicator(mesh.get_group("tp"))
    params = tfm.params_from_numpy(np_params, cfg)   # on CUDA
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm)
    params, loss = step(params, tokens, targets)
    zmpi.finalize()

The host plane runs without ``torch.distributed``: a launcher starts the
processes with the ``ZMPI_*`` coordinator contract, and each calls
``zmpi.host_init()`` for its ``pt2pt/tcp.TcpProc`` endpoint (send/recv and
the host collectives; ``ZMPI_MCA_sm=0`` until ``pt2pt/sm.py`` is ported).
"""

from . import ops
from .comm.communicator import Communicator
from .comm.group import Group
from .core import errors
from .mca import component as mca_component
from .mca import output as mca_output
from .mca import var as mca_var
from .parallel import mesh
from .runtime import spc
from .runtime.init import (
    comm_self,
    finalize,
    host_finalize,
    host_init,
    host_world,
    init,
    initialized,
    is_finalized,
    world,
    world_mesh,
)
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
    "init", "finalize", "initialized", "is_finalized", "world", "comm_self",
    "world_mesh", "host_init", "host_world", "host_finalize", "mesh", "spc", "Communicator", "Group", "ops", "errors", "mca_var", "mca_component",
    "mca_output", "SUM", "MAX", "MIN", "PROD", "LAND", "LOR", "LXOR", "BAND",
    "BOR", "BXOR", "MAXLOC", "MINLOC", "create_op",
]
