"""One rank of a multi-process gloo test of the PyTorch port.

Run by ``tests/test_torch_comm.py``, ``tests/test_torch_transformer.py`` and
``tests/test_torch_train.py`` as ``python _torch_dist_worker.py MODE RANK
WORLD DIR``: it joins a gloo
group through a ``FileStore`` in DIR, does MODE, and writes
``DIR/out<RANK>.npz``.  Imports the port, never jax.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _allreduce(comm, rank, out):
    import zhpe_ompi_tpu_torch as zmpi

    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal(16).astype(np.float32)
    flags = rng.integers(0, 2, 16).astype(np.int32)
    out["x"], out["flags"] = x, flags
    t = torch.from_numpy(x)
    for op in (zmpi.SUM, zmpi.MAX, zmpi.MIN):
        out[op.name] = comm.allreduce(t, op).numpy()
    f = torch.from_numpy(flags)
    for op in (zmpi.LAND, zmpi.LOR, zmpi.LXOR):
        out[op.name] = comm.allreduce(f, op).numpy()
    out["bcast"] = comm.bcast(t, root=1).numpy()
    out["input_untouched"] = t.numpy()
    out["coll_components"] = np.array(sorted({c for _, c in comm.coll.values()}))


def _transformer(comm, rank, world, out, workdir):
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    data = np.load(os.path.join(workdir, "inputs.npz"))
    cfg = tfm.Config(vocab=int(data["vocab"]), d_model=int(data["d_model"]),
                     n_heads=int(data["n_heads"]), d_ff=int(data["d_ff"]),
                     n_layers=int(data["n_layers"]), seq=int(data["seq"]),
                     dtype=torch.float32, flash=True, fused_ln=True)
    np_params = {k[2:]: data[k] for k in data.files if k.startswith("p_")}
    params = tfm.params_from_numpy(np_params, cfg, device="cpu",
                                   tp_rank=rank, tp=world)
    with torch.no_grad():
        out["logits"] = tfm.forward(params, data["tokens"], cfg,
                                    tp_comm=comm).numpy()
        out["loss"] = np.float32(tfm.loss_fn(params, data["tokens"],
                                             data["targets"], cfg,
                                             tp_comm=comm))


def _train(rank, world, out, workdir):
    """One ``make_train_step`` step at dp x tp = (world // 2) x 2: tp
    groups are consecutive rank pairs, dp groups the ranks of one tp
    index; each dp rank takes its slice of the batch."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    tp = 2
    dp = world // tp
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    dp_rank, tp_rank = rank // tp, rank % tp
    tp_comm = zmpi.Communicator(tp_groups[dp_rank], name="tp")
    dp_comm = zmpi.Communicator(dp_groups[tp_rank], name="dp")

    data = np.load(os.path.join(workdir, "inputs.npz"))
    cfg = tfm.Config(vocab=int(data["vocab"]), d_model=int(data["d_model"]),
                     n_heads=int(data["n_heads"]), d_ff=int(data["d_ff"]),
                     n_layers=int(data["n_layers"]), seq=int(data["seq"]),
                     dtype=torch.float32, flash=True, fused_ln=True,
                     ce_chunk=int(data["ce_chunk"]))
    np_params = {k[2:]: data[k] for k in data.files if k.startswith("p_")}
    params = tfm.params_from_numpy(np_params, cfg, device="cpu",
                                   tp_rank=tp_rank, tp=tp)
    b = data["tokens"].shape[0] // dp
    rows = slice(dp_rank * b, (dp_rank + 1) * b)
    step, specs = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=float(data["lr"]))
    new_params, loss = step(params, data["tokens"][rows], data["targets"][rows])
    out.update({f"p_{k}": v.numpy() for k, v in new_params.items()})
    out["loss"] = loss.numpy()
    out["dp_tp"] = np.array([dp_rank, tp_rank, dp_comm.size, tp_comm.size])


def run_ranks(mode: str, world: int, workdir, env=None, timeout: float = 120):
    """Start ``world`` ranks of this script in ``workdir`` and wait for them
    (each join bounded by ``timeout``).  Returns ``[(rc, output), ...]``
    and the loaded ``out<rank>.npz`` of every rank that wrote one."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child_env = dict(os.environ, **(env or {}))
    child_env["PYTHONPATH"] = repo + os.pathsep + child_env.get("PYTHONPATH", "")
    child_env["GLOO_SOCKET_IFNAME"] = "lo"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         str(workdir)],
        env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(world):
        path = os.path.join(str(workdir), f"out{r}.npz")
        outs.append(dict(np.load(path)) if os.path.exists(path) else None)
    return results, outs


def main() -> int:
    mode, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        import zhpe_ompi_tpu_torch as zmpi

        comm = zmpi.Communicator(name="test")
        out = {}
        if mode == "allreduce":
            _allreduce(comm, rank, out)
        elif mode == "transformer":
            _transformer(comm, rank, world, out, workdir)
        elif mode == "train":
            _train(rank, world, out, workdir)
        elif mode == "select":
            out["coll_components"] = np.array(
                sorted({c for _, c in comm.coll.values()}))
        else:
            raise SystemExit(f"unknown mode {mode}")
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
