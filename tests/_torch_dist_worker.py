"""One rank of a multi-process gloo test of the PyTorch port.

Run by the ``tests/test_torch_*.py`` files as ``python _torch_dist_worker.py
MODE RANK WORLD DIR``: it joins a gloo group through a ``FileStore`` in
DIR, does MODE, and writes ``DIR/out<RANK>.npz``.  Imports the port, never
jax.  ``coll_inputs`` and ``coll_cases`` define the collective checks,
``moe_pipe_inputs`` the MoE and pipeline inputs, ``shmem_cases`` the
device-heap programs (run by either package through ``run_shmem_case``)
and ``topo_cases`` the neighbor exchanges (built by ``build_topology``),
so that the tests can feed the same inputs to the JAX package.
``run_tcp_threads`` runs a ``TcpProc`` universe (either package's ranks)
in the calling test's threads.
"""

from __future__ import annotations

import functools
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
    out["MPI_PROD"] = comm.allreduce(t, zmpi.PROD).numpy()
    ints = torch.from_numpy(rng.integers(0, 64, 16).astype(np.int32))
    out["ints"], out["MPI_BAND"] = ints.numpy(), comm.allreduce(ints, zmpi.BAND).numpy()
    idx = torch.full((16,), rank, dtype=torch.int32)
    v, i = comm.allreduce((t, idx), zmpi.MINLOC)
    out["MINLOC_v"], out["MINLOC_i"] = v.numpy(), i.numpy()
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


def _groups(rank, dims):
    """This rank's communicators over a mesh of ``dims`` (name -> size, in
    the mesh's axis order; world rank = row-major index): one per axis,
    over the ranks that differ from this one in that axis only.  Every
    rank creates every group, in the same order, as dist.new_group
    requires."""
    import itertools

    import zhpe_ompi_tpu_torch as zmpi

    names, sizes = list(dims), list(dims.values())
    coords = np.unravel_index(rank, sizes)
    comms = {}
    for ax, name in enumerate(names):
        others = [range(sz) for i, sz in enumerate(sizes) if i != ax]
        for fixed in itertools.product(*others):
            ranks = []
            for i in range(sizes[ax]):
                c = list(fixed)
                c.insert(ax, i)
                ranks.append(int(np.ravel_multi_index(c, sizes)))
            pg = dist.new_group(ranks)
            if rank in ranks:
                comms[name] = zmpi.Communicator(pg, name=name)
    return comms, dict(zip(names, (int(c) for c in coords)))


def _spmd(comm, rank, world, out):
    """shift/ppermute/permute patterns, and their gradients."""
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.pt2pt import spmd

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    for off in (1, -1, 2):
        out[f"shift{off}_wrap"] = comm.shift(x, off).numpy()
        out[f"shift{off}_nowrap"] = comm.shift(x, off, wrap=False).numpy()
    # a pattern that leaves ranks 1.. without a sender, and rank 0 sending
    # to the last rank only
    out["ppermute_partial"] = comm.ppermute(x, [(0, world - 1)]).numpy()
    out["permute_reverse"] = comm.permute(
        x, [world - 1 - i for i in range(world)]).numpy()
    # strided (non-contiguous) buffers, bf16 and bool
    wide = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    out["strided"] = comm.shift(wide[:, 1::2], 1).numpy()
    out["transposed"] = comm.shift(wide.t(), 1).numpy()
    out["bf16"] = comm.shift(x.to(torch.bfloat16), 1).float().numpy()
    out["bool"] = comm.shift(x > 10 * rank + 2, 1).numpy()
    for name, pattern in (("dup_dst", [(0, 1), (2, 1)]),
                          ("dup_src", [(0, 1), (0, 2)])):
        try:
            spmd.ppermute(comm, x, pattern)
            out[name] = np.array("no error")
        except errors.ArgError as e:
            out[name] = np.array(str(e))
    # gradients: the cotangent travels the inverse permutation
    g = torch.zeros(2, 3, requires_grad=True)
    ct = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    for name, fn in (("shift", lambda t: spmd.shift(comm, t, 1)),
                     ("shift_nowrap", lambda t: spmd.shift(comm, t, 1, wrap=False)),
                     ("ppermute", lambda t: spmd.ppermute(
                         comm, t, [(i, (2 * i + 1) % world) for i in range(world)]
                         if world % 2 else [(i, world - 1 - i) for i in range(world)]))):
        y = fn(g + x)
        (grad,) = torch.autograd.grad(y, g, ct)
        out[f"grad_{name}"] = grad.numpy()


def coll_inputs(n: int) -> dict:
    """The inputs of the collective checks at comm size ``n``, one block
    per rank on axis 0, from a fixed seed."""
    rng = np.random.default_rng(1000 + n)
    counts = rng.integers(0, 4, (n, n))
    counts[0, -1] = 3  # at least one full block
    return {
        "x": rng.standard_normal((n, 12, 2)).astype(np.float32),
        "xp": rng.uniform(0.5, 1.5, (n, 12, 2)).astype(np.float32),
        "loc_v": rng.integers(0, 3, (n, 12)).astype(np.float32),
        "loc_i": (np.arange(12)[None] + 100 * np.arange(n)[:, None]).astype(np.int32),
        "xv": rng.standard_normal((n, n, 3, 2)).astype(np.float32),
        "counts": counts,
        "gv_counts": np.arange(1, n + 1),
        "xg": rng.standard_normal((n, n, 2)).astype(np.float32),
    }


_PYTREE_REDUCTIONS = {
    # the algorithms that take a (values, indices) tuple in the JAX package
    "allreduce_recursive_doubling", "allreduce_nonoverlapping",
    "allreduce_linear", "reduce_binomial", "reduce_linear", "reduce_binary",
    "reduce_in_order_binary", "scan_recursive_doubling", "scan_linear",
    "exscan_linear", "exscan_recursive_doubling",
}


def coll_cases(n: int) -> list:
    """``(case name, algorithm or comm method, kind, kwargs)`` for every
    algorithm of ``coll/algorithms.py`` and every communicator collective
    at comm size ``n``.  Kinds: ``red`` (x, op), ``plain`` (x), ``atv``
    (alltoallv), ``agv`` (allgatherv), ``barrier``; a name starting with
    ``comm.`` is the communicator method (the tuned path)."""
    roots = (0, n - 1)
    cases = []
    for a in ("recursive_doubling", "ring", "rabenseifner", "nonoverlapping",
              "segmented_ring", "linear"):
        cases.append((f"allreduce_{a}", f"allreduce_{a}", "red", {}))
    for a in ("binomial", "linear", "chain", "pipeline", "binary",
              "in_order_binary", "rabenseifner"):
        for r in roots:
            cases.append((f"reduce_{a}@{r}", f"reduce_{a}", "red", {"root": r}))
    for a in ("ring", "recursive_halving", "nonoverlapping", "butterfly"):
        cases.append((f"reduce_scatter_{a}", f"reduce_scatter_{a}", "red", {}))
    for a in ("linear", "recursive_doubling", "recursive_halving", "butterfly"):
        cases.append((f"reduce_scatter_block_{a}", f"reduce_scatter_block_{a}",
                      "red", {}))
    for a in ("scan_recursive_doubling", "scan_linear", "exscan_linear",
              "exscan_recursive_doubling"):
        cases.append((a, a, "red", {}))
    for a in ("binomial", "chain", "linear", "binary", "pipeline",
              "split_binary", "knomial", "scatter_allgather", "via_scatter"):
        for r in roots:
            cases.append((f"bcast_{a}@{r}", f"bcast_{a}", "plain", {"root": r}))
    for a in ("ring", "bruck", "recursive_doubling", "neighbor_exchange",
              "two_proc", "linear"):
        cases.append((f"allgather_{a}", f"allgather_{a}", "plain", {}))
    for a in ("pairwise", "bruck", "linear", "linear_sync", "two_proc"):
        cases.append((f"alltoall_{a}", f"alltoall_{a}", "plain", {}))
    cases.append(("alltoallv_padded", "alltoallv_padded", "atv", {}))
    for a in ("dissemination", "double_ring", "recursive_doubling", "two_proc",
              "tree", "linear"):
        cases.append((f"barrier_{a}", f"barrier_{a}", "barrier", {}))
    for a in ("gather_ring", "scatter_linear", "gather_binomial",
              "gather_linear_sync", "scatter_binomial"):
        for r in roots:
            cases.append((f"{a}@{r}", a, "plain", {"root": r}))
    cases.append(("allgatherv_concat", "allgatherv_concat", "agv", {}))
    # the communicator's collectives through the composed table (tuned)
    for m in ("allreduce", "reduce_scatter", "reduce_scatter_block", "scan",
              "exscan"):
        cases.append((f"comm.{m}", m, "red", {}))
    for r in roots:
        cases.append((f"comm.reduce@{r}", "reduce", "red", {"root": r}))
        for m in ("bcast", "gather", "scatter"):
            cases.append((f"comm.{m}@{r}", m, "plain", {"root": r}))
    for m in ("allgather", "alltoall"):
        cases.append((f"comm.{m}", m, "plain", {}))
    cases += [("comm.alltoallv", "alltoallv", "atv", {}),
              ("comm.allgatherv", "allgatherv", "agv", {}),
              ("comm.barrier", "barrier", "barrier", {})]
    return cases


def case_ops(name: str, kind: str) -> list:
    """The reduction ops a case runs with (names of the port's and the JAX
    package's ``ops`` module attributes); NONCOMM is the user op."""
    if kind != "red":
        return [None]
    base = name.split("@")[0]
    ops = ["SUM", "PROD", "MAX"]
    if base in _PYTREE_REDUCTIONS:
        ops.append("MINLOC")
    if base.startswith("comm.") and "scan" not in base:
        ops.append("NONCOMM")
    return ops


def noncommutative(a, b):
    """The user op of the checks: associative, not commutative."""
    return a * 2.0 + b


def _coll(comm, rank, world, out):
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.coll import algorithms as alg

    data = {k: v[rank] for k, v in coll_inputs(world).items()
            if k not in ("counts", "gv_counts")}
    counts = coll_inputs(world)["counts"].tolist()
    gv_counts = coll_inputs(world)["gv_counts"].tolist()
    ops = {name: getattr(zmpi, name) for name in ("SUM", "PROD", "MAX", "MINLOC")}
    ops["NONCOMM"] = zmpi.create_op(noncommutative, commute=False, name="nc")
    t = {k: torch.from_numpy(v.copy()) for k, v in data.items()}
    for name, fn_name, kind, kw in coll_cases(world):
        if name.startswith("comm."):
            call = getattr(comm, fn_name)
        else:
            call = functools.partial(getattr(alg, fn_name), comm)
        for opname in case_ops(name, kind):
            key = name if opname is None else f"{name}/{opname}"
            if kind == "red":
                if opname == "MINLOC":
                    x = (t["loc_v"], t["loc_i"])
                else:
                    x = t["xp"] if opname == "PROD" else t["x"]
                res = call(x, ops[opname], **kw)
            elif kind == "plain":
                res = call(t["x"], **kw)
            elif kind == "atv":
                res = call(t["xv"], counts)
            elif kind == "agv":
                res = call(t["xg"], gv_counts)
            else:
                res = call()
            if isinstance(res, tuple):
                out[key + "#v"], out[key + "#i"] = res[0].numpy(), res[1].numpy()
            else:
                out[key] = res.numpy()
    out["coll_components"] = np.array(sorted({c for _, c in comm.coll.values()}))


def ring_inputs(sp: int) -> dict:
    """Global (B, S, H, D) q, k, v and an output cotangent for the ring
    attention checks at ``sp`` ranks."""
    rng = np.random.default_rng(50 + sp)
    shape = (2, 16 * sp, 2, 8)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("q", "k", "v", "cot")}


RING_VARIANTS = [("contiguous", True), ("contiguous", False), ("zigzag", True)]


def _ring(comm, rank, world, out):
    """Ring attention outputs and q/k/v gradients on this rank's block, for
    each variant of RING_VARIANTS in f32 and bf16."""
    from zhpe_ompi_tpu_torch.models import ring_attention as ra

    inp = {k: torch.from_numpy(v) for k, v in ring_inputs(world).items()}
    for layout, causal in RING_VARIANTS:
        if layout == "zigzag":
            blocks = {k: ra.zigzag_shard(v, world)[rank] for k, v in inp.items()}
        else:
            s = inp["q"].shape[1] // world
            blocks = {k: v[:, rank * s:(rank + 1) * s] for k, v in inp.items()}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (blocks[n].to(dtype).requires_grad_(True)
                       for n in ("q", "k", "v"))
            if layout == "zigzag":
                o = ra.ring_attention_zigzag(comm, q, k, v)
            else:
                o = ra.ring_attention(comm, q, k, v, causal=causal)
            grads = torch.autograd.grad((o.float() * blocks["cot"]).sum(),
                                        (q, k, v))
            tag = f"{layout}_{'causal' if causal else 'full'}_{str(dtype)[6:]}"
            out[f"{tag}_out"] = o.float().detach().numpy()
            for n, g in zip("qkv", grads):
                out[f"{tag}_d{n}"] = g.float().numpy()


def _sp_train(rank, world, out, workdir):
    """One ``make_train_step`` step on a dp x tp x sp mesh (world rank =
    row-major index), the layout and the zigzag and remat flags from
    inputs.npz."""
    from zhpe_ompi_tpu_torch.models import ring_attention as ra
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    data = np.load(os.path.join(workdir, "inputs.npz"))
    dp, tp, sp = (int(v) for v in data["layout"])
    zigzag = bool(data["zigzag"])
    comms, at = _groups(rank, {"dp": dp, "tp": tp, "sp": sp})
    cfg = tfm.Config(vocab=int(data["vocab"]), d_model=int(data["d_model"]),
                     n_heads=int(data["n_heads"]), d_ff=int(data["d_ff"]),
                     n_layers=int(data["n_layers"]), seq=int(data["seq"]),
                     dtype=torch.float32, flash=True, fused_ln=True,
                     ce_chunk=int(data["ce_chunk"]), zigzag_sp=zigzag,
                     remat=bool(data["remat"]))
    np_params = {k[2:]: data[k] for k in data.files if k.startswith("p_")}
    params = tfm.params_from_numpy(np_params, cfg, device="cpu",
                                   tp_rank=at["tp"], tp=tp)
    b = data["tokens"].shape[0] // dp
    rows = slice(at["dp"] * b, (at["dp"] + 1) * b)

    def local(a):
        a = torch.from_numpy(a[rows])
        if zigzag:
            return ra.zigzag_shard(a[..., None], sp)[at["sp"]][..., 0]
        s = a.shape[1] // sp
        return a[:, at["sp"] * s:(at["sp"] + 1) * s]

    step, _ = tfm.make_train_step(cfg, comms["dp"],
                                  comms["tp"] if tp > 1 else None,
                                  comms["sp"], lr=float(data["lr"]))
    new_params, loss = step(params, local(data["tokens"]), local(data["targets"]))
    out.update({f"p_{k}": v.numpy() for k, v in new_params.items()})
    out["loss"] = loss.numpy()
    out["at"] = np.array([at["dp"], at["tp"], at["sp"]])


# -- runtime, communicator construction and mesh (slice 6) -------------------

# (name, colors, keys) of the split checks; the JAX side reads the same table
SPLIT_CASES = [
    ("even_odd", [0, 1, 0, 1], None),
    ("keys_reversed", [0, 0, 1, 1], [3, 2, 1, 0]),
    ("uneven", [2, 2, 2, 5], [0, 1, 2, 3]),
    ("one_group_keys", [0, 0, 0, 0], [1, 1, 0, 0]),
]
# (name, contributions, failed) of the agree checks
AGREE_CASES = [
    ("dead_false_ignored", [1, 1, 0, 1], [2]),
    ("live_false", [1, 0, 1, 1], [2]),
    ("all_true", [1, 1, 1, 1], []),
]
SHRINK_FAILED = [2]
CREATE_GROUP = [1, 3]


def flat_partition(partition):
    """A partition as one int array, its groups separated by -1."""
    out = []
    for g in partition:
        out.extend(g.ranks)
        out.append(-1)
    return np.array(out)


def _comm_facts(comm, prefix, rank, out):
    out[f"{prefix}_ranks"] = np.array(comm.group.ranks)
    out[f"{prefix}_rank"] = np.array(comm.rank)
    out[f"{prefix}_partition"] = flat_partition(comm.partition)
    out[f"{prefix}_sum"] = comm.allreduce(torch.tensor([rank + 1.0])).numpy()


def _split(rank, world, out):
    """C1 (dups of disjoint sub-communicators), split/create_from_group/
    split_type/shrink/agree against the JAX package's tables, revoke seen
    by every rank."""
    import time

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.comm.group import Group
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.runtime import init as rt

    # C1: each rank dups its own half, twice; the dups must not meet
    halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    own = zmpi.Communicator(halves[rank // 2], name="half")
    d1, d2 = own.dup(), own.dup()
    x = torch.tensor([rank + 1.0])
    out["c1_dup1"] = d1.allreduce(x).numpy()
    out["c1_dup2"] = d2.allreduce(x).numpy()
    out["c1_dup1_again"] = d1.allreduce(x * 10).numpy()
    # wrapping a group is local: an extra wrapper on rank 0 alone must not
    # shift the names of a later wrapper's dup (which would hang)
    if rank == 0:
        zmpi.Communicator(halves[0], name="diagnostic")
    late = zmpi.Communicator(halves[rank // 2], name="late")
    out["c1_after_extra_wrapper"] = late.dup().allreduce(x).numpy()

    world_comm = rt.init(device="cpu")  # adopts this process group
    for name, colors, keys in SPLIT_CASES:
        _comm_facts(world_comm.split(colors, keys), name, rank, out)
    _comm_facts(world_comm.create_from_group(Group(CREATE_GROUP)), "create",
                rank, out)
    _comm_facts(world_comm.split_type("shared"), "shared", rank, out)
    _comm_facts(world_comm.shrink(failed=SHRINK_FAILED), "shrink", rank, out)
    out["run"] = world_comm.run(lambda v: world_comm.allreduce(v) * 2,
                                torch.arange(8.0)).numpy()
    out["put"] = world_comm.device_put_sharded(np.arange(8.0)).numpy()

    # revoke: rank 0 revokes a dup; every rank must see it and raise
    rv = world_comm.dup(name="rv")
    rv.set_errhandler(errh.ERRORS_RETURN)
    rv.barrier()
    t0 = time.monotonic()
    if rank == 0:
        rv.revoke()
    while not rv.is_revoked() and time.monotonic() - t0 < 10.0:
        time.sleep(0.01)
    out["revoke_seen_s"] = np.array(time.monotonic() - t0)
    out["revoke_seen"] = np.array(rv.is_revoked())
    try:
        rv.allreduce(x)
        out["revoke_raised"] = np.array(False)
    except errors.Revoked:
        out["revoke_raised"] = np.array(True)

    # agree last: a rank named failed takes no further part
    for name, contributions, failed in AGREE_CASES:
        if rank in failed:
            continue
        out[f"agree_{name}"] = np.array(world_comm.agree(
            bool(contributions[rank]), failed=failed))
        out[f"agree_{name}_table"] = np.array(world_comm.agree(
            True, contributions=contributions, failed=failed))
    world_comm.barrier()
    rt.finalize()


def _runtime(rank, world, out):
    """runtime.init through torchrun's environment contract."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.runtime import init as rt
    from zhpe_ompi_tpu_torch.runtime import spc

    out["before"] = np.array(rt.initialized())
    w = rt.init(device="cpu")  # WORLD_SIZE > 1: joins without being told
    out["idempotent"] = np.array(rt.init(device="cpu") is w)
    out["world"] = np.array([w.rank, w.size])
    out["world_sum"] = w.allreduce(torch.tensor([rank + 1.0])).numpy()
    cs = rt.comm_self()
    out["self"] = np.array([cs.rank, cs.size, len(cs.partition), cs.uniform_size])
    out["self_sum"] = cs.allreduce(torch.tensor([rank + 1.0])).numpy()
    out["mesh"] = rt.world_mesh().mesh.numpy()
    out["init_count"] = np.array(spc.read("init_count"))
    out["is_zmpi_world"] = np.array(isinstance(w, zmpi.Communicator))
    rt.finalize()
    out["after"] = np.array([rt.initialized(), rt.is_finalized(),
                             dist.is_initialized()])


def _mesh(rank, world, out):
    """make_mesh's groups against _groups' (the layout make_train_step
    uses), world_mesh, and survivor_mesh's layouts."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod

    dims = MESH_DIMS[world]
    mesh = mesh_mod.make_mesh(dims)
    comms, at = _groups(rank, dims)
    for name in dims:
        pg = mesh.get_group(name)
        out[f"mesh_{name}"] = np.array(dist.get_process_group_ranks(pg))
        out[f"groups_{name}"] = np.array(comms[name].group.ranks)
        c = zmpi.Communicator(pg, name=name)
        out[f"sum_{name}"] = c.allreduce(torch.tensor([rank + 1.0])).numpy()
    out["coord"] = np.array(mesh.get_coordinate())
    out["at"] = np.array([at[n] for n in dims])
    out["world_mesh"] = mesh_mod.world_mesh().mesh.numpy()
    for axis, failed in SURVIVOR_CASES[world]:
        out[f"survivor_{axis}"] = mesh_mod.survivor_mesh(
            mesh, failed, axis).mesh.numpy()


def _optax(rank, world, out, workdir):
    """Two ``make_train_step_optax`` Adam steps at dp x tp = (world // 2) x
    2, laid out as ``_train``'s."""
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
                     dtype=torch.float32, flash=False, fused_ln=False)
    np_params = {k[2:]: data[k] for k in data.files if k.startswith("p_")}
    params = tfm.params_from_numpy(np_params, cfg, device="cpu",
                                   tp_rank=tp_rank, tp=tp)
    b = data["tokens"].shape[0] // dp
    rows = slice(dp_rank * b, (dp_rank + 1) * b)
    lr = float(data["lr"])
    init, step, _ = tfm.make_train_step_optax(
        cfg, dp_comm, tp_comm, optimizer=lambda ps: torch.optim.Adam(ps, lr=lr))
    opt = init(params)
    for i in (1, 2):
        params, opt, loss = step(params, opt, data["tokens"][rows],
                                 data["targets"][rows])
        out.update({f"s{i}_{k}": v.numpy().copy() for k, v in params.items()})
        out[f"s{i}_loss"] = loss.numpy()
    out["dp_tp"] = np.array([dp_rank, tp_rank])


def moe_pipe_inputs() -> dict:
    """The MoE and pipeline checks' inputs (the tests feed the same ones to
    the JAX package): ``moe_*`` at ep 4 (and ``moe2_*`` at ep 2) with T
    tokens per rank, D 8, F 16; ``pp_*`` for pp 4."""
    rng = np.random.default_rng(77)
    D, F, T = 8, 16, 16
    out = {}
    for tag, n in (("moe", 4), ("moe2", 2)):
        out[f"{tag}_router"] = (rng.standard_normal((D, n)) * D ** -0.5).astype(np.float32)
        out[f"{tag}_w_in"] = (rng.standard_normal((n, D, F)) * D ** -0.5).astype(np.float32)
        out[f"{tag}_w_out"] = (rng.standard_normal((n, F, D)) * F ** -0.5).astype(np.float32)
        out[f"{tag}_x"] = rng.standard_normal((n * T, D)).astype(np.float32)
        out[f"{tag}_cot"] = rng.standard_normal((n * T, D)).astype(np.float32)
    out["pp_w"] = (rng.standard_normal((4, D, D)) * 0.3).astype(np.float32)
    out["pp_x"] = rng.standard_normal((5, 3, D)).astype(np.float32)
    return out


MOE_CAPACITY = (1.25, 0.5)


def _moe_pipe(comm, rank, world, out, workdir):
    """moe_ffn at ep 4 (and ep 2 on each half) with gradients, pipeline_apply
    at pp 4 and pp 1, and the port's form of the dryrun's phase 2."""
    from zhpe_ompi_tpu_torch.models import moe, pipeline

    inp = moe_pipe_inputs()
    halves = comm.split([0, 0, 1, 1])
    for tag, c in (("moe", comm), ("moe2", halves)):
        n = c.size
        T = inp[f"{tag}_x"].shape[0] // n
        blk = slice(c.rank * T, (c.rank + 1) * T)
        for cf in MOE_CAPACITY:
            prm = moe.moe_params_from_numpy(
                {k: inp[f"{tag}_{k}"] for k in ("router", "w_in", "w_out")},
                device="cpu", ep_rank=c.rank)
            for t in prm.values():
                t.requires_grad_(True)
            x = torch.from_numpy(inp[f"{tag}_x"][blk].copy()).requires_grad_(True)
            y, keep = moe.moe_ffn(c, prm, x, capacity_factor=cf)
            (y * torch.from_numpy(inp[f"{tag}_cot"][blk])).sum().backward()
            key = f"{tag}@{cf}"
            out[f"{key}/y"], out[f"{key}/keep"] = y.detach().numpy(), keep.numpy()
            out[f"{key}/dx"] = x.grad.numpy()
            for k, t in prm.items():
                out[f"{key}/d{k}"] = t.grad.numpy()
    W = torch.from_numpy(inp["pp_w"][rank:rank + 1].copy())
    xs = torch.from_numpy(inp["pp_x"])
    stage = lambda w, t: t @ w[0] + 1.0  # noqa: E731
    out["pp4"] = pipeline.pipeline_apply(comm, stage, W, xs).numpy()
    selfc = comm.split([0, 1, 2, 3])
    out["pp1"] = pipeline.pipeline_apply(selfc, stage, W, xs).numpy()
    # the dryrun's phase 2 (__graft_entry__.py), per process
    data = np.load(os.path.join(workdir, "inputs.npz"))
    prm = moe.moe_params_from_numpy(
        {k: data[f"dry_{k}"] for k in ("router", "w_in", "w_out")},
        device="cpu", ep_rank=rank)
    y = comm.run(lambda xs: moe.moe_ffn(comm, prm, xs,
                                        capacity_factor=float(world))[0],
                 torch.from_numpy(data["dry_x"]))
    out["dry_moe"] = y.numpy()
    Ws = torch.from_numpy(data["dry_ws"])
    out["dry_pp"] = comm.run(
        lambda W, x: pipeline.pipeline_apply(
            comm, lambda w, t: t @ w[0] + 1.0, W, x),
        Ws, torch.from_numpy(data["dry_xs"]), in_specs=(0, None)).numpy()


# Device-heap programs, one per case, run by both packages: a case is
# (heap bytes, allocations [(shape, dtype)], epochs [[step, ...], ...]).
# Steps: ("set", sym, value), ("barrier",), ("put", sym, value, pe_of),
# ("get", sym, pe_of), ("fadd", sym, value, pe_of, index),
# ("add", sym, value, pe_of, index), ("bcast", sym, root),
# ("fcollect", dest, src), ("reduce", dest, src, op), ("alltoall", dest, src).
# Values: ("me", scale, offsets) = my_pe * scale + offsets (a number or a
# list), or ("local", sym).  pe_of: ("shift", k) = (r + k) % n, or a list.
def shmem_cases(n: int) -> dict:
    me = lambda scale=1.0, off=0.0: ("me", scale, off)  # noqa: E731
    const = lambda v: ("me", 0.0, v)  # noqa: E731
    f32, i32 = "float32", "int32"
    return {
        "put_shift": (1 << 14, [((4,), f32)], [[
            ("set", 0, me()), ("barrier",), ("put", 0, me(), ("shift", 1))]]),
        "get_neighbor": (1 << 14, [((2,), f32)], [[
            ("set", 0, me(10.0)), ("barrier",), ("get", 0, ("shift", -1))]]),
        "fadd_ring": (1 << 14, [((1,), f32)], [[
            ("set", 0, const(100.0)), ("barrier",),
            ("fadd", 0, me(1.0, 1.0), ("shift", 1), 0)]]),
        "state_across_epochs": (1 << 14, [((2,), i32)], [
            [("set", 0, me(2.0))], [("put", 0, ("local", 0), ("shift", 1))]]),
        "mixed_dtypes": (1 << 14, [((4,), f32), ((4,), i32)], [[
            ("set", 0, const(1.5)), ("set", 1, const(7.0))]]),
        "broadcast": (1 << 14, [((3,), f32)], [[
            ("set", 0, me()), ("bcast", 0, n - 1)]]),
        "fcollect": (1 << 14, [((2,), f32), ((2 * n,), f32)], [[
            ("set", 0, me(1.0, [0.0, 0.5])), ("fcollect", 1, 0)]]),
        "reduce_max": (1 << 14, [((4,), f32), ((4,), f32)], [[
            ("set", 0, me()), ("reduce", 1, 0, "MAX")]]),
        "alltoall": (1 << 14, [((n,), f32), ((n,), f32)], [[
            ("set", 0, me(10.0, [float(j) for j in range(n)])),
            ("alltoall", 1, 0)]]),
        "fadd_one_counter": (1 << 14, [((1,), f32)], [[
            ("set", 0, const(100.0)), ("barrier",),
            ("fadd", 0, me(1.0, 1.0), [0] * n, 0)]]),
        "add_two_groups_idle": (1 << 14, [((2,), i32)], [[
            ("set", 0, const(0.0)), ("barrier",),
            ("add", 0, me(1.0, 1.0), [0, 0, 2, -1][:n], 1)]]),
        "fadd_idle_fetch_zero": (1 << 14, [((1,), f32)], [[
            ("set", 0, const(100.0)), ("barrier",),
            ("fadd", 0, const(1.0), [0, 0] + [-1] * (n - 2), 0)]]),
        "barrier_orders": (1 << 14, [((1,), f32)], [[
            ("set", 0, me()), ("barrier",), ("get", 0, ("shift", 1))]]),
        # __graft_entry__.py's third phase
        "dryrun_phase3": (1 << 12, [((2,), f32)], [[
            ("set", 0, me()), ("barrier",),
            ("put", 0, ("me", 1.0, [0.0, 0.0]), ("shift", 1)),
            ("fadd", 0, const(1.0), ("shift", 1), 0)]]),
    }


def run_shmem_case(heap, case, value, pe_of, op_of, stack, zeros):
    """Run one ``shmem_cases`` program on ``heap`` (either package's
    DeviceHeap): ``value(pe, spec, sym)`` makes a value, ``pe_of(spec)`` a
    schedule, ``op_of(name)`` an op, ``stack(outs)`` one (1, k) output per
    epoch and ``zeros()`` the epoch's dim-0 argument.  Returns the syms
    and each epoch's output."""
    _, allocs, epochs = case
    syms = [heap.shmalloc(shape, dtype) for shape, dtype in allocs]
    outs = []
    for steps in epochs:
        def prog(pe, _, steps=steps):
            got = []
            for st in steps:
                kind = st[0]
                if kind == "set":
                    pe = pe.local_set(syms[st[1]], value(pe, st[2], syms[st[1]]))
                elif kind == "barrier":
                    pe = pe.barrier()
                elif kind == "put":
                    pe = pe.put(syms[st[1]], value(pe, st[2], syms[st[1]]), pe_of(st[3]))
                elif kind == "get":
                    got.append(pe.get(syms[st[1]], pe_of(st[2])))
                elif kind == "fadd":
                    old, pe = pe.fadd(syms[st[1]], value(pe, st[2], syms[st[1]]),
                                      pe_of(st[3]), index=st[4])
                    got.append(old)
                elif kind == "add":
                    pe = pe.add(syms[st[1]], value(pe, st[2], syms[st[1]]),
                                pe_of(st[3]), index=st[4])
                elif kind == "bcast":
                    pe = pe.broadcast(syms[st[1]], root=st[2])
                elif kind == "fcollect":
                    pe = pe.fcollect(syms[st[1]], syms[st[2]])
                elif kind == "reduce":
                    pe = pe.reduce_to_all(syms[st[1]], syms[st[2]], op_of(st[3]))
                elif kind == "alltoall":
                    pe = pe.alltoall(syms[st[1]], syms[st[2]])
            return pe, stack(got)
        outs.append(heap.epoch(prog, zeros()))
    return syms, outs


def _osc_shmem(comm, rank, world, out):
    """DeviceWindow schedules and the device heap (``shmem_cases``), and
    their errors, at ``world`` ranks."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.osc import DeviceWindow
    from zhpe_ompi_tpu_torch.runtime import spc
    from zhpe_ompi_tpu_torch.shmem import spml
    from zhpe_ompi_tpu_torch.shmem.device import DeviceHeap

    n = world
    ring = [(i + 1) % n for i in range(n)]
    me = torch.tensor([float(rank)])
    win = DeviceWindow(comm, torch.zeros(2))
    out["win_put"] = win.put(me, ring, [0] * n).shard.numpy()
    out["win_put_untouched"] = win.shard.numpy()
    win = DeviceWindow(comm, me * 10)
    out["win_get"] = win.get(ring, [0] * n, count=1).numpy()
    win = DeviceWindow(comm, torch.full((3,), 100.0))
    out["win_acc_sum"] = win.accumulate(me + 1, ring, [1] * n).shard.numpy()
    out["win_acc_max"] = win.accumulate(me * 60, ring, [2] * n, zmpi.MAX).shard.numpy()
    out["win_fence"] = win.fence().shard.numpy()
    errs = []
    for call in (lambda: win.put(torch.zeros(2), ring, [2] * n),
                 lambda: win.get(ring, [0] * n, count=4),
                 lambda: win.accumulate(torch.zeros(3), ring, [1] * n),
                 lambda: win.put(me, [0] * n, [0] * n),
                 lambda: win.accumulate(me, [0] * n, [0] * n),
                 lambda: win.get([0] * n, [0] * n, count=1),
                 lambda: win.put(me, ring[:-1], [0] * n)):
        try:
            call()
            errs.append("none")
        except errors.MpiError as e:
            errs.append(type(e).__name__)
    for meth in ("lock", "lock_all", "unlock", "unlock_all", "flush",
                 "flush_all", "flush_local"):
        try:
            getattr(win, meth)(0)
        except errors.WinError as e:
            errs.append(f"{meth}:{'AM component' in str(e)}")
    out["win_errors"] = np.array(errs)

    # selection
    out["spml_selected"] = np.array(spml.select_spml(comm).name)
    heap = spml.shmem_pe(comm, heap_bytes=1 << 12)
    out["shmem_pe"] = np.array([type(heap).__name__, heap.plane])
    heap.finalize()
    mca_var.set_var("spml", "^device")
    try:
        spml.select_spml(comm)
        out["spml_excluded"] = np.array("selected")
    except errors.InternalError:
        out["spml_excluded"] = np.array("InternalError")
    finally:
        mca_var.unset("spml")
    try:
        spml.DirectSpml().make(comm, 1 << 12)
    except errors.UnsupportedError as e:
        out["spml_direct"] = np.array(str(e))

    # deterministic offsets and arenas
    heap = DeviceHeap(comm, heap_bytes=1 << 14)
    a = heap.shmalloc(4, torch.float32)
    b = heap.shmalloc(8, np.float32)
    heap.shfree(a)
    c = heap.shmalloc(2, torch.float32)
    i = heap.shmalloc(4, torch.int32)
    out["offsets"] = np.array([a.offset, b.offset, c.offset, i.offset])
    out["arenas"] = np.array(sorted(heap._arenas))
    out["arena_elems"] = np.array([heap._arenas[a.arena].numel(),
                                   heap._arenas[i.arena].numel()])
    errs = []
    for prog in (lambda pe, _: (pe.put(a, torch.zeros(1), [n] * n), None),
                 lambda pe, _: (pe.put(a, torch.zeros(1), [0] * n), None),
                 lambda pe, _: (pe.fcollect(c, a), None),
                 lambda pe, _: (pe.put(c, torch.zeros(3), ring), None),
                 lambda pe, _: (pe.broadcast(a, root=n), None),
                 lambda pe, _: (pe.add(a, 1.0, ring, index=4), None)):
        try:
            heap.epoch(prog, torch.zeros((n, 1)))
            errs.append("none")
        except errors.MpiError as e:
            errs.append(type(e).__name__)
    out["heap_errors"] = np.array(errs)
    heap.finalize()

    # the programs both packages run
    before = spc.read("pgas_device_epochs")

    def value(pe, spec, sym):
        if spec[0] == "local":
            return pe.local(sym)
        return pe.my_pe() * spec[1] + torch.as_tensor(spec[2])

    def pe_of(spec):
        return (lambda r, m: (r + spec[1]) % m) if isinstance(spec, tuple) else spec

    def stack(got):
        if not got:
            return None
        return torch.cat([g.reshape(-1).float() for g in got])[None]

    epochs = 0
    for name, case in shmem_cases(n).items():
        heap = DeviceHeap(comm, heap_bytes=case[0])
        syms, outs = run_shmem_case(
            heap, case, value, pe_of, lambda op: getattr(zmpi, op), stack,
            lambda: torch.zeros((n, 1)))
        for j, sym in enumerate(syms):
            out[f"heap/{name}/read{j}"] = heap.read(sym)
        for j, o in enumerate(outs):
            out[f"heap/{name}/out{j}"] = o.numpy()
        epochs += len(case[2])
        heap.finalize()
    out["epochs_counted"] = np.array(spc.read("pgas_device_epochs") - before - epochs)


def topo_cases(n: int) -> dict:
    """Neighbor-collective and shift cases at comm size ``n`` (4 or 8):
    name -> (topology, operation, per-rank input).  Topologies:
    ("cart", dims, periods), ("graph", index, edges), ("dist", edges), or
    ("split_cart", colors, dims, periods) on ``comm.split(colors)``.
    Operations: "allgather", "alltoall", ("shift", dim, disp)."""
    rng = np.random.default_rng(400 + n)
    ring_index, ring_edges = [], []
    for r in range(n):
        ring_edges += [(r - 1) % n, (r + 1) % n]
        ring_index.append(len(ring_edges))
    rand_edges = sorted({(int(a), int(b)) for a, b in rng.integers(0, n, (2 * n, 2))
                         if a != b})
    deg = lambda edges: max([sum(1 for a, _ in edges if a == r) for r in range(n)] + [1])  # noqa: E731
    col = np.arange(n, dtype=np.float32).reshape(n, 1)

    def blocks(k):
        return (np.arange(n)[:, None, None] * 10 + np.arange(k)[None, :, None]
                ).astype(np.float32)

    half = (n // 2, 2)
    return {
        "cart_ring_allgather": (("cart", (n,), (True,)), "allgather", col),
        "cart_nonperiodic_allgather": (("cart", (n,), (False,)), "allgather", col + 1),
        "cart_2d_alltoall": (("cart", half, (True, True)), "alltoall", blocks(4)),
        "cart_2d_mixed_allgather": (("cart", half, (True, False)), "allgather", col),
        "graph_star_allgather": (("dist", [(r, 0) for r in range(1, n)]), "allgather", col),
        "graph_ring_alltoall": (("graph", ring_index, ring_edges), "alltoall", blocks(2)),
        "dist_random_alltoall": (("dist", rand_edges), "alltoall", blocks(deg(rand_edges))),
        "dist_random_allgather": (("dist", rand_edges), "allgather", col),
        "size2_duplicate_alltoall": (("split_cart", [r // 2 for r in range(n)], (2,), (True,)),
                                     "alltoall", blocks(2)),
        "shift_periodic": (("cart", (n,), (True,)), ("shift", 0, 1), col),
        "shift_nonperiodic": (("cart", (n,), (False,)), ("shift", 0, 1), col + 1),
        "shift_2d_dim1": (("cart", half, (False, True)), ("shift", 1, 1), col),
        "shift_2d_back2": (("cart", half, (True, False)), ("shift", 0, -2), col),
    }


def build_topology(topo_mod, comm, spec):
    """One ``topo_cases`` topology over ``comm`` with either package's
    ``topo`` module; returns (topology, the communicator it is over)."""
    kind = spec[0]
    if kind == "cart":
        return topo_mod.CartTopology(comm, spec[1], periods=spec[2]), comm
    if kind == "graph":
        return topo_mod.GraphTopology(comm, spec[1], spec[2]), comm
    if kind == "dist":
        return topo_mod.DistGraphTopology.from_edges(comm, spec[1]), comm
    sub = comm.split(spec[1])
    return topo_mod.CartTopology(sub, spec[2], periods=spec[3]), sub


def _topo(comm, rank, world, out):
    from zhpe_ompi_tpu_torch import topo

    for name, (spec, op, x) in topo_cases(world).items():
        t, c = build_topology(topo, comm, spec)
        xs = torch.from_numpy(x[rank])
        if op == "allgather":
            res = topo.neighbor_allgather(t, xs)
        elif op == "alltoall":
            res = topo.neighbor_alltoall(t, xs)
        else:
            res = t.shift_exchange(xs, op[1], op[2])
        out[name] = res.numpy()
    if world == 8:
        cart = topo.CartTopology(comm, (4, 2), periods=(True, False))
        rows, rtopo = cart.sub([True, False])
        out["sub_partition"] = np.array([g.ranks for g in rows.partition])
        out["sub_topo"] = np.array([rows.size, rows.rank, *rtopo.dims, *rtopo.periods])
        out["sub_shift"] = rtopo.shift_exchange(torch.tensor([float(rank)]), 0, 1).numpy()


MESH_DIMS = {4: {"dp": 2, "tp": 2}, 8: {"dp": 2, "tp": 2, "sp": 2}}
SURVIVOR_CASES = {4: [("dp", [1]), ("tp", [0])],
                  8: [("dp", [0]), ("tp", [1]), ("sp", [0])]}


def run_tcp_threads(n: int, fn, kwargs_by_rank=None, kinds=None,
                    timeout: float = 60.0, rank_timeout: float = 20.0, **common):
    """``fn(proc)`` on an n-rank ``TcpProc`` universe whose ranks are
    threads of this process, over a loopback coordinator that rank 0
    binds on port 0.  ``kinds[r]`` is rank r's TcpProc class (default:
    the port's), ``common`` and ``kwargs_by_rank[r]`` its constructor
    arguments (``sm``, ``sm_boot_id``, ...).  Every proc is closed by its
    thread; the first rank's error is raised; returns the results by
    rank."""
    import threading

    if kinds is None:
        from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

        kinds = [TcpProc] * n
    ready = threading.Event()
    addr = [None]
    results, excs = [None] * n, [None] * n

    def main(r):
        kw = dict(common, timeout=rank_timeout)
        kw.update((kwargs_by_rank or {}).get(r, {}))
        try:
            if r == 0:
                proc = kinds[0](0, n, coordinator=("127.0.0.1", 0),
                                on_coordinator_bound=lambda a: (
                                    addr.__setitem__(0, a), ready.set()), **kw)
            else:
                if not ready.wait(rank_timeout):
                    raise RuntimeError("no coordinator address")
                proc = kinds[r](r, n, coordinator=addr[0], **kw)
            try:
                results[r] = fn(proc)
            finally:
                proc.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[r] = e
            ready.set()

    threads = [threading.Thread(target=main, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise RuntimeError("a TcpProc rank hung")
    for e in excs:
        if e is not None:
            raise e
    return results


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
    if mode == "runtime":
        # the runtime joins from torchrun's environment contract itself
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        out = {}
        _runtime(rank, world, out)
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
        return 0
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
        elif mode == "spmd":
            _spmd(comm, rank, world, out)
        elif mode == "coll":
            _coll(comm, rank, world, out)
        elif mode == "ring":
            _ring(comm, rank, world, out)
        elif mode == "sp_train":
            _sp_train(rank, world, out, workdir)
        elif mode == "split":
            _split(rank, world, out)
        elif mode == "mesh":
            _mesh(rank, world, out)
        elif mode == "optax":
            _optax(rank, world, out, workdir)
        elif mode == "moe_pipe":
            _moe_pipe(comm, rank, world, out, workdir)
        elif mode == "osc_shmem":
            _osc_shmem(comm, rank, world, out)
        elif mode == "topo":
            _topo(comm, rank, world, out)
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
