"""The port's sharded-array files and async checkpointer against the JAX
package's.

- ``io/sharded``: the port's leaf files are byte-identical to the JAX
  package's ``save_sharded`` for float32, int32 and bfloat16 (and a
  scalar), each package loads the other's files, and a ``Placement``
  reads only its extent onto its device.
- ``runtime/checkpoint.Checkpointer``: save and restore round trips
  (blocking, and async with ``wait``), the snapshot taken at ``save`` (a
  write to the tensors right after it does not reach the files), the
  newest and a given step, retention, ``.tmp`` partials ignored, the
  ``.old`` republish healed both ways, a failed async write reported by
  ``wait`` without poisoning ``restore``, the flight recorder's
  CKPT_BEGIN/COMMIT records, placements (one for all, or a prefix tree),
  and the leaf files and ``meta.json`` beside the JAX package's
  ``Checkpointer`` (called with ``check_quiescent=False``, as
  ``tests/test_checkpoint.py`` calls it) for the same state.
- Resume: two ``make_train_step_optax`` Adam steps, a checkpoint of the
  parameters and ``optimizer.state_dict()``, a restore into fresh tensors
  and a fresh optimizer, and a third step equal in its bits to the third
  step of the uninterrupted run, on the CPU.
"""

import json
import os
import shutil
import tempfile

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.distributed as dist

from zhpe_ompi_tpu.io import sharded as jsharded
from zhpe_ompi_tpu.runtime.checkpoint import Checkpointer as JCheckpointer
from zhpe_ompi_tpu_torch.core import errors
from zhpe_ompi_tpu_torch.io import sharded
from zhpe_ompi_tpu_torch.runtime import checkpoint as ckpt
from zhpe_ompi_tpu_torch.runtime import flightrec


def _arrays():
    r = np.random.default_rng(11)
    return {
        "f32": r.standard_normal((8, 4)).astype(np.float32),
        "i32": r.integers(-1000, 1000, (3, 5)).astype(np.int32),
        "bf16": r.standard_normal((6, 2)).astype(np.float32),
        "scalar": np.asarray(7, np.int32),
    }


def _jax_and_port(name, a):
    if name == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("name", list(_arrays()))
def test_leaf_files_byte_identical_and_cross_loadable(tmp_path, name):
    jx, tx = _jax_and_port(name, _arrays()[name])
    jsharded.save_sharded(str(tmp_path / "j.zmpi"), jx)
    sharded.save_sharded(str(tmp_path / "t.zmpi"), tx)
    assert (tmp_path / "j.zmpi").read_bytes() == (tmp_path / "t.zmpi").read_bytes()
    # the port reads the JAX package's file, and the JAX package the port's
    got = sharded.load_sharded(str(tmp_path / "j.zmpi"), "cpu")
    assert got.dtype == tx.dtype and torch.equal(got, tx)
    back = jsharded.load_sharded(str(tmp_path / "t.zmpi"))
    np.testing.assert_array_equal(np.asarray(back, np.float32),
                                  np.asarray(jx, np.float32))
    assert back.dtype == np.asarray(jx).dtype


def test_load_without_placement_is_numpy_or_a_bf16_tensor(tmp_path):
    a = _arrays()
    sharded.save_sharded(str(tmp_path / "f.zmpi"), torch.from_numpy(a["f32"]))
    got = sharded.load_sharded(str(tmp_path / "f.zmpi"))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, a["f32"])
    sharded.save_sharded(str(tmp_path / "b.zmpi"), torch.from_numpy(a["bf16"]).bfloat16())
    got = sharded.load_sharded(str(tmp_path / "b.zmpi"))
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"


def test_placement_reads_only_its_extent(tmp_path):
    a = _arrays()["f32"]
    path = str(tmp_path / "f.zmpi")
    sharded.save_sharded(path, a)  # a numpy array is accepted too
    for rank in range(4):
        block = (slice(2 * rank, 2 * rank + 2),)
        got = sharded.load_sharded(path, sharded.Placement("cpu", block))
        np.testing.assert_array_equal(got.numpy(), a[block])


def test_not_a_zmpi_file(tmp_path):
    (tmp_path / "x").write_bytes(b"\0" * 600)
    with pytest.raises(errors.ArgError):
        sharded.load_sharded(str(tmp_path / "x"))


def _state(seed=0):
    r = np.random.default_rng(seed)
    return {
        "b": torch.from_numpy(r.standard_normal(4).astype(np.float32)),
        "step_count": torch.tensor(7, dtype=torch.int32),
        "w": torch.from_numpy(r.standard_normal((8, 4)).astype(np.float32)),
    }


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_roundtrip_blocking_and_async(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path))
    ck.save(3, _state(), blocking=True)
    got, step = ck.restore()
    assert step == 3
    _equal(got, _state())
    assert all(isinstance(v, np.ndarray) for v in got.values())
    ck.save(4, _state(4))
    ck.wait()
    got, step = ck.restore()
    assert step == 4
    _equal(got, _state(4))


def test_snapshot_is_taken_at_save(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path))
    state = _state()
    want = {k: v.clone() for k, v in state.items()}
    ck.save(1, state)
    with torch.no_grad():
        for v in state.values():
            v.add_(100)  # an in-place optimizer step right after save
    ck.wait()
    _equal(ck.restore()[0], want)


def test_restore_specific_latest_retention_and_tmp(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path), keep=10)
    for s in (2, 5, 9):
        ck.save(s, _state(s), blocking=True)
    assert ck.all_steps() == [2, 5, 9] and ck.latest_step() == 9
    _equal(ck.restore(5)[0], _state(5))
    with pytest.raises(errors.ArgError):
        ck.restore(4)
    os.makedirs(tmp_path / "step_11.tmp")
    assert ck.all_steps() == [2, 5, 9] and ck.restore()[1] == 9
    keep2 = ckpt.Checkpointer(str(tmp_path / "k"), keep=2)
    for s in range(5):
        keep2.save(s, _state(s), blocking=True)
    assert keep2.all_steps() == [3, 4]
    with pytest.raises(errors.ArgError):
        ckpt.Checkpointer(str(tmp_path / "empty")).restore()


def test_old_republish_is_healed(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path))
    ck.save(5, _state(5), blocking=True)
    # a writer killed between retiring step_5 and publishing its new copy
    os.replace(tmp_path / "step_5", tmp_path / "step_5.old")
    assert ckpt.Checkpointer(str(tmp_path)).restore()[1] == 5
    assert not (tmp_path / "step_5.old").exists()
    # the publish landed and only the cleanup was lost: drop the stale copy
    shutil.copytree(tmp_path / "step_5", tmp_path / "step_5.old")
    _equal(ck.restore()[0], _state(5))
    assert not (tmp_path / "step_5.old").exists()
    # a republish of the same step replaces it
    ck.save(5, _state(6), blocking=True)
    _equal(ck.restore(5)[0], _state(6))


def test_failed_async_write_is_reported_and_does_not_poison_restore(tmp_path, monkeypatch):
    ck = ckpt.Checkpointer(str(tmp_path))
    ck.save(1, _state(1), blocking=True)

    def broken(path, arr):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.sharded, "save_sharded", broken)
    ck.save(2, _state(2))
    got, step = ck.restore()  # joins the writer, leaves its error pending
    assert step == 1
    _equal(got, _state(1))
    with pytest.raises(errors.InternalError, match="disk full"):
        ck.wait()
    ck.wait()  # reported once


def test_unsupported_leaf_is_refused(tmp_path):
    with pytest.raises(errors.ArgError, match="object"):
        ckpt.Checkpointer(str(tmp_path)).save(1, {"x": object()})


def test_flight_recorder_records_begin_and_commit(tmp_path):
    flightrec.arm()
    try:
        flightrec.clear()
        ckpt.Checkpointer(str(tmp_path)).save(8, _state(), blocking=True)
        kinds = [(e["type"], e["step"]) for e in flightrec.window()
                 if e["type"] in (flightrec.CKPT_BEGIN, flightrec.CKPT_COMMIT)]
    finally:
        flightrec.disarm()
    assert kinds == [(flightrec.CKPT_BEGIN, 8), (flightrec.CKPT_COMMIT, 8)]


def _quiesce_trace(uni_mod, quiesce, errs):
    """quiesce_check on an idle universe, with one posted receive, with one
    unexpected message, and after both drain (one package's side)."""
    uni = uni_mod.LocalUniverse(2)
    try:
        out = [quiesce()]
        req = uni.contexts[1].irecv(source=0, tag=3)
        with pytest.raises(errs.InternalError) as posted:
            quiesce()
        uni.contexts[0].send(np.arange(2.0), dest=1, tag=3)
        out.append(list(np.asarray(req.wait(5.0))))
        uni.contexts[0].send(np.zeros(2), dest=1, tag=4)
        uni.contexts[1].progress()  # parks on the unexpected queue
        with pytest.raises(errs.InternalError) as unexpected:
            quiesce()
        uni.contexts[1].recv(source=0, tag=4, timeout=5.0)
        out.append(quiesce())
    finally:
        if hasattr(uni, "close"):
            uni.close()
    return out, str(posted.value), str(unexpected.value)


def test_quiesce_check_has_no_queues_to_read():
    """Since the host plane is ported, ``quiesce_check`` reads the live port
    universes' queues: one posted receive, then one unexpected message,
    raise the namesake's ``InternalError`` with its message; drained, it
    passes (the namesake, on its own universe, in step)."""
    from zhpe_ompi_tpu.core import errors as jerrors
    from zhpe_ompi_tpu.pt2pt import universe as juni
    from zhpe_ompi_tpu.runtime.checkpoint import quiesce_check as jquiesce
    from zhpe_ompi_tpu_torch.pt2pt import universe as tuni

    assert ckpt.quiesce_check() is None
    port = _quiesce_trace(tuni, ckpt.quiesce_check, errors)
    ref = _quiesce_trace(juni, jquiesce, jerrors)
    assert port == ref
    assert port[1] == ("checkpoint at non-quiescent point: 1 posted recvs, "
                       "0 unexpected messages in flight")
    assert ckpt.quiesce_check() is None


def test_checkpointer_save_waits_for_quiescence(tmp_path):
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse

    uni = LocalUniverse(2)
    try:
        uni.contexts[0].send(torch.zeros(2), dest=1, tag=2)
        uni.contexts[1].progress()
        ck = ckpt.Checkpointer(str(tmp_path))
        with pytest.raises(errors.InternalError, match="1 unexpected"):
            ck.save(0, {"x": torch.zeros(2)}, blocking=True)
        uni.contexts[1].recv(source=0, tag=2, timeout=5.0)
        ck.save(0, {"x": torch.zeros(2)}, blocking=True)
        assert ck.restore()[1] == 0
    finally:
        uni.close()


def test_placements_and_plain_leaves(tmp_path):
    opt_like = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": torch.ones(2)}},
                "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8,
                                  "amsgrad": False, "foreach": None, "params": [0]}]}
    state = {"params": _state(), "opt": opt_like}
    ck = ckpt.Checkpointer(str(tmp_path))
    ck.save(1, state, blocking=True)
    got, _ = ck.restore(placements="cpu")
    assert all(isinstance(v, torch.Tensor) for v in got["params"].values())
    assert got["opt"]["param_groups"] == opt_like["param_groups"]
    assert torch.equal(got["opt"]["state"][0]["exp_avg"], torch.ones(2))
    got, _ = ck.restore(placements={"params": "cpu", "opt": None})
    assert isinstance(got["params"]["w"], torch.Tensor)
    assert isinstance(got["opt"]["state"][0]["exp_avg"], np.ndarray)
    with pytest.raises(errors.ArgError, match="structure"):
        ck.restore(placements={"only": "cpu"})
    meta = json.loads((tmp_path / "step_1" / "meta.json").read_text())
    assert meta["step"] == 1 and meta["n_leaves"] == 5


def test_files_beside_the_jax_checkpointer(tmp_path):
    """The same state through both checkpointers: the same leaf files, byte
    for byte, and the same meta.json step and n_leaves (keys inserted in
    sorted order, the order jax.tree flattens a dict in)."""
    state = _state(2)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    JCheckpointer(str(tmp_path / "j"), check_quiescent=False).save(4, jstate, blocking=True)
    ckpt.Checkpointer(str(tmp_path / "t")).save(4, state, blocking=True)
    jdir, tdir = tmp_path / "j" / "step_4", tmp_path / "t" / "step_4"
    jmeta = json.loads((jdir / "meta.json").read_text())
    tmeta = json.loads((tdir / "meta.json").read_text())
    assert (jmeta["step"], jmeta["n_leaves"]) == (tmeta["step"], tmeta["n_leaves"]) == (4, 3)
    for i in range(3):
        assert (jdir / f"leaf_{i}.zmpi").read_bytes() == (tdir / f"leaf_{i}.zmpi").read_bytes()


SMALL = dict(vocab=64, d_model=16, n_heads=2, d_ff=32, n_layers=2, seq=8)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.models import transformer as tt

    rng = np.random.default_rng(5)
    np_params = {
        "embed": rng.standard_normal((64, 16)) * 0.02, "wqkv": rng.standard_normal((2, 16, 3, 16)) * 0.2,
        "wo": rng.standard_normal((2, 16, 16)) * 0.2, "w1": rng.standard_normal((2, 16, 32)) * 0.2,
        "w2": rng.standard_normal((2, 32, 16)) * 0.2, "ln1": np.ones((2, 16)),
        "ln2": np.ones((2, 16)), "lnf": np.ones(16)}
    tokens = rng.integers(0, 64, (4, 8))
    targets = rng.integers(0, 64, (4, 8))
    cfg = tt.Config(**SMALL, dtype=torch.float32, flash=False, fused_ln=False)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "s"), 1),
                                rank=0, world_size=1)
        try:
            comm = zmpi.Communicator(name="dp")
            init, step, _ = tt.make_train_step_optax(cfg, comm)
            params = tt.params_from_numpy(np_params, cfg, device="cpu")
            opt = init(params)
            for _ in range(2):
                params, opt, _ = step(params, opt, tokens, targets)
            ck = ckpt.Checkpointer(str(tmp_path))
            ck.save(2, {"params": params, "opt": opt.state_dict()})
            ck.wait()
            params, opt, loss3 = step(params, opt, tokens, targets)
            got, s = ck.restore(placements="cpu")
            fresh = {k: v.clone() for k, v in got["params"].items()}
            opt2 = init(fresh)
            opt2.load_state_dict(got["opt"])
            fresh, opt2, loss3b = step(fresh, opt2, tokens, targets)
        finally:
            dist.destroy_process_group()
    assert s == 2
    assert torch.equal(loss3, loss3b)
    for k in params:
        assert torch.equal(params[k], fresh[k]), k
