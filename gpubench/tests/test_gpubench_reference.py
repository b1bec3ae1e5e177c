"""The reference against the port's CPU path at a tiny width: the same
loss and gradients in float32, and one Adam step the same as the port's
``make_train_step_optax`` in float32."""

import pytest
import torch

from gpubench import cells, inputs
from gpubench.reference import common
from gpubench.reference import gpt as reference

MODEL = {"vocab": 96, "d_model": 32, "n_heads": 2, "d_ff": 64, "n_layers": 2,
         "ce_chunk": 32, "dtype": "float32", "seq": 16, "remat": False}


def _port_cfg(**kw):
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    return tfm.Config(**dict(MODEL, dtype=torch.float32, **kw))


def _leaves(seed):
    return inputs.Leaves(cells.load_code("arch", "gpt"), MODEL, seed, "cpu")


def _batch(seed):
    return inputs.make_batches({"seq": 16, "batch": 3, "pool": 1}, 96, seed)[0]


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
@pytest.mark.parametrize("kernels", [False, True])
def test_loss_and_gradients_match_the_port_in_f32(seed, kernels):
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    tokens, targets = _batch(seed)
    leaves = _leaves(seed)
    p = {n: t.requires_grad_(True) for n, t in leaves.all().items()}
    loss = reference.loss_backward(p, tokens, targets, MODEL, common.Precision("f32"))
    q = {n: t.requires_grad_(True) for n, t in leaves.all().items()}
    cfg = _port_cfg(flash=kernels, fused_ln=kernels)
    port_loss = tfm.loss_fn(q, tokens, targets, cfg)
    port_loss.backward()
    assert loss == pytest.approx(float(port_loss.detach()), rel=1e-6)
    for n in leaves.names:
        torch.testing.assert_close(p[n].grad, q[n].grad, rtol=1e-4, atol=1e-6)


def test_adam_steps_match_the_port_in_f32():
    from zhpe_ompi_tpu_torch.comm.communicator import Communicator
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod
    from zhpe_ompi_tpu_torch.runtime import init as rt

    seed = 5
    batches = inputs.make_batches({"seq": 16, "batch": 3, "pool": 3}, 96, seed)
    leaves = _leaves(seed)
    ref = reference.readings(MODEL, leaves, batches, 3)
    rt.init(device="cpu")
    try:
        mesh = mesh_mod.make_mesh({"dp": 1, "tp": 1})
        comms = [Communicator(mesh.get_group(a), name=f"t_{a}") for a in ("dp", "tp")]
        init, step, _ = tfm.make_train_step_optax(_port_cfg(), *comms)
        params = leaves.all()
        opt = init(params)
        losses = []
        for tokens, targets in batches:
            params, opt, loss = step(params, opt, tokens, targets)
            losses.append(float(loss))
    finally:
        rt.finalize()
    assert losses == pytest.approx(ref["losses"], rel=1e-6)
    for n in leaves.names:
        w0 = leaves.draw(n)
        assert float((params[n] - w0).norm()) == pytest.approx(
            ref["change_norms"][n], rel=1e-3)


def test_blocked_attention_matches_one_block():
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 8, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    prec = common.Precision("f32")
    outs = []
    for block in (40, 7):
        o = common.Attention.apply(q, k, v, prec, block)
        g = torch.autograd.grad(o.square().sum(), (q, k, v))
        outs.append((o.detach(), *g))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b)
    s = (q @ k.transpose(-1, -2)) * 8 ** -0.5
    s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(outs[0][0], torch.softmax(s, -1) @ v)


def test_float8_control_is_farther_than_bf16():
    """The control's products lie farther from float32 than bfloat16's."""
    torch.manual_seed(1)
    a, b = torch.randn(64, 256), torch.randn(256, 64)
    exact = a @ b
    bf16 = (a.bfloat16() @ b.bfloat16()).float()
    fp8 = common.Precision("fp8").mm(a, b)
    assert (fp8 - exact).norm() > 5 * (bf16 - exact).norm()
