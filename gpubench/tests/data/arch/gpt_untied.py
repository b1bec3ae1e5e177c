"""A toy architecture for the harness's tests: the GPT block of
``arch/gpt.py`` with a head of its own, untied from the embedding.  Its
step is the port's ``forward_hidden`` and ``fused_ce.token_ce`` against
the head, autograd, the gradients and the loss averaged over ``dp_comm``,
and Adam; its reference is ``reference/gpt_untied.py``."""

from __future__ import annotations

import torch

from gpubench import cells

_GPT = cells.load_code("arch", "gpt")
LEAVES = _GPT.LEAVES + ("head",)
attention_shape = _GPT.attention_shape
norm_shape = _GPT.norm_shape
model_flops_per_step = _GPT.model_flops_per_step


def leaf_shape_scale(name: str, model: dict):
    if name == "head":
        return (model["vocab"], model["d_model"]), 0.02
    return _GPT.leaf_shape_scale(name, model)


def build(model: dict, dp_comm, tp_comm, timings):
    from zhpe_ompi_tpu_torch import ops as zops
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.ops import fused_ce

    cfg = tfm.Config(**dict(model, dtype=getattr(torch, model["dtype"])))

    def init_opt_state(params):
        return torch.optim.Adam(list(params.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)

    def mean(t):
        return dp_comm.allreduce(t, zops.SUM) / dp_comm.size

    def step(params, opt_state, tokens, targets):
        names = list(params)
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        with torch.enable_grad():
            x = tfm.forward_hidden(leaves, tokens, cfg, tp_comm)
            targets = torch.as_tensor(targets, device=x.device).long()
            loss = fused_ce.token_ce(x, leaves["head"].to(cfg.dtype), targets, cfg.ce_chunk)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        for n, g in zip(names, grads):
            params[n].grad = mean(g)
        with torch.no_grad():
            opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, mean(loss.detach())

    return init_opt_state, step
