"""LFM2-MoE as the port's ``models/lfm2_moe`` runs it: gated short-conv
and grouped-query attention layers with RMSNorm, the first ``n_dense``
layers with a dense SwiGLU FFN and the rest with a sigmoid top-k router
over ``n_experts`` and SwiGLU experts, of which this card holds
``n_experts / ep_size`` (expert parallelism's share); the embedding tied
to the head.  Its plain reference is ``reference/lfm2_moe.py``.

The leaves are ``lfm2_moe``'s, stacked per layer kind: projections,
router and experts at fan-in^-1/2, the conv taps at K^-1/2, the embedding
at 0.02, the gains (``op_norm``, ``ffn_norm``, ``final_norm``, ``q_norm``,
``k_norm``) at 1.
"""

from __future__ import annotations

import torch

from gpubench import flops

#: the leaves in the order they are drawn, each with its index
LEAVES = ("embed", "op_norm", "ffn_norm", "final_norm", "conv_in", "conv_w", "conv_out",
          "wq", "wk", "wv", "wo", "q_norm", "k_norm", "dense_w13", "dense_w2",
          "router", "moe_w13", "moe_w2")


def layer_counts(model: dict) -> dict:
    """Layers of each kind: conv, attention, dense FFN, MoE FFN."""
    types = model["layer_types"]
    conv = sum(t == "conv" for t in types)
    return {"conv": conv, "attn": len(types) - conv, "dense": model["n_dense"],
            "moe": len(types) - model["n_dense"]}


def held(model: dict) -> int:
    return model["n_experts"] // model["ep_size"]


def leaf_shape_scale(name: str, model: dict) -> tuple[tuple, float | None]:
    """Shape and scale of a leaf; scale None for a gain of ones."""
    V, D = model["vocab"], model["d_model"]
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    F, Fe, E, K = model["d_ff"], model["d_expert"], model["n_experts"], model["conv_kernel"]
    L = len(model["layer_types"])
    c, e = layer_counts(model), held(model)
    return {
        "embed": ((V, D), 0.02),
        "op_norm": ((L, D), None),
        "ffn_norm": ((L, D), None),
        "final_norm": ((D,), None),
        "conv_in": ((c["conv"], D, 3 * D), D ** -0.5),
        "conv_w": ((c["conv"], D, K), K ** -0.5),
        "conv_out": ((c["conv"], D, D), D ** -0.5),
        "wq": ((c["attn"], D, H * hd), D ** -0.5),
        "wk": ((c["attn"], D, Hkv * hd), D ** -0.5),
        "wv": ((c["attn"], D, Hkv * hd), D ** -0.5),
        "wo": ((c["attn"], H * hd, D), (H * hd) ** -0.5),
        "q_norm": ((c["attn"], hd), None),
        "k_norm": ((c["attn"], hd), None),
        "dense_w13": ((c["dense"], D, 2 * F), D ** -0.5),
        "dense_w2": ((c["dense"], F, D), F ** -0.5),
        "router": ((c["moe"], D, E), D ** -0.5),
        "moe_w13": ((c["moe"], e, D, 2 * Fe), D ** -0.5),
        "moe_w2": ((c["moe"], e, Fe, D), Fe ** -0.5),
    }[name]


#: Adam as the reference writes it out (``reference/common.ADAM``)
ADAM = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def warmup_lr(step: int, model: dict) -> float:
    """The learning rate of step ``step`` (from 1): Adam's 1e-3 times
    ``min(1, step / warmup_steps)``, a linear warmup from 0."""
    return ADAM["lr"] * min(1.0, step / model["warmup_steps"])


def warmup_adam(model: dict):
    """The optimizer factory of the step: ``torch.optim.Adam`` whose
    learning rate follows :func:`warmup_lr`, set before each step."""

    class WarmupAdam(torch.optim.Adam):
        def __init__(self, params):
            super().__init__(params, **ADAM)
            self.steps_taken = 0

        def step(self, closure=None):
            self.steps_taken += 1
            for group in self.param_groups:
                group["lr"] = warmup_lr(self.steps_taken, model)
            return super().step(closure)

    return WarmupAdam


def build(model: dict, dp_comm, tp_comm, timings):
    """``(init_opt_state, step)`` of ``models/lfm2_moe.
    make_train_step_optax`` with Adam under :func:`warmup_lr`, at ``model``
    (the port's ``lfm2_moe.Config`` fields, and ``warmup_steps``; the model
    has no remat)."""
    from zhpe_ompi_tpu_torch.models import lfm2_moe

    if model["remat"]:
        raise ValueError("lfm2_moe has no remat")
    fields = {k: v for k, v in model.items() if k not in ("remat", "warmup_steps")}
    cfg = lfm2_moe.Config(**dict(fields, layer_types=tuple(model["layer_types"]),
                                 dtype=getattr(torch, model["dtype"])))
    init_opt_state, step, _ = lfm2_moe.make_train_step_optax(
        cfg, dp_comm, tp_comm, optimizer=warmup_adam(model), timings=timings)
    return init_opt_state, step


def product_params_per_token(model: dict) -> float:
    """Parameters of the matrix products one token goes through: the
    projections of every conv and attention layer, the dense FFNs, each
    MoE layer's router and its expected share of held experts (top_k x
    held / n_experts experts of 3 D Fe), and the tied head; nothing for
    the conv taps or the embedding lookup."""
    D, V = model["d_model"], model["vocab"]
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    c = layer_counts(model)
    conv = 3 * D * D + D * D
    attn = D * (H + 2 * Hkv) * hd + H * hd * D
    dense = 3 * D * model["d_ff"]
    share = model["top_k"] * held(model) / model["n_experts"]
    moe = D * model["n_experts"] + share * 3 * D * model["d_expert"]
    return c["conv"] * conv + c["attn"] * attn + c["dense"] * dense + c["moe"] * moe + V * D


def model_flops_per_step(model: dict, batch: int) -> float:
    """6 per product parameter per token, plus causal attention: QK^T and
    PV forward, 2 products of 2 H hd FLOPs per causal pair, times 3 for
    forward and backward, in every attention layer."""
    seq = model["seq"]
    attn = (3 * 2 * 2 * model["n_heads"] * model["head_dim"] * flops.causal_pairs(seq)
            * batch * layer_counts(model)["attn"])
    return 6 * product_params_per_token(model) * batch * seq + attn


def attention_shape(model: dict, batch: int) -> dict:
    """The shape of each call of the attention kernels."""
    return {"batch": batch, "seq": model["seq"], "q_heads": model["n_heads"],
            "kv_heads": model["n_kv_heads"], "head_dim": model["head_dim"]}


def norm_shape(model: dict, batch: int) -> dict:
    """The shape of each call of the norm kernels (the width-D RMSNorms)."""
    return {"rows": batch * model["seq"], "width": model["d_model"]}


def moe_gemm_work(model: dict, rows: float) -> flops.Work:
    """The grouped expert products of one step, over ``rows`` pairs a step
    summed over the MoE layers: forward, input gradient and weight
    gradient of W1 and W3 (side by side, 2 Fe wide) and of W2, 18 rows D
    Fe FLOPs; bytes: each product's operands read once and its result
    written once, in bf16."""
    D, Fe, e = model["d_model"], model["d_expert"], held(model)
    L = layer_counts(model)["moe"]
    w = e * 3 * D * Fe * flops.BF16  # W1, W3 and W2 of the held experts
    act = rows * (D + 2 * Fe + Fe + D) * flops.BF16  # x, a, u, y of each pair
    # forward, dgrad and wgrad each read the weights or write their
    # gradient once and touch the activations on both sides once
    return flops.Work(18 * rows * D * Fe, 3 * (L * w + act))


def conv_work(model: dict, batch: int) -> flops.Work:
    """The depthwise causal convolutions of one step, forward and backward
    at (B S, D) in bf16 in every conv layer: the forward reads u and
    writes its output, the input gradient reads dy and writes du, the
    weight gradient reads dy and u (K taps a channel, 2 FLOPs a tap)."""
    n, D, K = batch * model["seq"], model["d_model"], model["conv_kernel"]
    L = layer_counts(model)["conv"]
    return flops.Work(L * 3 * 2 * K * n * D, L * 6 * n * D * flops.BF16)
