"""The GPT block as the port's ``models/transformer`` runs it: pre-layernorm
layers of causal multi-head attention (H heads of D / H) and a tanh-GELU
MLP, layernorm gains without bias, the embedding tied to the head.  Its
plain reference is ``reference/gpt.py``.

The leaves follow the JAX package's ``init_params`` layout and scales:
``embed`` (V, D) at 0.02, ``wqkv`` (L, D, 3, D) at D^-1/2, ``wo`` (L, D, D)
at D^-1/2, ``w1`` (L, D, F) at D^-1/2, ``w2`` (L, F, D) at F^-1/2, the
gains ``ln1``, ``ln2`` (L, D) and ``lnf`` (D,) at 1.
"""

from __future__ import annotations

import torch

from gpubench import flops

#: the leaves in the order they are drawn, each with its index
LEAVES = ("embed", "wqkv", "wo", "w1", "w2", "ln1", "ln2", "lnf")


def leaf_shape_scale(name: str, model: dict) -> tuple[tuple, float | None]:
    """Shape and scale of a leaf; scale None for a gain of ones."""
    V, D, F, L = model["vocab"], model["d_model"], model["d_ff"], model["n_layers"]
    return {
        "embed": ((V, D), 0.02),
        "wqkv": ((L, D, 3, D), D ** -0.5),
        "wo": ((L, D, D), D ** -0.5),
        "w1": ((L, D, F), D ** -0.5),
        "w2": ((L, F, D), F ** -0.5),
        "ln1": ((L, D), None),
        "ln2": ((L, D), None),
        "lnf": ((D,), None),
    }[name]


def build(model: dict, dp_comm, tp_comm, timings):
    """``(init_opt_state, step)`` of ``models/transformer.
    make_train_step_optax`` with its default Adam, at ``model`` (the
    port's ``transformer.Config`` fields)."""
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    cfg = tfm.Config(**dict(model, dtype=getattr(torch, model["dtype"])))
    init_opt_state, step, _ = tfm.make_train_step_optax(cfg, dp_comm, tp_comm,
                                                        timings=timings)
    return init_opt_state, step


def model_flops_per_step(model: dict, batch: int) -> float:
    return flops.model_flops_per_step(model["vocab"], model["d_model"], model["d_ff"],
                                      model["n_layers"], batch, model["seq"])


def attention_shape(model: dict, batch: int) -> dict:
    """The shape of each call of the attention kernels."""
    heads = model["n_heads"]
    return {"batch": batch, "seq": model["seq"], "q_heads": heads, "kv_heads": heads,
            "head_dim": model["d_model"] // heads}


def norm_shape(model: dict, batch: int) -> dict:
    """The shape of each call of the layernorm kernels."""
    return {"rows": batch * model["seq"], "width": model["d_model"]}
