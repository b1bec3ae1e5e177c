"""The plain reference of the toy architecture ``gpt_untied``: the GPT
reference's layers, with the logits taken against the leaf ``head``."""

from __future__ import annotations

from gpubench.reference import common, gpt


def loss_backward(p, tokens, targets, model, prec) -> float:
    B, S = tokens.shape
    rows = max(1, common.ROW_TOKENS // S)
    device = p["embed"].device
    total = 0.0
    for r0 in range(0, B, rows):
        tok = tokens[r0:r0 + rows].to(device)
        tgt = targets[r0:r0 + rows].to(device).reshape(-1)
        loss = gpt.ce_sum(gpt.hidden(p, tok, model, prec), p["head"], tgt, model, prec) / (B * S)
        loss.backward()
        total += float(loss.detach())
    return total


def readings(model: dict, leaves, batches, steps: int, precision: str = "f32") -> dict:
    return common.readings(loss_backward, model, leaves, batches, steps, precision)
