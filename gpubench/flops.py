"""Work counts: the operations and bytes that a training step, and each
kernel call in it, needs, computed from shapes alone.

Each kernel is counted by the work its call has to do, whatever implements
it: the causal half of attention (the S(S+1)/2 pairs of a row block, not
S^2), every input byte read once and every output byte written once,
nothing for what a kernel reads again or keeps between its own launches.
Model FLOPs for utilisation count 6 per parameter of every matrix product
per token (forward 2, backward 4) plus causal attention, and nothing that
recomputation adds.
"""

from __future__ import annotations

from dataclasses import dataclass

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class Work:
    """Operations and bytes of one call."""

    flops: float
    bytes: float

    def least_seconds(self, peak_flops: float, peak_bytes: float) -> float:
        """The least time the card could take: the larger of the two bounds."""
        return max(self.flops / peak_flops, self.bytes / peak_bytes)


def matmul_params(vocab: int, d_model: int, d_ff: int, n_layers: int) -> int:
    """Parameters that enter a matrix product: per layer the qkv and output
    projections (4 D^2) and the two ffn products (2 D F), plus the tied
    unembedding (V D).  The embedding lookup is no product."""
    return n_layers * (4 * d_model * d_model + 2 * d_model * d_ff) + vocab * d_model


def causal_pairs(seq: int) -> int:
    """Query-key pairs of one causal row block of ``seq`` positions."""
    return seq * (seq + 1) // 2


def model_flops_per_step(vocab, d_model, d_ff, n_layers, batch, seq) -> float:
    """6 N_matmul per token, plus causal attention: QK^T and PV forward are
    2 products of 2 d_model FLOPs per pair, times 3 for forward and
    backward, over the causal pairs of every row."""
    tokens = batch * seq
    attn = 3 * 2 * 2 * d_model * causal_pairs(seq) * batch * n_layers
    return 6 * matmul_params(vocab, d_model, d_ff, n_layers) * tokens + attn


def flash_fwd(batch, seq, q_heads, kv_heads, head_dim) -> Work:
    """Causal flash forward: S = QK^T and O = PV over the causal pairs of
    every query head; reads q, k, v (bf16), writes o (bf16) and lse (f32
    per query row).  k and v have ``kv_heads`` heads."""
    rows = batch * q_heads
    flops = 2 * 2 * head_dim * causal_pairs(seq) * rows
    q_elems, kv_elems = (batch * seq * h * head_dim for h in (q_heads, kv_heads))
    return Work(flops, (2 * q_elems + 2 * kv_elems) * BF16 + rows * seq * F32)


def flash_bwd(batch, seq, q_heads, kv_heads, head_dim) -> Work:
    """Causal flash backward as one computation: the five products (S
    recomputed once, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q) over
    the causal pairs of every query head; reads q, k, v, o, dO and lse,
    writes dq, dk, dv.  A split that recomputes S twice, and delta passed
    between two kernels, earn nothing."""
    rows = batch * q_heads
    flops = 5 * 2 * head_dim * causal_pairs(seq) * rows
    q_elems, kv_elems = (batch * seq * h * head_dim for h in (q_heads, kv_heads))
    return Work(flops, (4 * q_elems + 4 * kv_elems) * BF16 + rows * seq * F32)


def ln_fwd(rows, width, itemsize=BF16) -> Work:
    """Layernorm forward without bias: reads x and the f32 gain, writes y
    and the f32 mean and rstd of each row.  About 8 FLOPs an element."""
    return Work(8 * rows * width,
                2 * rows * width * itemsize + width * F32 + 2 * rows * F32)


def ln_bwd(rows, width, itemsize=BF16) -> Work:
    """Layernorm backward: reads x, dy, the gain, mean and rstd, writes dx
    and the f32 gain gradient.  About 12 FLOPs an element."""
    return Work(12 * rows * width,
                3 * rows * width * itemsize + 2 * width * F32 + 2 * rows * F32)
