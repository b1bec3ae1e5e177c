"""The stacked weight leaves' gradients in the PyTorch port's transformer.

Each of ``wqkv``, ``wo``, ``w1``, ``w2``, ``ln1`` and ``ln2`` is one
float32 leaf stacked over the layers.  ``forward_hidden`` takes each apart
once with ``unbind``, so that autograd stacks the layers' slices of its
gradient once (``UnbindBackward0``).  Indexing the leaf per layer instead
(``params[name][layer]``, written below in the test and nowhere in the
package) makes ``select_backward`` fill a zero tensor the size of the
whole stack at every layer and autograd add the L of them up.

Each layer's slice of the gradient is added to zeros exactly once on that
path, so both give the same bits.  At a tiny width with three layers, with
and without remat, on the kernel path in bfloat16 (the kernels' plain
versions, the chunked loss) and on the reference path in float32:

- the gradients of ``loss_fn`` for every leaf are equal (``torch.equal``)
  to those of the per-layer-index forward;
- the autograd graph from the loss holds exactly one ``UnbindBackward0``
  over each stacked leaf and no ``SelectBackward0`` over any, where the
  per-layer-index graph holds L ``SelectBackward0`` over each.
"""

import numpy as np
import pytest

import torch
from torch.utils.checkpoint import checkpoint

from zhpe_ompi_tpu_torch.models import transformer as tt

SMALL = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=3, seq=16)
PATHS = [pytest.param(True, 32, torch.bfloat16, id="kernel-chunked-bf16"),
         pytest.param(False, None, torch.float32, id="reference-f32")]
REMAT = [pytest.param(False, id="no-remat"), pytest.param(True, id="remat")]


def _inputs(cfg):
    rng = np.random.default_rng(5)
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers

    def nrm(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"embed": nrm((V, D), 0.02), "wqkv": nrm((L, D, 3, D), D ** -0.5),
              "wo": nrm((L, D, D), D ** -0.5), "w1": nrm((L, D, F), D ** -0.5),
              "w2": nrm((L, F, D), F ** -0.5),
              "ln1": 1 + nrm((L, D), 0.1), "ln2": 1 + nrm((L, D), 0.1),
              "lnf": 1 + nrm((D,), 0.1)}
    tokens = rng.integers(0, V, (2, cfg.seq))
    targets = rng.integers(0, V, (2, cfg.seq))
    return params, tokens, targets


def _select_forward_hidden(params, tokens, cfg, tp_comm=None, sp_comm=None):
    """``forward_hidden`` indexing each stacked leaf per layer, inside the
    layer's checkpoint under remat."""

    def block_at(x, params, layer):
        w = {n: params[n][layer] for n in tt._STACKED}
        return tt._block(x, w, cfg, tp_comm, sp_comm)

    emb = params["embed"]
    x = emb.to(cfg.dtype)[torch.as_tensor(tokens).long()]
    for layer in range(params["wqkv"].shape[0]):
        if cfg.remat:
            x = checkpoint(block_at, x, params, layer, use_reentrant=False,
                           context_fn=tt._remat_contexts)
        else:
            x = block_at(x, params, layer)
    return tt._ln(x, params["lnf"], cfg.fused_ln)


def _loss_and_grads(cfg, np_params, tokens, targets):
    params = tt.params_from_numpy(np_params, cfg, device="cpu")
    names = list(params)
    leaves = [params[n].requires_grad_(True) for n in names]
    loss = tt.loss_fn(params, tokens, targets, cfg)
    graph = _nodes_over_leaves(loss, {id(p): n for n, p in params.items()})
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads)), graph


def _nodes_over_leaves(loss, leaf_names):
    """For each autograd node of the graph from ``loss`` that feeds a
    leaf's ``AccumulateGrad``: (its type's name, the leaf's name)."""
    found, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None:
                found.append((type(node).__name__, leaf_names[id(var)]))
            todo.append(nxt)
    return found


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("path,ce_chunk,dtype", PATHS)
def test_unbind_grads_equal_per_layer_select(monkeypatch, path, ce_chunk,
                                             dtype, remat):
    cfg = tt.Config(**SMALL, dtype=dtype, flash=path, fused_ln=path,
                    ce_chunk=ce_chunk, remat=remat)
    np_params, tokens, targets = _inputs(cfg)
    loss, grads, graph = _loss_and_grads(cfg, np_params, tokens, targets)
    monkeypatch.setattr(tt, "forward_hidden", _select_forward_hidden)
    ref_loss, ref_grads, ref_graph = _loss_and_grads(cfg, np_params, tokens,
                                                     targets)

    assert torch.equal(loss, ref_loss)
    for name in ref_grads:
        assert torch.equal(grads[name], ref_grads[name]), name

    L = cfg.n_layers
    for name in tt._STACKED:
        assert graph.count(("UnbindBackward0", name)) == 1, name
        assert ("SelectBackward0", name) not in graph, name
        # the walk sees the per-layer index it is to rule out
        assert ref_graph.count(("SelectBackward0", name)) == L, name
        assert ("UnbindBackward0", name) not in ref_graph, name


def test_forward_only_unchanged_without_grad():
    """Without gradients the slices are views: the forward gives the
    per-layer-index forward's bits."""
    cfg = tt.Config(**SMALL, dtype=torch.bfloat16, flash=True, fused_ln=True,
                    ce_chunk=32)
    np_params, tokens, _ = _inputs(cfg)
    params = tt.params_from_numpy(np_params, cfg, device="cpu")
    with torch.no_grad():
        got = tt.forward_hidden(params, tokens, cfg)
        want = _select_forward_hidden(params, tokens, cfg)
    assert torch.equal(got, want)
