"""The PyTorch port's ring attention against the JAX package's.

``zhpe_ompi_tpu_torch/models/ring_attention.py`` on 2 and 4 gloo ranks
(``_torch_dist_worker`` ``ring``): ``ring_attention`` causal and not, and
``ring_attention_zigzag`` (causal only), in f32 and bf16, against the JAX
functions under ``shard_map`` on a sub-mesh of the same size.  The
outputs and the q/k/v gradients of ``sum(out * cot)`` (``jax.vjp`` on the
JAX side, autograd through the port's differentiable shifts) are compared
on every rank's block.  Rank 0 of the causal contiguous ring holds fully
masked blocks at every step but its first: its outputs and gradients must
stay finite.

Tolerances: f32 rtol 1e-5, atol 1e-6 (the same f32 online-softmax
recurrence, summed in another order by torch's and XLA's einsums); bf16
atol 2e-2 (both sides round the inputs, the output and the gradients to
bf16, one ulp of values of order 1 is 2^-8, and the f32 work between them
differs in order).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
import torch

import zhpe_ompi_tpu as jz
from zhpe_ompi_tpu import compat
from zhpe_ompi_tpu.models import ring_attention as jra
from zhpe_ompi_tpu_torch.models import ring_attention as tra

from _torch_dist_worker import RING_VARIANTS, ring_inputs, run_ranks

SIZES = (2, 4)
TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "bfloat16": dict(rtol=0, atol=2e-2)}


def _tag(layout, causal, dtype):
    return f"{layout}_{'causal' if causal else 'full'}_{dtype}"


@functools.lru_cache(maxsize=None)
def _jax_results(n):
    """Per-rank blocks (n, ...) of the JAX ring's output and gradients, for
    every variant and dtype, from one jitted shard_map program."""
    inp = ring_inputs(n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    comm = jz.Communicator(mesh, "sp", name=f"port_ring{n}")
    names = ("q", "k", "v", "cot")
    contiguous = [inp[k] for k in names]
    zigzag = [np.asarray(jra.zigzag_shard(jnp.asarray(inp[k]), n)) for k in names]

    def run(ring, q, k, v, cot, dt):
        q, k, v = (t.astype(dt) for t in (q, k, v))

        def loss(q, k, v):
            return jnp.sum(ring(q, k, v).astype(jnp.float32) * cot)

        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        return [t.astype(jnp.float32) for t in (ring(q, k, v), *grads)]

    def body(contig, zz):
        res_c, res_z = {}, {}
        for layout, causal in RING_VARIANTS:
            for dtype in ("float32", "bfloat16"):
                if layout == "zigzag":
                    outs = run(lambda q, k, v: jra.ring_attention_zigzag(
                        comm, q[0], k[0], v[0])[None], *zz, jnp.dtype(dtype))
                    res = res_z
                else:
                    outs = run(lambda q, k, v, c=causal: jra.ring_attention(
                        comm, q, k, v, causal=c), *contig, jnp.dtype(dtype))
                    res = res_c
                for name, t in zip(("out", "dq", "dk", "dv"), outs):
                    res[f"{_tag(layout, causal, dtype)}_{name}"] = t
        return res_c, res_z

    specs = (P(None, "sp"), P("sp"))
    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=specs,
                                 out_specs=specs, check_vma=False))
    res_c, res_z = f(contiguous, zigzag)
    res = {k: np.stack(np.split(np.asarray(t), n, axis=1))  # per-rank blocks
           for k, t in res_c.items()}
    res.update({k: np.asarray(t) for k, t in res_z.items()})
    return res


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    out = {}
    for n in SIZES:
        d = tmp_path_factory.mktemp(f"ring{n}")
        results, outs = run_ranks("ring", n, d)
        for rc, log in results:
            assert rc == 0, log
        out[n] = outs
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,causal", RING_VARIANTS,
                         ids=[_tag(lay, c, "")[:-1] for lay, c in RING_VARIANTS])
def test_outputs_and_grads_match_jax(port_results, n, dtype, layout, causal):
    want = _jax_results(n)
    tag = _tag(layout, causal, dtype)
    for name in ("out", "dq", "dk", "dv"):
        for rank, out in enumerate(port_results[n]):
            got = out[f"{tag}_{name}"]
            assert np.isfinite(got).all(), (tag, name, rank)
            np.testing.assert_allclose(got, want[f"{tag}_{name}"][rank],
                                       err_msg=f"{tag} {name} rank {rank}",
                                       **TOL[dtype])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zigzag_shard_roundtrip_matches_namesake(n):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8 * n, 3)).astype(np.float32)
    got = tra.zigzag_shard(torch.from_numpy(x), n)
    want = np.asarray(jra.zigzag_shard(jnp.asarray(x), n))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tra.zigzag_unshard(got, n).numpy(), x)


def test_single_rank_is_block_attention_single():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
               for _ in range(3))
    for causal in (True, False):
        got = tra._block_attention_single(*map(torch.from_numpy, (q, k, v)),
                                          causal)
        want = jra._block_attention_single(*map(jnp.asarray, (q, k, v)), causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
