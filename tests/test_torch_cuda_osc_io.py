"""The PyTorch port's slice-13 paths with CUDA tensors: one-sided windows
and MPI-IO files take CUDA origins (copied to the host explicitly) and
fill CUDA results (host to card).

Every test here is marked ``cuda`` and skips where there is no CUDA device.
This file imports torch and the port only, never jax, so it also runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_osc_io.py

- ``HostWindow`` (thread ranks) and ``DirectWindow`` (``TcpProc`` ranks
  in threads with sm on: the direct-map path): ``put`` and
  ``accumulate`` of CUDA float32 tensors, ``get(out=cuda_tensor)``; the
  card's values land exactly.
- ``WireFile``: ``write_all`` of CUDA float32 and bfloat16 tensors through
  rank views, ``read_all`` back equal to the card's values, bit for bit.
"""

import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the slice's tensors live on the card)")
    return torch.device("cuda")


def _tcp(n, fn, **kw):
    from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

    ready, addr = threading.Event(), [None]
    out, errs = [None] * n, []

    def main(r):
        try:
            if r == 0:
                p = TcpProc(0, n, coordinator=("127.0.0.1", 0),
                            on_coordinator_bound=lambda a: (
                                addr.__setitem__(0, a), ready.set()), **kw)
            else:
                ready.wait(30)
                p = TcpProc(r, n, coordinator=addr[0], **kw)
            try:
                out[r] = fn(p)
            finally:
                p.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            ready.set()

    ts = [threading.Thread(target=main, args=(r,)) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if errs:
        raise errs[0]
    return out


def test_host_window_takes_and_fills_cuda_tensors(cuda):
    from zhpe_ompi_tpu_torch import ops
    from zhpe_ompi_tpu_torch.osc.window import HostWindow
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse

    vals = torch.arange(8, dtype=torch.float32, device=cuda) / 3
    uni = LocalUniverse(2)

    def prog(ctx):
        win = HostWindow.create(ctx, np.zeros(8, np.float32))
        win.fence()
        win.put(vals[4 * ctx.rank:4 * ctx.rank + 4], 1 - ctx.rank, 4 * ctx.rank)
        win.accumulate(vals[:1] * 0 + 1, 1 - ctx.rank, 0, ops.SUM)
        win.fence()
        got = torch.empty(8, device=cuda)
        assert win.get(ctx.rank, out=got) is got
        win.free()
        return got

    try:
        res = uni.run(prog)
    finally:
        uni.close()
    want = torch.zeros(8, device=cuda)
    want[0] = 1
    assert torch.equal(res[0], torch.cat([want[:4], vals[4:]]))
    assert torch.equal(res[1][:4], vals[:4] + want[:4])


def test_direct_window_and_bcast_into_cuda(cuda):
    from zhpe_ompi_tpu_torch.osc import direct

    src = torch.randn(1 << 16, device=cuda)

    def prog(p):
        win = direct.allocate_window(p, src.numel() * 4 if p.rank == 0 else 0,
                                     np.float32)
        out = torch.empty_like(src)
        got = direct.window_bcast(win, src if p.rank == 0 else None, root=0,
                                  out=out)
        win.fence()
        win.free()
        return got is out, out

    res = _tcp(3, prog, sm=True, sm_boot_id="cudahost")
    for same, out in res:
        assert same and torch.equal(out, src)


def test_wirefile_round_trips_cuda_tensors(cuda, tmp_path):
    from zhpe_ompi_tpu_torch.datatype import BFLOAT16, FLOAT
    from zhpe_ompi_tpu_torch.io import file as iofile
    from zhpe_ompi_tpu_torch.io.wirefile import WireFile

    x = torch.randn(2, 64, device=cuda)
    path = str(tmp_path / "c.bin")

    def prog(p):
        with WireFile(p, path, iofile.MODE_CREATE | iofile.MODE_RDWR) as f:
            f.set_view(p.rank * 64 * 4, FLOAT)
            f.write_all(x[p.rank])
            f.seek(0)
            back = f.read_all(64)
            f.set_view(512 + p.rank * 64 * 2, BFLOAT16)
            f.write_all(x[p.rank].to(torch.bfloat16))
            f.seek(0)
            half = f.read_all(64)
        return back, half

    res = _tcp(2, prog, sm=False)
    for r, (back, half) in enumerate(res):
        assert np.array_equal(back, x[r].cpu().numpy())
        assert torch.equal(half.to(cuda), x[r].to(torch.bfloat16))
