"""Where the port's kernels spend their time, on the card.

    python3 -m zhpe_ompi_tpu_torch._flash_probe [KIND ...]

KIND is ``fwd``, ``dq``, ``dkv`` or ``ln_bwd`` (all four when none is
given).  Builds variants of ``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu`` and ``csrc/fused_norm.cu`` that each leave
out one part of the work (the exp, a product, the delta pass, the row
statistics' loads, the dg fold or the rows) or change one design choice
(ring stages, blocks per SM, a product left in flight), and times each
against the unchanged kernel at the headline shape ((16, 512, 16, 64)
bf16 causal for attention, (8192, 1024) bf16 for the layernorm
backward), inputs cold in L2, in turns: the unchanged kernel first and
last.  A part whose removal saves little is not what bounds the kernel.
The variants compute wrong results; they are built in a temporary copy of
``csrc`` and used for timing only.  Prints one JSON line per variant and a
last line with the card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SHAPE = (16, 512, 16, 64)
LN_SHAPE = (8192, 1024)

# variant name -> [(text, replacement), ...] in the kernel's source; each
# text must occur there exactly once
FWD = {
    "kernel": [],
    "no_exp": [("s[4 * j] = ex2(fmaf(s[4 * j], sl2, -b0));",
                "s[4 * j] = fmaf(s[4 * j], sl2, -b0);"),
               ("s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -b0));",
                "s[4 * j + 1] = fmaf(s[4 * j + 1], sl2, -b0);"),
               ("s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -b1));",
                "s[4 * j + 2] = fmaf(s[4 * j + 2], sl2, -b1);"),
               ("s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -b1));",
                "s[4 * j + 3] = fmaf(s[4 * j + 3], sl2, -b1);")],
    "no_pv": [("for (int j = 0; j < kBN / 16; ++j) wgmma_rs(acc,",
               "for (int j = 0; j < 0; ++j) wgmma_rs(acc,")],
    "no_qk": [("for (int kk = 0; kk < HD / 16; ++kk)\n          wgmma_ss(s,",
               "for (int kk = 0; kk < 0; ++kk)\n          wgmma_ss(s,")],
    "stages_2": [("kStages = HD <= 64 ? 3 : 2;", "kStages = 2;")],
    "stages_4": [("kStages = HD <= 64 ? 3 : 2;", "kStages = HD <= 64 ? 4 : 2;")],
    "one_block_per_sm": [("kMinBlocks = HD <= 64 ? 2 : 1;", "kMinBlocks = 1;")],
}
DQ = {
    "kernel": [],
    "no_exp": [("float p = ex2(fmaf(s[4 * j + e], sl2, -(e < 2 ? l0 : l1)));",
                "float p = fmaf(s[4 * j + e], sl2, -(e < 2 ? l0 : l1));")],
    "no_s": [("for (int kk = 0; kk < HD / 16; ++kk)\n          wgmma_ss(s, desc_k<HD>(sq, kk)",
              "for (int kk = 0; kk < 0; ++kk)\n          wgmma_ss(s, desc_k<HD>(sq, kk)")],
    "no_dp": [("for (int kk = 0; kk < HD / 16; ++kk)\n          wgmma_ss(dp, desc_k<HD>(sdo, kk)",
               "for (int kk = 0; kk < 0; ++kk)\n          wgmma_ss(dp, desc_k<HD>(sdo, kk)")],
    "no_dsk": [("for (int j = 0; j < kBN / 16; ++j) wgmma_rs(dqa,",
                "for (int j = 0; j < 0; ++j) wgmma_rs(dqa,")],
    "no_delta": [("for (int c = tq * 8; c < HD; c += 32) {",
                  "for (int c = tq * 8; c < 0; c += 32) {")],
    "stages_2": [("kStages = HD <= 64 ? 4 : 3;\n  static constexpr int kQBufs",
                  "kStages = 2;\n  static constexpr int kQBufs")],
    "stages_3": [("kStages = HD <= 64 ? 4 : 3;\n  static constexpr int kQBufs",
                  "kStages = 3;\n  static constexpr int kQBufs")],
    "stages_5": [("kStages = HD <= 64 ? 4 : 3;\n  static constexpr int kQBufs",
                  "kStages = HD <= 64 ? 5 : 3;\n  static constexpr int kQBufs")],
    "stages_6": [("kStages = HD <= 64 ? 4 : 3;\n  static constexpr int kQBufs",
                  "kStages = HD <= 64 ? 6 : 3;\n  static constexpr int kQBufs")],
    "dsk_not_in_flight": [("wgmma_wait<1>();  // S and dP; the product runs on",
                           "wgmma_wait<0>();  // S and dP; the product runs on")],
}
DKV = {
    "kernel": [],
    "no_exp": [("float p = ex2(fmaf(s[4 * j + e], sl2, -ll[e & 1]));",
                "float p = fmaf(s[4 * j + e], sl2, -ll[e & 1]);")],
    "no_dv_dk": [("for (int j = 0; j < kBQ / 16; ++j) wgmma_rs(dva,",
                  "for (int j = 0; j < 0; ++j) wgmma_rs(dva,"),
                 ("for (int j = 0; j < kBQ / 16; ++j) wgmma_rs(dka,",
                  "for (int j = 0; j < 0; ++j) wgmma_rs(dka,")],
    "no_s_dp": [("for (int kk = 0; kk < HD / 16; ++kk)\n          wgmma_ss(s, desc_k<HD>(sk, kk)",
                 "for (int kk = 0; kk < 0; ++kk)\n          wgmma_ss(s, desc_k<HD>(sk, kk)"),
                ("for (int kk = 0; kk < HD / 16; ++kk)\n          wgmma_ss(dp, desc_k<HD>(sv, kk)",
                 "for (int kk = 0; kk < 0; ++kk)\n          wgmma_ss(dp, desc_k<HD>(sv, kk)")],
    "no_stats_loads": [("sl[r] = q < S ? lse[at] * kLog2e : 0.f;", "sl[r] = 0.f;"),
                       ("sd[r] = q < S ? delta[at] : 0.f;", "sd[r] = 0.f;")],
    "stages_2": [("kStages = HD <= 64 ? 3 : 2;\n  static constexpr int kKV",
                  "kStages = 2;\n  static constexpr int kKV")],
    "stages_4": [("kStages = HD <= 64 ? 3 : 2;\n  static constexpr int kKV",
                  "kStages = HD <= 64 ? 4 : 2;\n  static constexpr int kKV")],
}
LN_BWD = {
    "kernel": [],
    # the row pass alone: no grid barrier, no fold of the partial rows
    "no_dg_fold": [("  cg::this_grid().sync();", "  return;")],
    # the fold alone: every block skips the rows and folds zero partials
    "dg_fold_only": [("int64_t row = (int64_t)blockIdx.x * W + warp;", "int64_t row = n;")],
    # neither: the launch, g's staging and the blocks' partial rows
    "no_rows_no_fold": [("int64_t row = (int64_t)blockIdx.x * W + warp;", "int64_t row = n;"),
                        ("  cg::this_grid().sync();", "  return;")],
    # the same with an ordinary launch: what the cooperative launch costs
    "no_rows_no_fold_plain_launch": [
        ("int64_t row = (int64_t)blockIdx.x * W + warp;", "int64_t row = n;"),
        ("  cg::this_grid().sync();", "  return;"),
        ("return (int)cudaLaunchCooperativeKernel(", "return (int)cudaLaunchKernel(")],
}
# kind -> (source in csrc, variants)
KINDS = {"fwd": ("flash_attention", FWD), "dq": ("flash_attention_bwd", DQ),
         "dkv": ("flash_attention_bwd", DKV), "ln_bwd": ("fused_norm", LN_BWD)}


def apply_variant(text, kind, name):
    """``text`` (the source of ``kind``'s kernel) with variant ``name``'s
    substitutions made; raises ValueError where a substituted text does not
    occur exactly once."""
    src, table = KINDS[kind]
    for old, new in table[name]:
        if text.count(old) != 1:
            raise ValueError(f"{kind} {name}: {old!r} is not in {src}.cu once")
        text = text.replace(old, new)
    return text


def _time_us(torch, fn, n_sets, iters=100):
    """Mean device time of one call (CUDA events around ``iters`` calls that
    rotate over ``n_sets`` input sets, queued behind a spin kernel)."""
    for i in range(4):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _time_ln_bwd(torch):
    from zhpe_ompi_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    g = 1 + 0.1 * torch.randn(LN_SHAPE[1], generator=gen, device="cuda")
    sets = []
    for _ in range(3):  # 3 sets of x and dy (32 MB each): more than the L2
        x, dy = (torch.randn(LN_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        _, m, r = fn.ln_fwd_plain(x, g)
        sets.append((x, dy, m, r))
    return _time_us(torch, lambda i: fn.ln_bwd(sets[i][0], g, *sets[i][1:]), len(sets))


def _one(kind, name, csrc):
    """Time one variant in this process, built from the sources in ``csrc``."""
    import torch

    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa

    _build.CSRC = csrc
    _build.BUILD_DIR = os.path.join(csrc, "_build")
    if kind == "ln_bwd":
        us = _time_ln_bwd(torch)
        print(json.dumps({"kernel": kind, "variant": name, "us": us}), flush=True)
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    sets = []
    for _ in range(3):  # 3 sets of q, k, v, dO: more than the 50 MB L2
        q, k, v, do = (torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out = lse = delta = None
        if kind != "fwd":
            out, lse = fa.flash_fwd_plain(q, k, v, True)
        if kind == "dkv":
            _, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
        sets.append((q, k, v, do, out, lse, delta))
    if kind == "fwd":
        us = _time_us(torch, lambda i: fa.flash_fwd(*sets[i][:3], True), len(sets))
    elif kind == "dq":
        us = _time_us(torch, lambda i: fa.flash_bwd_dq(
            *sets[i][:3], sets[i][4], sets[i][5], sets[i][3], True), len(sets))
    else:
        us = _time_us(torch, lambda i: fa.flash_bwd_dkv(
            *sets[i][:3], sets[i][5], sets[i][6], sets[i][3], True), len(sets))
    print(json.dumps({"kernel": kind, "variant": name, "us": us}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:  # one variant, in a fresh process
        _one(*sys.argv[2:])
        return 0
    kinds = sys.argv[1:] or list(KINDS)
    unknown = [k for k in kinds if k not in KINDS]
    if unknown:
        print(f"flash_probe: unknown kind {unknown}, expected some of {list(KINDS)}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    for kind in kinds:
        src, table = KINDS[kind]
        order = ["kernel"] + [n for n in table if n != "kernel"] + ["kernel"]
        for name in order:
            with tempfile.TemporaryDirectory() as tmp:
                csrc = os.path.join(tmp, "csrc")
                shutil.copytree(os.path.join(here, "csrc"), csrc,
                                ignore=shutil.ignore_patterns("_build"))
                path = os.path.join(csrc, src + ".cu")
                with open(path) as fh:
                    text = apply_variant(fh.read(), kind, name)
                with open(path, "w") as fh:
                    fh.write(text)
                t0 = time.perf_counter()
                subprocess.run([sys.executable, "-m", "zhpe_ompi_tpu_torch._flash_probe",
                                "--one", kind, name, csrc], cwd=root, check=True, timeout=600)
                print(f"  ({kind} {name}: {time.perf_counter() - t0:.0f} s with its build)",
                      flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
