#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`singa_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build  -- compile every CUDA kernel of the port from `singa_tpu_torch/
   ops/csrc/` (one nvcc per source, all at once) and print the seconds.
2. kernel -- hold each kernel against its plain PyTorch version on the card
   at the shapes below, and time kernel, plain version and the PyTorch
   library call computing the same function, beside the card's bound, at
   the shapes the train phase gives each kernel.
3. serve  -- TransformerLM at full bench width (V32000 d512 h8 l8,
   max_len 1024, random weights from a seed) behind the port's
   ServingEngine; two threads submit 8 requests of 1024 tokens. Replies are
   checked for shape, finiteness and agreement with the unbatched forward,
   and the flash-attention forward kernel must have launched once per layer
   per dispatch.
4. train  -- the same TransformerLM trained through `Model.__call__` ->
   `train_one_batch` -> SGD(lr 0.1, momentum 0.9) under bf16 AMP, as
   `bench.py --stage lm` configures it, at batch 8 x 1024 tokens for one
   warm-up and 5 timed steps on one batch, then 5 steps split into
   forward, backward and optimizer by CUDA events. The losses must be
   finite and fall, the first must equal the plain cross-entropy of a
   no-grad forward, every parameter must move and stay finite, and each
   kernel must have launched exactly as often as the steps need (L per
   step for the three attention kernels, 1 per step for the two
   cross-entropy kernels).
5. result -- the card's name and power limit, one `{"kernels": [...]}`
   line (launches from the train phase), and last `{"ok": true, ...}`.

Imports nothing of JAX or of the JAX package. Exits non-zero when no CUDA
device is present, or when the port is not beside this file.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

SEED = 0
# H100 SXM data-sheet peaks (dense): f32 outside the tensor cores, bf16 on
# the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

# (shape B,H,S,D; causal; dtype; atol; rtol) for the kernel check.
# float32: the kernel sums over K tiles with an online softmax where the
#   plain version takes one softmax over the whole row, so results differ
#   by summation order only: atol 2e-5, rtol 1e-4.
# bfloat16: both versions compute in float32 from the same bf16 inputs and
#   round o to bf16 once, so they differ by at most one bf16 ulp of o, which
#   is under 2^-7 |o|: rtol 8e-3, with atol 1e-3 for o near 0. A typical |o|
#   at S=1024 is ~0.05, so a dropped or misweighted K tile fails this.
# lse is float32 in both versions for either dtype: atol 2e-5, rtol 1e-5.
# (1,2,100,16) and (1,2,70,32) hold the D=16 and D=32 instantiations.
KERNEL_CASES = [
    ((4, 8, 1024, 64), True, "float32", 2e-5, 1e-4),
    ((4, 8, 1024, 64), True, "bfloat16", 1e-3, 8e-3),
    ((2, 3, 1000, 64), False, "float32", 2e-5, 1e-4),
    ((1, 2, 256, 128), True, "bfloat16", 1e-3, 8e-3),
    ((1, 2, 100, 16), False, "float32", 2e-5, 1e-4),
    ((1, 2, 70, 32), True, "bfloat16", 1e-3, 8e-3),
    ((8, 8, 1024, 64), True, "bfloat16", 1e-3, 8e-3),  # the train phase's
]
LSE_ATOL, LSE_RTOL = 2e-5, 1e-5
SERVE_ATTN = ((4, 8, 1024, 64), True, "float32")  # one serve layer
# The train phase's shapes: one layer's attention and one step's logits
# (bf16 under AMP).
TRAIN_ATTN = ((8, 8, 1024, 64), True, "bfloat16")
TRAIN_XENT = ((8192, 32000), "bfloat16")

# (shape B,C; dtype) for the cross-entropy kernels; every case has labels
# < 0 and >= C. Per-row losses are float32 in both versions for either
# dtype and differ by the summation order of up to 32000 exp terms (the
# kernel sums online with a running max): atol 1e-4, rtol 1e-5 on losses
# ~10. dx: float32 differs by a few ulp (rtol 1e-4, atol 1e-9 for values
# ~g/C); bfloat16 by at most one bf16 ulp of dx (rtol 8e-3, atol 1e-9).
XENT_CASES = [((8192, 32000), "bfloat16"), ((8192, 32000), "float32"),
              ((33, 17), "float32"), ((33, 17), "bfloat16")]
XENT_LOSS_ATOL, XENT_LOSS_RTOL = 1e-4, 1e-5
XENT_DX_TOL = {"float32": (1e-9, 1e-4), "bfloat16": (1e-9, 8e-3)}

# (shape B,H,S,D; causal; dtype) for the flash-attention backward, with o
# and lse from the forward kernel and a random dO. dq, dk, dv: float32
# differs from the plain version by summation order only (|dq| ~ 1; a
# wrong scale placement in s or lse moves them by ~1e-3): atol 1e-4,
# rtol 1e-4; bfloat16 by at most one bf16 ulp of the output after the same
# float32 math: atol 1e-3, rtol 8e-3. delta = rowsum(dO * O) is float32 in
# both: atol 1e-4, rtol 1e-5. The cases hold every D instantiation.
BWD_CASES = [
    ((8, 8, 1024, 64), True, "float32"),
    ((8, 8, 1024, 64), True, "bfloat16"),
    ((2, 3, 1000, 64), False, "float32"),
    ((1, 2, 256, 128), True, "bfloat16"),
    ((1, 2, 100, 16), False, "float32"),
    ((1, 2, 70, 32), True, "bfloat16"),
]
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 8e-3)}
DELTA_ATOL, DELTA_RTOL = 1e-4, 1e-5

# Serving: the configuration `bench.py --stage lm` runs, at full width.
LM = dict(vocab_size=32000, d_model=512, num_heads=8, num_layers=8,
          max_len=1024)
N_REQUESTS, SEQ, MAX_BATCH, MAX_WAIT_MS = 8, 1024, 4, 50.0
TRAIN_BATCH, TRAIN_STEPS = 8, 5  # timed steps, after one warm-up step
BREAKDOWN_STEPS = 5  # further steps split into forward, backward, optimizer
# The first step's loss against the plain cross-entropy of a no-grad
# forward of the same weights: the forwards launch the same kernels, so the
# two differ by the xent kernel's summation order over 8192 rows.
TRAIN_LOSS_RTOL = 1e-4
# A reply and the unbatched forward of the same ids run at different batch
# sizes, so cuBLAS may pick another float32 algorithm (another summation
# order) through 8 layers; logits are O(1). A wrong or shifted row is off
# by O(1), far outside this.
SERVE_ATOL, SERVE_RTOL = 1e-3, 1e-3


class Failed(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over `reps` of the mean device time of `iters` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, dtype: str):
    """Least time for the card: max(operations / peak for `dtype`, bytes /
    bandwidth). Returns (ms, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_work(shape, causal: bool, dtype: str, products: int,
                   operands: int, outputs: int, f32_rows: int):
    """(operations, bytes) of one attention kernel: `products` products of
    2*D operations per (query, key) pair the mask keeps; `operands` [B,H,S,D]
    arrays read and `outputs` written once, and `f32_rows` float32 [B,H,S]
    arrays (lse, delta) read or written once."""
    b, h, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    esize = 4 if dtype == "float32" else 2
    flops = 2.0 * products * b * h * d * pairs
    nbytes = ((operands + outputs) * b * h * s * d * esize
              + f32_rows * b * h * s * 4)
    return flops, nbytes


def entry(name, source, replaces, max_err, ms, plain_ms, work, peak,
          library_ms):
    """One kernel's record for the `{"kernels": [...]}` line; its bound at
    the `peak` dtype's rate. `launches` is filled by the train phase."""
    bms, by = bound_ms(*work, peak)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms}


def report(name, shape, dtype, e, work, peak, library):
    """Print a kernel's times beside its bound, naming the peak used."""
    flops, nbytes = work
    where = ("of the tensor cores" if peak == "bfloat16"
             else "outside the tensor cores")
    print(f"kernel {name} {shape} {dtype}: kernel {e['ms']:.4f} ms, plain "
          f"{e['plain_ms']:.4f} ms, library {library}, bound "
          f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({flops / 1e9:.3f} "
          f"GFLOP at the {PEAK_FLOPS[peak] / 1e12:.0f} TFLOP/s {peak} peak "
          f"{where}; {nbytes / 1e6:.2f} MB at {PEAK_BYTES_PER_S / 1e12} "
          f"TB/s); "
          f"kernel at {flops / (e['ms'] * 1e-3) / 1e12:.2f} TFLOP/s, "
          f"{nbytes / (e['ms'] * 1e-3) / 1e12:.3f} TB/s")


def close(got, want, atol, rtol):
    """(all within atol + rtol*|want| and finite, max abs error)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = (bool(torch.isfinite(got).all())
          and bool((err <= atol + rtol * want.abs()).all()))
    return ok, err.max().item()


def phase_build():
    from singa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s {time.perf_counter() - t0:.3f} "
          f"(kernels: {', '.join(_build.KERNELS)})")
    for name in _build.KERNELS:
        kernel, spill = "?", ""
        for line in _build.build_log(name).splitlines():
            m = re.search(r"entry function '(\S+?)'", line)
            if m:  # the kernel's name and mangled template arguments
                k = re.search(r"\d([a-z][a-z_]*_kernel)I(\S*?)EEv",
                              m.group(1))
                kernel = " ".join(k.groups()) if k else m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"  ptxas {kernel}: {m.group(1)} registers, "
                      f"{spill} bytes spill stores")


def phase_kernel():
    entries = {"flash_attn_fwd": check_flash_fwd()}
    entries.update(check_xent())
    entries.update(check_flash_bwd())
    return entries


def _qkv(shape, dtype, g, n=3):
    import torch

    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(n)]


def check_flash_fwd():
    import torch
    import torch.nn.functional as F

    from singa_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    errs = {}
    for shape, causal, dt, atol, rtol in KERNEL_CASES:
        q, k, v = _qkv(shape, getattr(torch, dt), g)
        o, lse = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_reference(q, k, v, causal)
        ok_o, err_o = close(o, ro, atol, rtol)
        ok_l, err_l = close(lse, rlse, LSE_ATOL, LSE_RTOL)
        ok = ok_o and ok_l
        errs[(shape, causal, dt)] = max(err_o, err_l)
        print(f"kernel flash_attn_fwd {shape} causal={causal} {dt}: "
              f"max|o-ref| {err_o:.3e} max|lse-ref| {err_l:.3e} "
              f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise Failed(f"flash_attn_fwd disagrees with its plain version "
                         f"at {shape} causal={causal} {dt}")
    result = None
    for shape, causal, dt in (SERVE_ATTN, TRAIN_ATTN):
        q, k, v = _qkv(shape, getattr(torch, dt), g)
        ms = time_ms(lambda: flash_attention(q, k, v, causal))
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v,
                                                             causal))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        work = attention_work(shape, causal, dt, 2, 3, 1, 1)
        e = entry("flash_attn_fwd",
                  "singa_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                  "singa_tpu/ops/pallas_kernels.py:494",
                  errs[(shape, causal, dt)], ms, plain_ms, work, dt,
                  library_ms)
        report("flash_attn_fwd", shape, dt, e, work, dt,
               f"(scaled_dot_product_attention) {library_ms:.4f} ms")
        result = e  # the train phase's shape, last
    return result


def check_xent():
    import torch
    import torch.nn.functional as F

    from singa_tpu_torch.ops.softmax_xent import (
        softmax_xent, softmax_xent_bwd, softmax_xent_bwd_reference,
        softmax_xent_reference)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    err_f, err_b = 0.0, 0.0
    for (b, c), dt in XENT_CASES:
        x = (2 * torch.randn((b, c), generator=g, device="cuda")).to(
            getattr(torch, dt))
        lab = torch.randint(0, c, (b,), generator=g, device="cuda")
        lab[::7] = -1
        lab[3::11] = c
        gr = torch.randn((b,), generator=g, device="cuda")
        loss = softmax_xent(x, lab)
        dx = softmax_xent_bwd(x, lab, gr)
        torch.cuda.synchronize()
        ok_l, e_l = close(loss, softmax_xent_reference(x, lab),
                          XENT_LOSS_ATOL, XENT_LOSS_RTOL)
        ok_d, e_d = close(dx, softmax_xent_bwd_reference(x, lab, gr),
                          *XENT_DX_TOL[dt])
        ok_z = bool((loss[lab < 0] == 0).all()) and bool(
            (dx[lab >= c] == 0).all())
        print(f"kernel softmax_xent ({b}, {c}) {dt}: max|loss-ref| "
              f"{e_l:.3e} (atol {XENT_LOSS_ATOL}, rtol {XENT_LOSS_RTOL}), "
              f"max|dx-ref| {e_d:.3e} (atol, rtol {XENT_DX_TOL[dt]}), "
              f"invalid rows zero {ok_z} "
              f"{'ok' if ok_l and ok_d and ok_z else 'MISMATCH'}")
        if not (ok_l and ok_d and ok_z):
            raise Failed(f"softmax_xent disagrees with its plain version at "
                         f"({b}, {c}) {dt}")
        if ((b, c), dt) == TRAIN_XENT:
            err_f, err_b = e_l, e_d
            main = (x, lab, gr)
    (b, c), dt = TRAIN_XENT
    x, lab, gr = main
    valid = torch.randint(0, c, (b,), generator=g, device="cuda")
    esize = x.element_size()
    src = "singa_tpu_torch/ops/csrc/softmax_xent.cu"
    # forward: read x, labels; write the loss; ~4 operations per logit
    # (max, subtract, exp, add). backward: read x, labels, g; write dx;
    # ~8 operations per logit over its two passes. The math is float32
    # outside the tensor cores, so the float32 peak bounds the operations.
    work_f = (4.0 * b * c, b * c * esize + 2 * b * 4)
    work_b = (8.0 * b * c, 2 * b * c * esize + 2 * b * 4)
    lib_f = time_ms(lambda: F.cross_entropy(x, valid, reduction="none"))
    fwd = entry("softmax_xent_fwd", src,
                "singa_tpu/ops/pallas_kernels.py:171", err_f,
                time_ms(lambda: softmax_xent(x, lab)),
                time_ms(lambda: softmax_xent_reference(x, lab)), work_f,
                "float32", lib_f)
    report("softmax_xent_fwd", (b, c), dt, fwd, work_f, "float32",
           f"(cross_entropy, reduction='none', all labels valid) "
           f"{lib_f:.4f} ms")
    bwd = entry("softmax_xent_bwd", src,
                "singa_tpu/ops/pallas_kernels.py:193", err_b,
                time_ms(lambda: softmax_xent_bwd(x, lab, gr)),
                time_ms(lambda: softmax_xent_bwd_reference(x, lab, gr)),
                work_b, "float32", None)
    report("softmax_xent_bwd", (b, c), dt, bwd, work_b, "float32",
           "none (no single PyTorch call computes (softmax(x) - onehot) * g "
           "per row; cross_entropy's backward needs its forward graph)")
    return {"softmax_xent_fwd": fwd, "softmax_xent_bwd": bwd}


def check_flash_bwd():
    import torch
    import torch.nn.functional as F

    from singa_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_dkv, flash_attention_dkv_reference,
        flash_attention_dq, flash_attention_dq_reference)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    errs = {}
    for shape, causal, dt in BWD_CASES:
        q, k, v, do = _qkv(shape, getattr(torch, dt), g, n=4)
        o, lse = flash_attention(q, k, v, causal)
        dq, delta = flash_attention_dq(q, k, v, o, lse, do, causal)
        dk, dv = flash_attention_dkv(q, k, v, lse, delta, do, causal)
        torch.cuda.synchronize()
        rdq, rdelta = flash_attention_dq_reference(q, k, v, o, lse, do,
                                                   causal)
        rdk, rdv = flash_attention_dkv_reference(q, k, v, lse, rdelta, do,
                                                 causal)
        atol, rtol = BWD_TOL[dt]
        res = {"dq": close(dq, rdq, atol, rtol),
               "delta": close(delta, rdelta, DELTA_ATOL, DELTA_RTOL),
               "dk": close(dk, rdk, atol, rtol),
               "dv": close(dv, rdv, atol, rtol)}
        ok = all(r[0] for r in res.values())
        errs[(shape, causal, dt)] = (max(res["dq"][1], res["delta"][1]),
                                     max(res["dk"][1], res["dv"][1]))
        print(f"kernel flash_attn_bwd {shape} causal={causal} {dt}: "
              + ", ".join(f"max|{n}-ref| {r[1]:.3e}" for n, r in res.items())
              + f" (atol {atol}, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise Failed(f"flash_attn_bwd disagrees with its plain version "
                         f"at {shape} causal={causal} {dt}: "
                         f"{[n for n, r in res.items() if not r[0]]}")
    shape, causal, dt = TRAIN_ATTN
    q, k, v, do = _qkv(shape, getattr(torch, dt), g, n=4)
    o, lse = flash_attention(q, k, v, causal)
    _, delta = flash_attention_dq(q, k, v, o, lse, do, causal)
    # Yardstick for both kernels: the backward of PyTorch's fused attention
    # at the same shape and dO, which computes dq, dk and dv together.
    qq, kk, vv = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
    lib = time_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                              retain_graph=True))
    src = "singa_tpu_torch/ops/csrc/flash_attn_bwd.cu"
    err_dq, err_dkv = errs[TRAIN_ATTN]
    # dq: s, dP, dq per pair; reads q, k, v, o, dO and lse; writes dq and
    # delta. dk/dv: s, dP, dv, dk per pair; reads q, k, v, dO, lse and
    # delta; writes dk and dv.
    work_dq = attention_work(shape, causal, dt, 3, 5, 1, 2)
    work_dkv = attention_work(shape, causal, dt, 4, 4, 2, 2)
    e_dq = entry("flash_attn_dq", src, "singa_tpu/ops/pallas_kernels.py:525",
                 err_dq,
                 time_ms(lambda: flash_attention_dq(q, k, v, o, lse, do,
                                                    causal)),
                 time_ms(lambda: flash_attention_dq_reference(
                     q, k, v, o, lse, do, causal)), work_dq, dt, lib)
    e_dkv = entry("flash_attn_dkv", src,
                  "singa_tpu/ops/pallas_kernels.py:539", err_dkv,
                  time_ms(lambda: flash_attention_dkv(q, k, v, lse, delta,
                                                      do, causal)),
                  time_ms(lambda: flash_attention_dkv_reference(
                      q, k, v, lse, delta, do, causal)), work_dkv, dt, lib)
    lib_txt = (f"(backward of scaled_dot_product_attention, dq+dk+dv "
               f"together) {lib:.4f} ms")
    report("flash_attn_dq", shape, dt, e_dq, work_dq, dt, lib_txt)
    report("flash_attn_dkv", shape, dt, e_dkv, work_dkv, dt, lib_txt)
    return {"flash_attn_dq": e_dq, "flash_attn_dkv": e_dkv}


def phase_serve():
    import torch

    from singa_tpu_torch.models.transformer import TransformerLM
    from singa_tpu_torch.ops.flash_attention import flash_attention
    from singa_tpu_torch.serve import ServingEngine

    t0 = time.perf_counter()
    model = TransformerLM(**LM, device="cuda", seed=SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve model TransformerLM {LM}: {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.3f} s")
    rs = np.random.RandomState(SEED)
    reqs = [rs.randint(0, LM["vocab_size"], (1, SEQ)).astype(np.int32)
            for _ in range(N_REQUESTS)]
    engine = ServingEngine(model, max_batch=MAX_BATCH,
                           max_wait_ms=MAX_WAIT_MS)
    print(f"serve warmup: {engine.warmup(reqs[0])} buckets")
    replies = [None] * N_REQUESTS
    errors = []

    def client(idx):
        try:
            futs = [(i, engine.submit(reqs[i])) for i in idx]
            for i, f in futs:
                replies[i] = f.result(timeout=300)
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(range(t, N_REQUESTS, 2),))
               for t in range(2)]
    engine.start()
    flash_attention.launches = 0
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t_start
    launches = flash_attention.launches
    engine.stop()
    if errors or any(t.is_alive() for t in threads):
        raise Failed(f"serve clients failed: {errors!r}")
    snap = engine.stats.snapshot()
    pct = engine.percentiles()
    if snap["replies"] != N_REQUESTS:
        raise Failed(f"{snap['replies']} replies for {N_REQUESTS} requests")
    if launches == 0 or launches != LM["num_layers"] * snap["dispatches"]:
        raise Failed(f"flash_attn_fwd launched {launches} times over "
                     f"{snap['dispatches']} dispatches of "
                     f"{LM['num_layers']} layers")
    print(f"serve: {N_REQUESTS} requests x {SEQ} tokens in {wall:.4f} s: "
          f"{N_REQUESTS / wall:.3f} requests/s, "
          f"{N_REQUESTS * SEQ / wall:.1f} tokens/s, p50 {pct['p50_ms']} ms, "
          f"p99 {pct['p99_ms']} ms, {snap['dispatches']} dispatches "
          f"(buckets {snap['buckets']}, occupancy {snap['occupancy']}), "
          f"flash_attn_fwd launches {launches}")

    worst = 0.0
    with torch.inference_mode():
        for ids, rep in zip(reqs, replies):
            if rep.shape != (1, SEQ, LM["vocab_size"]):
                raise Failed(f"reply shape {rep.shape}")
            if not np.isfinite(rep).all():
                raise Failed("non-finite logits in a reply")
            ref = model(torch.from_numpy(ids).cuda()).cpu().numpy()
            err = np.abs(rep - ref)
            worst = max(worst, float(err.max()))
            if not (err <= SERVE_ATOL + SERVE_RTOL * np.abs(ref)).all():
                raise Failed(f"reply differs from the unbatched forward by "
                             f"up to {float(err.max()):.3e}")
        # Where a dispatch's time goes: the batch-4 forward on the card
        # and the copy of its logits to the host.
        x = torch.from_numpy(np.concatenate(reqs[:MAX_BATCH])).cuda()
        fwd_ms = time_ms(lambda: model(x), reps=3, iters=3)
        logits = model(x)
        d2h_ms = time_ms(lambda: logits.cpu(), reps=3, iters=3)
    print(f"serve replies: shape (1, {SEQ}, {LM['vocab_size']}), finite, "
          f"max |reply - unbatched forward| {worst:.3e} (atol {SERVE_ATOL}, "
          f"rtol {SERVE_RTOL}) ok")
    print(f"serve breakdown at batch {MAX_BATCH}: forward {fwd_ms:.3f} ms, "
          f"logits to host {d2h_ms:.3f} ms "
          f"({logits.numel() * 4 / 1e6:.1f} MB)")


def phase_train(entries):
    import torch

    from singa_tpu_torch import autograd, opt, tensor
    from singa_tpu_torch.models.transformer import TransformerLM
    from singa_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from singa_tpu_torch.ops.softmax_xent import (softmax_xent,
                                                  softmax_xent_bwd,
                                                  softmax_xent_reference)

    V, L = LM["vocab_size"], LM["num_layers"]
    tensor.set_compute_dtype("bfloat16")
    tensor.set_matmul_precision("default")
    try:
        model = TransformerLM(**LM, device="cuda", seed=SEED)
        model.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        rs = np.random.RandomState(SEED + 1)
        x, y = (torch.from_numpy(rs.randint(0, V, (TRAIN_BATCH, SEQ))
                                 .astype(np.int32)).cuda() for _ in range(2))
        model.compile([x], is_train=True, use_graph=False)
        with torch.no_grad():
            logits = model.forward(x).reshape(-1, V)
            ref_loss = (softmax_xent_reference(logits, y.reshape(-1).long())
                        .sum().item() / logits.shape[0])
            del logits
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = [(flash_attention, "launches"),
                    (flash_attention_bwd, "dq_launches"),
                    (flash_attention_bwd, "dkv_launches"),
                    (softmax_xent, "launches"), (softmax_xent_bwd, "launches")]
        for fn, attr in counters:
            setattr(fn, attr, 0)
        losses, step_s = [], []
        for _ in range(1 + TRAIN_STEPS):
            t0 = time.perf_counter()
            _, loss = model(x, y)
            losses.append(loss.item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        counts = [getattr(fn, attr) for fn, attr in counters]
        peak = torch.cuda.max_memory_allocated()
        n = 1 + TRAIN_STEPS
        want = [L * n, L * n, L * n, n, n]
        print(f"train: TransformerLM {LM} batch {TRAIN_BATCH} x {SEQ}, bf16 "
              f"AMP, SGD(lr 0.1, momentum 0.9): losses {losses}; "
              f"launches fwd/dq/dkv/xent_fwd/xent_bwd {counts} over {n} "
              f"steps (want {want})")
        if not all(math.isfinite(v) for v in losses):
            raise Failed(f"non-finite training loss: {losses}")
        if not losses[-1] < losses[0]:
            raise Failed(f"training loss did not fall: {losses}")
        if abs(losses[0] - ref_loss) > TRAIN_LOSS_RTOL * abs(ref_loss):
            raise Failed(f"first step's loss {losses[0]} vs the plain "
                         f"cross-entropy {ref_loss} (rtol {TRAIN_LOSS_RTOL})")
        if counts != want:
            raise Failed(f"kernel launches {counts} over {n} steps, want "
                         f"{want}")
        for (name, p), p0 in zip(model.get_params().items(), before):
            if not bool(torch.isfinite(p).all()):
                raise Failed(f"{name} is not finite after training")
            if torch.equal(p, p0):
                raise Failed(f"{name} did not move in {n} steps")
        print(f"train checks: losses finite and falling "
              f"({losses[0]:.6f} -> {losses[-1]:.6f}), first loss vs plain "
              f"cross-entropy of a no-grad forward {losses[0]:.6f} vs "
              f"{ref_loss:.6f} (rtol {TRAIN_LOSS_RTOL}), "
              f"{len(before)} parameters moved and finite, launches exact")
        for e, c in zip(("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                         "softmax_xent_fwd", "softmax_xent_bwd"), counts):
            entries[e]["launches"] = c

        # Where a step's time goes: CUDA events around its three parts,
        # the median of each over BREAKDOWN_STEPS more steps (one step's
        # split moves by milliseconds where the host issues the launches).
        parts = []
        for _ in range(BREAKDOWN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            out = model.forward(x)
            loss = autograd.softmax_cross_entropy(out.reshape(-1, V),
                                                  y.reshape(-1))
            ev[1].record()
            pairs = autograd.backward(loss)
            ev[2].record()
            model.optimizer.apply_gradients(loss, pairs)
            ev[3].record()
            torch.cuda.synchronize()
            parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
            del out, loss, pairs
        fwd_ms, bwd_ms, opt_ms = (statistics.median(p) for p in zip(*parts))
    finally:
        tensor.set_compute_dtype(None)
        tensor.set_matmul_precision("highest")
    step = statistics.median(step_s[1:])
    print(f"train: step {step * 1e3:.3f} ms (median of {TRAIN_STEPS} after "
          f"a warm-up of {step_s[0] * 1e3:.3f} ms; host clock, each step "
          f"ending in a synchronise), {TRAIN_BATCH * SEQ / step:.1f} "
          f"tokens/s; by CUDA events, median of {BREAKDOWN_STEPS} more "
          f"steps: forward+loss {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms, "
          f"optimizer {opt_ms:.3f} ms; peak device memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    try:
        import singa_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    if Path(singa_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: singa_tpu_torch comes from "
              f"{singa_tpu_torch.__file__}, not from beside this script",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    try:
        phase_build()
        entries = phase_kernel()
        phase_serve()
        phase_train(entries)
    except Exception as e:  # noqa: BLE001 -- any phase failing fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for e in entries.values():
        for k, val in e.items():
            if isinstance(val, float) and not math.isfinite(val):
                print(f"chip_smoke: {e['name']} {k} is not finite",
                      file=sys.stderr)
                return 1
    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
