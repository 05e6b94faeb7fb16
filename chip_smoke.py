#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`singa_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build  -- compile every CUDA kernel of the port from `singa_tpu_torch/
   ops/csrc/` (one nvcc per source, all at once) and print the seconds.
2. kernel -- hold each kernel against its plain PyTorch version on the card
   at the shapes below, and time kernel, plain version and the PyTorch
   library call computing the same function, beside the card's bound.
3. serve  -- TransformerLM at full bench width (V32000 d512 h8 l8,
   max_len 1024, random weights from a seed) behind the port's
   ServingEngine; two threads submit 8 requests of 1024 tokens. Replies are
   checked for shape, finiteness and agreement with the unbatched forward,
   and the flash-attention kernel must have launched once per layer per
   dispatch.
4. result -- the card's name and power limit, one `{"kernels": [...]}`
   line, and last `{"ok": true, "device": {...}}`.

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
# The last two cases hold the D=16 and D=32 instantiations on the card.
KERNEL_CASES = [
    ((4, 8, 1024, 64), True, "float32", 2e-5, 1e-4),
    ((4, 8, 1024, 64), True, "bfloat16", 1e-3, 8e-3),
    ((2, 3, 1000, 64), False, "float32", 2e-5, 1e-4),
    ((1, 2, 256, 128), True, "bfloat16", 1e-3, 8e-3),
    ((1, 2, 100, 16), False, "float32", 2e-5, 1e-4),
    ((1, 2, 70, 32), True, "bfloat16", 1e-3, 8e-3),
]
LSE_ATOL, LSE_RTOL = 2e-5, 1e-5
MAIN_SHAPE, MAIN_DTYPE = (4, 8, 1024, 64), "float32"  # one serve layer

# Serving: the configuration `bench.py --stage lm` runs, at full width.
LM = dict(vocab_size=32000, d_model=512, num_heads=8, num_layers=8,
          max_len=1024)
N_REQUESTS, SEQ, MAX_BATCH, MAX_WAIT_MS = 8, 1024, 4, 50.0
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


def attention_bound_ms(shape, causal: bool, dtype: str):
    """Least time for the card: max(operations / peak, bytes / bandwidth).
    Operations: 2 products of 2*D each per (query, key) pair the mask
    keeps. Bytes: q, k, v read once, o and lse written once."""
    b, h, s, d = shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4.0 * b * h * d * pairs
    esize = 4 if dtype == "float32" else 2
    nbytes = 4 * b * h * s * d * esize + b * h * s * 4
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def phase_build():
    from singa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s {time.perf_counter() - t0:.3f} "
          f"(kernels: {', '.join(_build.KERNELS)})")
    for name in _build.KERNELS:
        entry, spill = "?", ""
        for line in _build.build_log(name).splitlines():
            m = re.search(r"entry function '\S*?kernel(\S*?)EEv", line)
            if m:
                entry = m.group(1)  # mangled template arguments
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"  ptxas {name} {entry}: {m.group(1)} registers, "
                      f"{spill} bytes spill stores")


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from singa_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    main = None
    for shape, causal, dt, atol, rtol in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ro, rlse = flash_attention_reference(q, k, v, causal)
        err_o = (o.float() - ro.float()).abs()
        err_l = (lse - rlse).abs()
        ok = (bool(torch.isfinite(o.float()).all())
              and bool((err_o <= atol + rtol * ro.float().abs()).all())
              and bool((err_l <= LSE_ATOL + LSE_RTOL * rlse.abs()).all()))
        max_err = max(err_o.max().item(), err_l.max().item())
        print(f"kernel flash_attn_fwd {shape} causal={causal} {dt}: "
              f"max|o-ref| {err_o.max().item():.3e} "
              f"max|lse-ref| {err_l.max().item():.3e} "
              f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise Failed(f"flash_attn_fwd disagrees with its plain version "
                         f"at {shape} causal={causal} {dt}")
        if shape == MAIN_SHAPE and dt == MAIN_DTYPE:
            main = (q, k, v, causal, max_err)
    q, k, v, causal, max_err = main
    ms = time_ms(lambda: flash_attention(q, k, v, causal))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, causal))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    bound_ms, bound_by, flops, nbytes = attention_bound_ms(
        MAIN_SHAPE, causal, MAIN_DTYPE)
    print(f"kernel flash_attn_fwd {MAIN_SHAPE} causal {MAIN_DTYPE}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (scaled_dot_product_attention) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops / 1e9:.3f} GFLOP at {PEAK_FLOPS[MAIN_DTYPE] / 1e12:.0f} "
          f"TFLOP/s f32 non-tensor peak; {nbytes / 1e6:.2f} MB at "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s); kernel at "
          f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    return {"name": "flash_attn_fwd", "route": "cuda",
            "source": "singa_tpu_torch/ops/csrc/flash_attn_fwd.cu",
            "replaces": "singa_tpu/ops/pallas_kernels.py:494",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_serve(entry):
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
    entry["launches"] = launches
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
        entry = phase_kernel()
        phase_serve(entry)
    except Exception as e:  # noqa: BLE001 -- any phase failing fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k, val in entry.items():
        if isinstance(val, float) and not math.isfinite(val):
            print(f"chip_smoke: {k} is not finite", file=sys.stderr)
            return 1
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
