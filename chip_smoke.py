#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card — the quickest proof that the port builds, agrees with itself and
serves at full width.

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. card: name and power limit, torch and CUDA versions; TF32 off
  2. build: every kernel of ``src/repro_torch/csrc`` with nvcc, in parallel
  3. each kernel against its plain PyTorch version at the serve path's
     shapes (bf16, rtol=atol=2e-2), with kernel / plain / library / bound ms
  4. serve tinyllama-1.1b at full width (random bf16 weights from a seed)
     from a 4-partition requests topic: 16 requests, batch 8, prompt 256,
     64 new tokens; every kernel must have launched
  5. full-width numerics: a 2-layer model at tinyllama's widths, kernel
     path on the card against the plain path on the CPU, same weights
  6. one JSON line of kernel records, then the final JSON status line

Exits non-zero, with no result line, without a CUDA card or outside a
checkout of the repository. Imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = dict(rtol=2e-2, atol=2e-2)          # bf16, as the JAX kernel tests
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12                         # outside the tensor cores


def phase(n: int, title: str) -> None:
    print(f"== {n}. {title}", flush=True)


def require(ok: bool, what: str) -> None:
    """A check that fails the phase (and survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def bound_ms(nbytes: float, flops: float, flop_rate: float
             ) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Median device time of one call, by CUDA events around each call,
    with L2 scrubbed before each call (a 256 MiB write > the 50 MB L2)."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.scrub = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = 20) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
        for s, e in zip(starts, ends):
            self.scrub.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e)
                                 for s, e in zip(starts, ends))


def to_cpu(tree: dict) -> dict:
    return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import configs
        from repro_torch.kernels import (WRAPPERS, _build, launch_counts,
                                         reset_launch_counts)
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.core import ConsumerGroup, PartitionedLog
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_plain
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_plain
    from repro_torch.kernels.rmsnorm.kernel import fused_residual_rmsnorm
    from repro_torch.kernels.rmsnorm.ref import fused_residual_rmsnorm_plain
    from repro_torch.launch.serve import enqueue_requests
    from repro_torch.models import Model
    from repro_torch.runtime import ServeConfig, Server

    # -- 1. card ----------------------------------------------------------------
    phase(1, "card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 off for matmul and cuDNN")

    # -- 2. build ----------------------------------------------------------------
    phase(2, "build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.3f} s "
          "(one nvcc per source, in parallel)")
    for name, b in sorted(built.items()):
        for line in b.ptxas:
            print(f"  {name}: {line}")

    # -- 3. kernels against their plain versions ----------------------------------
    phase(3, f"kernels vs plain versions {card}")
    timer = Timer(torch)
    gen = torch.Generator("cuda").manual_seed(0)
    bf16 = torch.bfloat16
    eb = 2                                         # bytes per bf16 element

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def check(label, out, ref, kernel, plain, library, nbytes, flops, rate):
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(outs, refs))
        for o, r in zip(outs, refs):
            torch.testing.assert_close(o.float(), r.float(), **TOL)
        rec = {"max_abs_err": err, "ms": timer(kernel),
               "plain_ms": timer(plain),
               "library_ms": None if library is None else timer(library)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, rate)
        lib = ("n/a" if rec["library_ms"] is None
               else f"{rec['library_ms']:.6f}")
        print(f"  {label}: max|err| {err:.3e} (tol {TOL}); device ms per "
              f"call, L2 cold: kernel {rec['ms']:.6f}, plain "
              f"{rec['plain_ms']:.6f}, library {lib}, bound "
              f"{rec['bound_ms']:.6f} ({rec['bound_by']})", flush=True)
        return rec

    records = {}
    eps = 1e-5
    for rows in (8, 2048):
        d = 2048
        x, r = randn(rows, d), randn(rows, d)
        scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
                 ).to(bf16)
        for res in (r, None):
            nbytes = eb * (rows * d * (4 if res is not None else 2) + d)
            rec = check(
                f"fused_residual_rmsnorm ({rows}, {d}) bf16 "
                f"{'with' if res is not None else 'without'} residual",
                fused_residual_rmsnorm(x, res, scale, eps),
                fused_residual_rmsnorm_plain(x, res, scale, eps),
                lambda: fused_residual_rmsnorm(x, res, scale, eps),
                lambda: fused_residual_rmsnorm_plain(x, res, scale, eps),
                None if res is not None
                else (lambda: F.rms_norm(x, (d,), scale, eps)),
                nbytes, 6.0 * rows * d, FP32_FLOPS)
            if rows == 8 and res is not None:       # the decode path's call
                rec["shape"] = f"({rows}, {d}) bf16 with residual"
                records["fused_residual_rmsnorm"] = rec

    for s in (256, 200):
        b, hq, hkv, dh = 8, 32, 4, 64
        q = randn(b, s, hq, dh).transpose(1, 2)        # the model's layout
        k = randn(b, s, hkv, dh).transpose(1, 2)
        v = randn(b, s, hkv, dh).transpose(1, 2)
        pairs = s * (s + 1) // 2
        rec = check(
            f"flash_attention q (8, 32, {s}, 64), kv (8, 4, {s}, 64) bf16 "
            "causal, (B,S,H,d) strides",
            flash_attention(q, k, v, causal=True),
            attention_plain(q, k, v, causal=True),
            lambda: flash_attention(q, k, v, causal=True),
            lambda: attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True),
            eb * (2 * q.numel() + k.numel() + v.numel()),
            4.0 * b * hq * dh * pairs, BF16_TENSOR_FLOPS)
        if s == 256:
            rec["shape"] = "q (8, 32, 256, 64), kv (8, 4, 256, 64) bf16 causal"
            records["flash_attention"] = rec

    b, hq, hkv, dh, smax = 8, 32, 4, 64, 320
    # serving decodes at pos 256..319 (prompt 256, 64 new tokens): the
    # record is taken mid-range; the other positions are checks only
    serve_pos = 256 + 64 // 2
    kc = randn(b, smax, hkv, dh).transpose(1, 2)       # the model's cache
    vc = randn(b, smax, hkv, dh).transpose(1, 2)
    q = randn(b, 1, hq, dh).transpose(1, 2)
    for p in (0, smax // 2, serve_pos, smax - 1):
        pos = torch.tensor([p], dtype=torch.int32, device="cuda")
        mask = (torch.arange(smax, device="cuda") <= p)[None, None, None]
        rec = check(
            f"decode_attention q (8, 32, 1, 64), cache (8, {smax}, 4, 64) "
            f"bf16, pos={p}",
            decode_attention(q, kc, vc, pos), decode_plain(q, kc, vc, pos),
            lambda: decode_attention(q, kc, vc, pos),
            lambda: decode_plain(q, kc, vc, pos),
            lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                                   enable_gqa=True),
            eb * (2 * q.numel() + 2 * b * hkv * (p + 1) * dh),
            4.0 * b * hq * dh * (p + 1), BF16_TENSOR_FLOPS)
        if p == serve_pos:
            rec["shape"] = (f"q (8, 32, 1, 64), cache (8, {smax}, 4, 64) "
                            f"bf16, pos={p}")
            records["decode_attention"] = rec

    # -- 4. serve at full width ----------------------------------------------------
    phase(4, f"serve {card}")
    cfg = configs.get("tinyllama-1.1b")
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), "cuda")
    print(f"  model {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_count()} params, {cfg.dtype}")
    n_req, scfg = 16, ServeConfig(batch_size=8, prompt_len=256,
                                  max_new_tokens=64)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log = PartitionedLog(Path(tmp) / "log")
        enqueue_requests(log, n_req)
        server = Server(model, params,
                        ConsumerGroup(log, "requests", "servers")
                        .add_member("srv0"), log, scfg, device="cuda")
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while server.serve_once():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        done = [json.loads(r.value)
                for p in range(log.num_partitions("completions"))
                for r in log.read("completions", p, 0, 1000)]
        log.close()
    print(f"  launch counts in the serve run: {counts}")
    ids = {d["id"] for d in done}
    require(ids == {str(i) for i in range(n_req)}, f"completions {ids}")
    for d in done:
        toks = d["completion_ids"]
        require(len(toks) == scfg.max_new_tokens
                and all(0 <= t < cfg.vocab_size for t in toks), f"bad {d}")
    for name, n in counts.items():
        require(n > 0, f"{name} never launched on the main path")
    for name in records:
        records[name]["launches"] = counts[name]
    gen_tokens = n_req * scfg.max_new_tokens
    print(f"  {card} served {len(done)} requests x {scfg.max_new_tokens} "
          f"tokens in {wall:.6f} s wall (first batch includes warm-up): "
          f"{gen_tokens / wall:.3f} generated tokens/s end to end")

    toks = torch.randint(0, 256, (scfg.batch_size, scfg.prompt_len),
                         generator=gen, device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, toks, max_len=server.max_len)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        cur = logits.argmax(-1, keepdim=True).to(torch.int32)
        n_steps = 48
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = model.decode_step(params, cache, cur)
            cur = logits.argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
        prof_steps = 8
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_steps):
                logits, cache = model.decode_step(params, cache, cur)
                cur = logits.argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
    prefill_ms = 1e3 * statistics.median(pre)
    print(f"  {card} batch {scfg.batch_size}, prompt {scfg.prompt_len}: "
          f"prefill {prefill_ms:.6f} ms (median of 3), decode "
          f"{step_ms:.6f} ms/step (mean of {n_steps}), model-only "
          f"{scfg.batch_size * 1e3 / step_ms:.3f} generated tokens/s")
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / prof_steps
    if dev_ms > 0:
        print(f"  {card} decode step: {dev_ms:.6f} ms of device time per "
              f"step (profiler, {prof_steps} steps) in a {step_ms:.6f} ms "
              f"step -> device busy {dev_ms / step_ms:.4f}, idle "
              f"{1 - dev_ms / step_ms:.4f}; top kernels per step:")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / 1e3 / prof_steps:.6f} ms"
                  f"  x{e.count // prof_steps}  {e.key[:90]}")
    else:
        print("  decode step device busy share: not measured (the profiler "
              "recorded no device time)")

    # -- 5. full-width numerics -------------------------------------------------------
    phase(5, f"logits {card}")
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    m2 = Model(cfg2)
    p2 = m2.init(torch.Generator("cuda").manual_seed(1), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device="cuda", dtype=torch.int32)
    with torch.inference_mode():
        got, _ = m2(p2, tokens)
        want, _ = m2(to_cpu(p2), tokens.cpu())
    got = got.float().cpu()
    want = want.float()
    require(got.shape == (2, 64, cfg.vocab_size)
            and bool(torch.isfinite(got).all()), "logits not finite")
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"  2-layer full-width logits {tuple(got.shape)}: kernel path on "
          f"the card vs plain path on the CPU, max|err| {err:.4e} vs "
          f"max|logit| {top:.4e} (tolerance 0.05 x max|logit|), argmax "
          f"agreement {agree:.4f} (tolerance >= 0.98)")
    require(err <= 0.05 * top and agree >= 0.98, "logits out of tolerance")

    # -- 6. records and status -------------------------------------------------------
    srcs = {"fused_residual_rmsnorm": ("rmsnorm", "kernel.py:33"),
            "flash_attention": ("flash_attention", "kernel.py:77"),
            "decode_attention": ("decode_attention", "kernel.py:65")}
    out = []
    for w in WRAPPERS:
        src, line = srcs[w.__name__]
        rec = records[w.__name__]
        out.append({"name": w.__name__, "route": "cuda",
                    "source": f"src/repro_torch/csrc/{src}.cu",
                    "replaces": f"src/repro/kernels/{src}/{line}",
                    "launches": rec["launches"], "shape": rec["shape"],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
