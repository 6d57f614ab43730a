#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. probe — a CUDA device is required; print the card's
   ``nvidia-smi`` name and power limit; TF32 off for matmul and cuDNN.
2. build — compile the kernels from this checkout's sources (the CUDA
   library lands in ``.torch_kernels/``; Triton compiles at first
   launch) and print the build seconds.
3. kernel parity — each kernel against its plain PyTorch version on the
   card at the shapes the served path gives it, with the stated
   tolerance; kernel, plain and library times; the bound.
4. main path — the flagship TransformerLM (V 32000, D 1024, 8 heads,
   8 layers, max_len 1024; random weights from a seeded generator)
   served in bf16 by the port's ``InferenceServer``: a batch of four
   512-token prompts, then four 200-token prompts, 32 new tokens each.
   Every status OK, every id in 1..V, the launch counts per batch
   exactly 8 flash (one per layer in the prefill) and (2*8+1)*32 = 544
   LayerNorm; the last-prompt-position logits of one prompt held
   against the same model run in f32 on the CPU.
5. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

The full record goes to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --profile

runs phases 1-2, then profiles the served generator of phase 4 with
``torch.profiler`` (device time by kernel, launches, the device's busy
share) into ``chiprun_out/chip_profile.json``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense) and memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(vocab=32000, embed_dim=1024, num_heads=8, num_layers=8,
                max_len=1024)
BATCH, MAX_NEW, PROMPT_LENS = 4, 32, (512, 200)

# tolerances, kernel vs its plain version on the same inputs.  K1 bf16:
# P is rounded to bf16 after the running max (kernel) or the final max
# (plain) — a ~2^-8 relative difference per weight — and O is rounded to
# bf16 (|O| < 4: 1 ulp <= 2^-6).  K4 bf16: the f32 results agree to
# ~1e-6 and may round to neighbouring bf16 values, 1 ulp = 2^-5 for
# |y| in [4, 8).  f32: summation order only.
TOL = {("flash_fwd", "bfloat16"): 3e-2, ("flash_fwd", "float32"): 1e-4,
       ("layer_norm_fwd", "bfloat16"): 4e-2,
       ("layer_norm_fwd", "float32"): 1e-4}
LSE_TOL = 1e-3
# last-position logits, bf16 on the card vs f32 on the CPU, relative to
# the largest |logit|: bf16 activations carry ~2^-8 relative error
# through 8 residual blocks
LOGITS_REL_TOL = 5e-2


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def _event_ms(run, n: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def cuda_ms(fn, iters: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed ``reps`` times (CUDA events), so the host's
    launch cost is out of the measure.  Inputs stay warm in L2 between
    calls."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(lambda: [graph.replay() for _ in range(reps)],
                   iters * reps)
    del graph
    return ms


def bound(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def flash_cases(torch):
    """(label, B, H, T, S, D, dtype, causal): the served prefill, the
    200-token batch, causal T > S, f32, and narrower heads."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("served", 4, 8, 512, 512, 128, bf16, True),
            ("ragged_T200", 4, 8, 200, 200, 128, bf16, True),
            ("causal_T>S", 2, 8, 300, 200, 128, bf16, True),
            ("f32_causal", 2, 8, 512, 512, 128, f32, True),
            ("f32_noncausal_D64", 2, 4, 200, 333, 64, f32, False),
            ("bf16_noncausal_D32", 2, 4, 96, 130, 32, bf16, False),
            ("bf16_causal_T1_D16", 3, 2, 1, 1, 16, bf16, True)]


def check_flash(torch, F):
    from bigdl_tpu_torch.ops import flash_attention as fa

    rows = []
    for label, B, H, T, S, D, dt, causal in flash_cases(torch):
        g = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn(B, H, T, D, device="cuda", generator=g).to(dt)
        k = torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
        v = torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
        scale = 1.0 / math.sqrt(D)
        o, lse = fa._flash_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa._flash_plain(q, k, v, causal, scale)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        dname = str(dt).split(".")[-1]
        tol = TOL[("flash_fwd", dname)]
        ok = err <= tol and lse_err <= LSE_TOL and bool(
            torch.isfinite(o.float()).all())
        ms = cuda_ms(lambda: fa._flash_cuda(q, k, v, causal, scale))
        plain_ms = cuda_ms(lambda: fa._flash_plain(q, k, v, causal, scale))
        lib_ms = None
        if T == S:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
        pairs = sum(min(S, t + 1) for t in range(T)) if causal else T * S
        item = q.element_size()
        nbytes = item * (2 * B * H * T * D + 2 * B * H * S * D) + 4 * B * H * T
        bound_ms, bound_by = bound(nbytes, 4.0 * B * H * pairs * D, dname)
        rows.append(dict(case=label, shape=[B, H, T, S, D], dtype=dname,
                         causal=causal, max_abs_err=err, lse_err=lse_err,
                         tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K1 flash_fwd {label:>20} {dname:>8} err {err:.3e} "
              f"(tol {tol:g}) lse_err {lse_err:.3e} | kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms sdpa {lib_ms} ms bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}) {'OK' if ok else 'FAIL'}")
    return rows


def check_layer_norm(torch, F):
    from bigdl_tpu_torch.ops import layer_norm as ln

    rows = []
    for label, R, Fdim, dt in (("served_prefill", 2048, 1024, torch.bfloat16),
                               ("f32", 2048, 1024, torch.float32),
                               ("decode_step", 4, 1024, torch.bfloat16),
                               ("ragged_F", 300, 1000, torch.bfloat16)):
        g = torch.Generator(device="cuda").manual_seed(11)
        x = torch.randn(R, Fdim, device="cuda", generator=g).to(dt)
        gamma = (1 + 0.1 * torch.randn(Fdim, device="cuda", generator=g)).to(dt)
        beta = (0.1 * torch.randn(Fdim, device="cuda", generator=g)).to(dt)
        y = ln._layer_norm_cuda(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        y_ref = ln._layer_norm_plain(x, gamma, beta, 1e-5)
        err = (y.float() - y_ref.float()).abs().max().item()
        dname = str(dt).split(".")[-1]
        tol = TOL[("layer_norm_fwd", dname)]
        ok = err <= tol and bool(torch.isfinite(y.float()).all())
        ms = cuda_ms(lambda: ln._layer_norm_cuda(x, gamma, beta, 1e-5))
        plain_ms = cuda_ms(lambda: ln._layer_norm_plain(x, gamma, beta, 1e-5))
        lib_ms = cuda_ms(lambda: F.layer_norm(x, (Fdim,), gamma, beta, 1e-5))
        item = x.element_size()
        nbytes = item * (2 * R * Fdim + 2 * Fdim)
        # the kernel's arithmetic is f32 whatever x's dtype
        bound_ms, bound_by = bound(nbytes, 8.0 * R * Fdim, "float32")
        rows.append(dict(case=label, shape=[R, Fdim], dtype=dname,
                         max_abs_err=err, tol=tol, ok=ok, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K4 layer_norm {label:>15} {dname:>8} err {err:.3e} "
              f"(tol {tol:g}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"F.layer_norm {lib_ms:.4f} ms bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}) {'OK' if ok else 'FAIL'}")
    return rows


def serve_flagship(torch):
    """Phase 4: the port's InferenceServer at full flagship width."""
    import numpy as np

    from bigdl_tpu_torch.models.generate import cached_generate, last_logits
    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import layer_norm as ln
    from bigdl_tpu_torch.serving import InferenceServer, Status

    cfg = FLAGSHIP
    V, L = cfg["vocab"], cfg["num_layers"]

    def build(device):
        return TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                             num_heads=cfg["num_heads"], num_layers=L,
                             max_len=cfg["max_len"], device=device,
                             generator=torch.Generator().manual_seed(0))

    t0 = time.perf_counter()
    model = build("cuda")
    build_s = time.perf_counter() - t0
    server = InferenceServer(model, max_batch=BATCH,
                             generate_dtype=torch.bfloat16).start()
    rng = np.random.RandomState(0)
    batches, failures = [], []
    prompts_by_len = {}
    try:
        for T0 in PROMPT_LENS:
            prompts = rng.randint(1, V + 1, size=(BATCH, T0)).astype(np.int32)
            prompts_by_len[T0] = prompts
            fa.LAUNCHES.reset()
            ln.LAUNCHES.reset()
            futs = [server.submit_generate(p, MAX_NEW) for p in prompts]
            results = [f.result(timeout=600) for f in futs]
            n_flash, n_ln = fa.LAUNCHES.count, ln.LAUNCHES.count
            statuses = [r.status.value for r in results]
            outs = [np.asarray(r.output) for r in results
                    if r.status is Status.OK]
            ids_ok = len(outs) == BATCH and all(
                o.shape == (MAX_NEW,) and o.min() >= 1 and o.max() <= V
                for o in outs)
            want_ln = (2 * L + 1) * MAX_NEW
            batch = dict(prompt_len=T0, statuses=statuses,
                         flash_launches=n_flash, ln_launches=n_ln,
                         latency_s=[r.latency_s for r in results],
                         first_ids=[o[:8].tolist() for o in outs])
            batches.append(batch)
            print(f"main path: prompt {T0}: statuses {statuses} flash "
                  f"{n_flash} (want {L}) layer_norm {n_ln} (want {want_ln}) "
                  f"latency {max(batch['latency_s']):.3f} s")
            if statuses != ["ok"] * BATCH:
                failures.append(f"prompt {T0}: statuses {statuses} "
                                f"{[r.error for r in results]}")
            if not ids_ok:
                failures.append(f"prompt {T0}: generated ids out of 1..{V}")
            if n_flash != L or n_ln != want_ln:
                failures.append(f"prompt {T0}: launches flash {n_flash} "
                                f"ln {n_ln}, want {L} / {want_ln}")
    finally:
        server.stop(timeout=60)

    # end-to-end timing of the served generator (the server's path):
    # prefill + first token alone, then the full 32-token generate
    gen = cached_generate(model, compute_dtype=torch.bfloat16)
    params = model.param_tree()
    timing = {}
    for T0, prompts in prompts_by_len.items():
        def run(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen(params, prompts, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run(MAX_NEW)  # warm
        prefill_s = min(run(1) for _ in range(3))
        full_s = min(run(MAX_NEW) for _ in range(3))
        tps = BATCH * (MAX_NEW - 1) / (full_s - prefill_s)
        timing[T0] = dict(prefill_s=prefill_s, generate_s=full_s,
                          decode_tokens_per_s=tps)
        print(f"main path: prompt {T0}: prefill+first token "
              f"{prefill_s * 1e3:.2f} ms, generate {full_s * 1e3:.2f} ms, "
              f"decode {tps:.1f} tokens/s (batch {BATCH})")

    # the last-prompt-position logits of one prompt: bf16 on the card vs
    # the same port model (same seed) in f32 on the CPU
    prompt = prompts_by_len[PROMPT_LENS[1]][:1]
    got = last_logits(model, prompt, compute_dtype=torch.bfloat16).cpu()
    ref_model = build("cpu")
    ref = last_logits(ref_model, prompt)
    err = (got - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    same_top1 = int(got.argmax()) == int(ref.argmax())
    print(f"main path: last-position logits bf16/cuda vs f32/cpu: max abs "
          f"err {err:.4e} ({rel:.3e} of max |logit|, tol {LOGITS_REL_TOL}); "
          f"top-1 agrees: {same_top1}")
    if not rel <= LOGITS_REL_TOL:
        failures.append(f"logits vs f32 CPU reference: rel err {rel:.3e}")
    return dict(model_build_s=build_s, batches=batches, timing=timing,
                logits_max_abs_err=err, logits_rel_err=rel,
                logits_top1_agrees=same_top1), failures


def _kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "K1 flash_fwd"
    if "_ln_fwd" in name:
        return "K4 layer_norm_fwd"
    if any(s in name.lower() for s in ("gemm", "gemv", "nvjet", "cutlass",
                                       "xmma", "sm90_")):
        return "matmul (cuBLAS)"
    return "other (elementwise, softmax, copies, sampling)"


def profile_served(torch):
    """``--profile``: the served generator of phase 4 (4 x 512-token
    prompts, bf16) under ``torch.profiler``, once for the prefill and
    first token alone and once for all 32 new tokens.  Device time by
    kernel and by group, launches, and the device's busy share of the
    wall time (wall taken without the profiler, min of 3)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.models.generate import cached_generate
    from bigdl_tpu_torch.models.transformer import TransformerLM

    cfg = FLAGSHIP
    model = TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                          num_heads=cfg["num_heads"],
                          num_layers=cfg["num_layers"],
                          max_len=cfg["max_len"], device="cuda",
                          generator=torch.Generator().manual_seed(0))
    gen = cached_generate(model, compute_dtype=torch.bfloat16)
    params = model.param_tree()
    prompts = np.random.RandomState(0).randint(
        1, cfg["vocab"] + 1, size=(BATCH, PROMPT_LENS[0])).astype(np.int32)
    cuda_type = torch.autograd.DeviceType.CUDA
    report = {}
    for label, n in (("prefill", 1), ("generate", MAX_NEW)):
        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen(params, prompts, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run()
        wall_s = min(run() for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type != cuda_type:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            by_kernel[e.key] = (us / 1e3, e.count)
        device_ms = sum(ms for ms, _ in by_kernel.values())
        groups = {}
        for name, (ms, count) in by_kernel.items():
            g = groups.setdefault(_kernel_group(name), [0.0, 0])
            g[0] += ms
            g[1] += count
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        report[label] = dict(
            new_tokens=n, wall_ms=wall_s * 1e3, device_ms=device_ms,
            busy_share=device_ms / (wall_s * 1e3) if device_ms else None,
            launches=sum(c for _, c in by_kernel.values()),
            groups={k: dict(ms=v[0], launches=v[1])
                    for k, v in groups.items()},
            top_kernels=[dict(name=k[:120], ms=v[0], launches=v[1])
                         for k, v in top])
        busy = (f"{device_ms / (wall_s * 1e3):.4f}" if device_ms
                else "not measured (no device time in the trace)")
        print(f"profile {label} ({n} new tokens, batch {BATCH}, prompt "
              f"{PROMPT_LENS[0]}): wall {wall_s * 1e3:.3f} ms, device "
              f"{device_ms:.3f} ms, busy share {busy}, "
              f"{report[label]['launches']} launches")
        for k, v in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {k:>48}: {v[0]:9.3f} ms  {v[1]:6d} launches")
        for k, (ms, count) in top:
            print(f"    {ms:9.3f} ms {count:6d}x  {k[:100]}")
    return report


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the build, profile the served generator "
                         "instead of phases 3-5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false; a CUDA card is "
                    "required")
    if not (REPO / "bigdl_tpu_torch" / "__init__.py").exists():
        return fail(f"bigdl_tpu_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import torch.nn.functional as F

    # phase 1: probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # phase 2: build
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import layer_norm as ln

    t0 = time.perf_counter()
    _support.load_cuda_library("flash_fwd")
    cuda_build_s = time.perf_counter() - t0
    for line in _support.BUILD_INFO["flash_fwd"][1].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    t0 = time.perf_counter()
    x = torch.ones(4, 1024, device="cuda", dtype=torch.bfloat16)
    ln._layer_norm_cuda(x, x[0], x[0], 1e-5)
    torch.cuda.synchronize()
    triton_build_s = time.perf_counter() - t0
    print(f"build: flash_fwd.cu (nvcc, sm_90a) {cuda_build_s:.1f} s -> "
          f"{_support.BUILD_DIR}; layer_norm (triton, first launch) "
          f"{triton_build_s:.1f} s")

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.profile:
        report = profile_served(torch)
        (out / "chip_profile.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, torch=torch.__version__,
            profile=report), indent=1))
        print(smi)
        return 0

    # phase 3: kernel parity
    flash_rows = check_flash(torch, F)
    ln_rows = check_layer_norm(torch, F)
    failures = [f"K1 {r['case']}: err {r['max_abs_err']:.3e} lse "
                f"{r['lse_err']:.3e}" for r in flash_rows if not r["ok"]]
    failures += [f"K4 {r['case']}: err {r['max_abs_err']:.3e}"
                 for r in ln_rows if not r["ok"]]

    # phase 4: the main path
    main_path, path_failures = serve_flagship(torch)
    failures += path_failures

    launches = {
        "flash_fwd": sum(b["flash_launches"] for b in main_path["batches"]),
        "layer_norm_fwd": sum(b["ln_launches"] for b in main_path["batches"]),
    }
    kernels = []
    for name, route, source, replaces, row in (
            ("flash_fwd", "cuda", "bigdl_tpu_torch/ops/csrc/flash_fwd.cu",
             "bigdl_tpu/ops/flash_attention.py:150", flash_rows[0]),
            ("layer_norm_fwd", "triton", "bigdl_tpu_torch/ops/layer_norm.py",
             "bigdl_tpu/ops/layer_norm.py:25", ln_rows[0])):
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
        if launches[name] == 0:
            failures.append(f"{name} was never launched on the main path")

    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=kind, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, cuda_build_s=cuda_build_s,
        triton_build_s=triton_build_s, flash=flash_rows, layer_norm=ln_rows,
        main_path=main_path, kernels=kernels, failures=failures), indent=1))

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
