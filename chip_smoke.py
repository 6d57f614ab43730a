#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. probe — a CUDA device is required; print the card's
   ``nvidia-smi`` name and power limit; TF32 off for matmul and cuDNN.
2. build — compile the kernels from this checkout's sources: the two
   CUDA libraries (``flash_fwd.cu``: K1; ``flash_bwd.cu``: K2 and K3)
   with one ``nvcc`` each, started together, into ``.torch_kernels/``;
   Triton compiles K4 at first launch.  Print the build seconds.
3. kernel parity — each kernel against its plain PyTorch version on the
   card at the shapes the served and the training paths give it, with
   the stated tolerance; kernel, plain and library times; the bound.
4. serving path — the flagship TransformerLM (V 32000, D 1024, 8 heads,
   8 layers, max_len 1024; random weights from a seeded generator)
   served in bf16 by the port's ``InferenceServer``: a batch of four
   512-token prompts, then four 200-token prompts, 32 new tokens each.
   Every status OK, every id in 1..V, the launch counts per batch
   exactly 8 flash (one per layer in the prefill) and (2*8+1)*32 = 544
   LayerNorm; the last-prompt-position logits of one prompt held
   against the same model run in f32 on the CPU.
5. training path — the same flagship trained by the port's
   ``LocalOptimizer``: ``TimeDistributedCriterion(CrossEntropyCriterion(),
   True)``, SGD at lr 0.01, bf16 compute over f32 master weights, 8
   iterations over one batch of 16 int32 sequences of 1024 ids.  Every
   loss finite, no step skipped, the last loss below the first,
   launches per step exactly K1 8, K2 8, K3 8, K4 17; the same 8 steps
   in f32 on the card give the same first loss and the same decreases
   L_k - L_1; a 2-layer copy at full width trained 3 steps in f32 on the
   card and on the CPU gives the same losses, decreases and parameter
   updates.  Step ms, tokens/s, MFU and peak memory.
6. a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

The full record goes to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --profile

runs phases 1-2, then profiles the served generator of phase 4 and one
training step of phase 5 with ``torch.profiler`` (device time by
kernel, launches, the device's busy share) into
``chiprun_out/chip_profile.json``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()

# H100 SXM data-sheet peaks (dense) and memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12

FLAGSHIP = dict(vocab=32000, embed_dim=1024, num_heads=8, num_layers=8,
                max_len=1024)
BATCH, MAX_NEW, PROMPT_LENS = 4, 32, (512, 200)

# tolerances, kernel vs its plain version on the same inputs.
# K1-K3 are held row by row (row_rel_err): under causal masking the
# rows' scales spread over three orders of magnitude (row i of O and dQ
# averages i + 1 keys; the last key rows of dK and dV see few queries),
# so a limit set against the largest value of a tensor would not see a
# wrong last tile.  bf16: P (and dS) round to bf16 after the running max
# (kernel) or the final max (plain), a 2^-9 relative difference per
# weight, and each output rounds to bf16, where the two f32 results may
# land on neighbouring values (1 ulp is 2^-8 to 2^-7 of the value).
# The limits sit just above the readings at the shapes of phase 3
# (PERF.md).  f32: summation order only.  K4 bf16 (absolute): the f32
# results agree to ~1e-6 and may round to neighbouring bf16 values,
# 1 ulp = 2^-5 for |y| in [4, 8); its rows all have one scale.
ROW_TOL = {"bfloat16": 7e-3, "float32": 1e-4}
TOL = {("layer_norm_fwd", "bfloat16"): 4e-2,
       ("layer_norm_fwd", "float32"): 1e-4}
LSE_TOL = 1e-3
# a row whose norm is below this share of the largest row's (keys that no
# query sees, gradients that vanish in exact arithmetic) is held to an
# absolute limit of ROW_TOL times that floor
ROW_FLOOR = 1e-4
# last-position logits, bf16 on the card vs f32 on the CPU, relative to
# the largest |logit|: bf16 activations carry ~2^-8 relative error
# through 8 residual blocks
LOGITS_REL_TOL = 5e-2
# training.  At random init every loss is about ln V whatever the
# network computes, so the losses alone prove little: what the backward
# decides is how far each step moves the loss, and where it moves the
# parameters.  bf16 vs f32 on the card, 8 steps: the first loss, and each
# decrease L_k - L_1 relative to the f32 one (bf16 activations and
# gradients through 8 blocks).  f32 card vs CPU, 2 layers, 3 steps: the
# losses, each decrease, and every parameter's update p_3 - p_0 row by
# row (row_rel_err) — summation order, and the f32 storage of the
# parameters: one f32 ulp of a loss near 10.5 is 9e-8 of it and 3e-5 of
# a decrease of 0.03, and an embedding row's update of ~1e-6 per element
# on weights near 0.03 (ulp 1.9e-9) reads ~2e-3 from rounding alone.
# Each limit sits a few times above its reading (PERF.md).
TRAIN_FIRST_REL_TOL = 5e-6
TRAIN_DECREASE_REL_TOL = 5e-2
TRAJ_RTOL = 1e-6
TRAJ_DECREASE_REL_TOL = 2e-4
TRAJ_UPDATE_ROW_TOL = 1e-2
TRAIN_BATCH, TRAIN_T, TRAIN_ITERS, TRAIN_LR = 16, 1024, 8, 0.01
SMALL_LAYERS, SMALL_T, SMALL_BATCH, SMALL_ITERS = 2, 256, 2, 3


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


def max_row_norm(torch, t) -> float:
    return torch.linalg.vector_norm(t.float(), dim=-1).max().item()


def row_rel_err(torch, got, ref, scale=None) -> float:
    """The worst row's relative error: for each row of the last dim,
    ||got - ref|| / (||ref|| + ROW_FLOOR * scale) in f32.  ``scale``
    defaults to ref's largest row norm; rows zero on both sides read 0."""
    d = torch.linalg.vector_norm(got.float() - ref.float(), dim=-1)
    r = torch.linalg.vector_norm(ref.float(), dim=-1)
    if scale is None:
        scale = r.max().item()
    return (d / (r + ROW_FLOOR * scale)).max().item()


def bound(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def flash_cases(torch):
    """(label, B, H, T, S, D, dtype, causal): the served prefill, the
    training step, the 200-token batch, causal T > S, f32, and narrower
    heads."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("served", 4, 8, 512, 512, 128, bf16, True),
            ("train", 16, 8, 1024, 1024, 128, bf16, True),
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
        row_err = row_rel_err(torch, o, o_ref)
        lse_err = (lse - lse_ref).abs().max().item()
        dname = str(dt).split(".")[-1]
        tol = ROW_TOL[dname]
        ok = row_err <= tol and lse_err <= LSE_TOL and bool(
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
                         causal=causal, max_abs_err=err, row_rel_err=row_err,
                         lse_err=lse_err, tol=tol, ok=ok, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"K1 flash_fwd {label:>20} {dname:>8} row err {row_err:.3e} "
              f"(tol {tol:g}) max abs err {err:.3e} lse_err {lse_err:.3e} "
              f"| kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms sdpa {lib_ms} ms bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}) {'OK' if ok else 'FAIL'}")
    return rows


def check_layer_norm(torch, F):
    from bigdl_tpu_torch.ops import layer_norm as ln

    rows = []
    for label, R, Fdim, dt in (("served_prefill", 2048, 1024, torch.bfloat16),
                               ("train", 16384, 1024, torch.bfloat16),
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


def launch_counters():
    """Every kernel's launch counter, by the kernel's name."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import layer_norm as ln

    return {c.name: c for c in (fa.LAUNCHES, fa.LAUNCHES_DKV,
                                fa.LAUNCHES_DQ, ln.LAUNCHES)}


def bwd_cases(torch):
    """(label, B, H, T, S, D, dtype, causal) for K2/K3: the training
    step, a ragged T, causal T > S and S > T, f32, narrower heads."""
    bf16, f32 = torch.bfloat16, torch.float32
    return [("train", 16, 8, 1024, 1024, 128, bf16, True),
            ("ragged_T200", 4, 8, 200, 200, 128, bf16, True),
            ("causal_T>S", 2, 8, 300, 200, 128, bf16, True),
            ("causal_S>T", 2, 8, 200, 300, 64, bf16, True),
            ("f32_causal", 2, 8, 512, 512, 128, f32, True),
            ("f32_noncausal_D64", 2, 4, 200, 333, 64, f32, False),
            ("bf16_noncausal_D32", 2, 4, 96, 130, 32, bf16, False)]


def check_flash_bwd(torch, F):
    """K2 and K3 against ``_flash_bwd_plain`` on the same (q, k, v, O,
    LSE, dO), O and LSE from K1.  Times: each kernel alone (graph
    replay), the whole plain backward, and the backward of one
    ``scaled_dot_product_attention`` call (``torch.autograd.grad`` only,
    CUDA events around 10 calls)."""
    from bigdl_tpu_torch.ops import flash_attention as fa

    rows = []
    for label, B, H, T, S, D, dt, causal in bwd_cases(torch):
        g = torch.Generator(device="cuda").manual_seed(13)
        q = torch.randn(B, H, T, D, device="cuda", generator=g).to(dt)
        k = torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
        v = torch.randn(B, H, S, D, device="cuda", generator=g).to(dt)
        d_o = torch.randn(B, H, T, D, device="cuda", generator=g).to(dt)
        scale = 1.0 / math.sqrt(D)
        o, lse = fa._flash_cuda(q, k, v, causal, scale)
        do, delta = fa._bwd_inputs(q, o, d_o)
        dk, dv = fa._launch_dkv(q, k, v, do, lse, delta, causal, scale)
        dq = fa._launch_dq(q, k, v, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        dq_ref, dk_ref, dv_ref = fa._flash_bwd_plain(q, k, v, o, lse, d_o,
                                                     causal, scale)
        dname = str(dt).split(".")[-1]
        tol = ROW_TOL[dname]
        outs = (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))
        # one scale for the three: at T = S = 1 dq and dk vanish in exact
        # arithmetic and both sides hold rounding noise
        scale = max(max_row_norm(torch, b) for _, _, b in outs)
        rel = {n: row_rel_err(torch, a, b, scale) for n, a, b in outs}
        err = {n: (a.float() - b.float()).abs().max().item()
               for n, a, b in outs}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (dq, dk, dv))
        ok = finite and max(rel.values()) <= tol
        big = B * H * T * S >= 1 << 26
        ms_dkv = cuda_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                                causal, scale))
        ms_dq = cuda_ms(lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                              causal, scale))
        plain_ms = cuda_ms(lambda: fa._flash_bwd_plain(
            q, k, v, o, lse, d_o, causal, scale),
            iters=5 if big else 20, reps=3 if big else 5)
        lib_ms = None
        if T == S:
            qs, ks, vs = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=causal)
            grad = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), d_o,
                                               retain_graph=True)
            for _ in range(3):
                grad()
            lib_ms = _event_ms(lambda: [grad() for _ in range(10)], 10)
            del o_lib
        pairs = sum(min(S, t + 1) for t in range(T)) if causal else T * S
        item = q.element_size()
        BH = B * H
        stats = 8 * BH * T
        b_dkv, by_dkv = bound(item * (2 * BH * T * D + 4 * BH * S * D)
                              + stats, 8.0 * BH * pairs * D, dname)
        b_dq, by_dq = bound(item * (3 * BH * T * D + 2 * BH * S * D)
                            + stats, 6.0 * BH * pairs * D, dname)
        rows.append(dict(
            case=label, shape=[B, H, T, S, D], dtype=dname, causal=causal,
            row_rel_err=rel, max_abs_err=err, tol=tol, ok=ok,
            plain_ms=plain_ms, library_ms=lib_ms,
            dkv=dict(ms=ms_dkv, bound_ms=b_dkv, bound_by=by_dkv,
                     max_abs_err=max(err["dk"], err["dv"])),
            dq=dict(ms=ms_dq, bound_ms=b_dq, bound_by=by_dq,
                    max_abs_err=err["dq"])))
        print(f"K2/K3 flash_bwd {label:>18} {dname:>8} row err dq "
              f"{rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol "
              f"{tol:g}) | K2 {ms_dkv:.4f} ms (bound {b_dkv:.4f}, {by_dkv}) "
              f"K3 {ms_dq:.4f} ms (bound {b_dq:.4f}, {by_dq}) plain "
              f"{plain_ms:.4f} ms sdpa bwd {lib_ms} ms "
              f"{'OK' if ok else 'FAIL'}")
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
    counters = launch_counters()

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
            for c in counters.values():
                c.reset()
            futs = [server.submit_generate(p, MAX_NEW) for p in prompts]
            results = [f.result(timeout=600) for f in futs]
            n_flash, n_ln = fa.LAUNCHES.count, ln.LAUNCHES.count
            n_bwd = fa.LAUNCHES_DKV.count + fa.LAUNCHES_DQ.count
            statuses = [r.status.value for r in results]
            outs = [np.asarray(r.output) for r in results
                    if r.status is Status.OK]
            ids_ok = len(outs) == BATCH and all(
                o.shape == (MAX_NEW,) and o.min() >= 1 and o.max() <= V
                for o in outs)
            want_ln = (2 * L + 1) * MAX_NEW
            batch = dict(prompt_len=T0, statuses=statuses,
                         launches={n: c.count for n, c in counters.items()},
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
            if n_flash != L or n_ln != want_ln or n_bwd:
                failures.append(f"prompt {T0}: launches flash {n_flash} "
                                f"ln {n_ln} backward {n_bwd}, want {L} / "
                                f"{want_ln} / 0")
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


def _lm(torch, device, num_layers):
    from bigdl_tpu_torch.models.transformer import TransformerLM

    cfg = FLAGSHIP
    return TransformerLM(cfg["vocab"], embed_dim=cfg["embed_dim"],
                         num_heads=cfg["num_heads"], num_layers=num_layers,
                         max_len=cfg["max_len"], seq_strategy="flash",
                         output="logits", device=device,
                         generator=torch.Generator().manual_seed(0))


def _lm_data(B: int, T: int):
    """B samples of T int32 ids in 1..V, inputs then targets, from
    ``numpy.random.RandomState(0)``."""
    import numpy as np

    from bigdl_tpu_torch.dataset import Sample, array

    V = FLAGSHIP["vocab"]
    rng = np.random.RandomState(0)
    x = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    y = rng.randint(1, V + 1, size=(B, T)).astype(np.int32)
    return array([Sample(a, b) for a, b in zip(x, y)])


def make_trainer(torch, model, B, T, iters, compute_dtype, on_check=None):
    """The port's LocalOptimizer over one batch of B sequences, SGD at
    ``TRAIN_LR``, stopping after ``iters`` iterations; ``on_check(state)``
    runs each time the loop evaluates its end trigger (before the first
    iteration and after each)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    def check(state):
        if on_check is not None:
            on_check(state)
        return state["neval"] > iters

    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), True)
    opt = LocalOptimizer(model, _lm_data(B, T), crit, batch_size=B)
    opt.set_optim_method(SGD(TRAIN_LR)).set_end_when(Trigger(check))
    if compute_dtype is not None:
        opt.set_compute_dtype(compute_dtype)
    return opt


def run_training(torch, model, B, T, iters, compute_dtype, updates=False):
    """Train and record, at each end-trigger check: the host clock, the
    state's loss and every launch count.  Each iteration ends in the
    loss read-back, a device sync, so consecutive clocks bound one
    whole step.  With ``updates``, also each parameter's whole update
    (final minus initial value, on the CPU)."""
    from bigdl_tpu_torch.utils.rng import RNG

    counters = launch_counters()
    marks = []

    def mark(state):
        marks.append((time.perf_counter(), state.get("loss"),
                      {n: c.count for n, c in counters.items()}))

    opt = make_trainer(torch, model, B, T, iters, compute_dtype, mark)
    start = ({n: p.detach().clone() for n, p in model.named_parameters()}
             if updates else {})
    RNG().set_seed(1)
    for c in counters.values():
        c.reset()
    opt.optimize()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    losses = [m[1] for m in marks[1:]]
    step_s = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    per_step = [{n: b[2][n] - a[2][n] for n in b[2]}
                for a, b in zip(marks, marks[1:])]
    return dict(losses=losses, step_s=step_s, launches_per_step=per_step,
                launches={n: c.count for n, c in counters.items()},
                skipped_steps=opt.skipped_steps,
                updates={n: (p.detach() - start[n]).cpu()
                         for n, p in model.named_parameters() if n in start})


def decrease_rel_err(got, ref) -> float:
    """The worst step's relative error in the loss decrease: over k > 1,
    |(got_k - got_1) - (ref_k - ref_1)| / |ref_k - ref_1|."""
    return max(abs((g - got[0]) - (r - ref[0])) / abs(r - ref[0])
               for g, r in zip(got[1:], ref[1:]))


def train_flagship(torch):
    """Phase 5: the port's LocalOptimizer trains the flagship."""
    cfg = FLAGSHIP
    L, Dm = cfg["num_layers"], cfg["embed_dim"]
    B, T = TRAIN_BATCH, TRAIN_T
    failures = []

    model = _lm(torch, "cuda", L)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bf16 = run_training(torch, model, B, T, TRAIN_ITERS, torch.bfloat16)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    losses = bf16["losses"]
    want = {"flash_fwd": L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
            "layer_norm_fwd": 2 * L + 1}
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(x)
                                             for x in losses):
        failures.append(f"training losses {losses}")
    if bf16["skipped_steps"]:
        failures.append(f"{bf16['skipped_steps']} training steps skipped")
    if not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    bad = [s for s in bf16["launches_per_step"] if s != want]
    if bad:
        failures.append(f"launches per step {bad[0]}, want {want}")
    # iterations 3-8: host clock between loop iterations, each ending in
    # the loss read-back (a device sync)
    steady = bf16["step_s"][2:]
    step_ms = 1e3 * sum(steady) / len(steady)
    tokens_per_s = B * T / (step_ms / 1e3)
    attn_flops_per_token = 6.0 * T * Dm * L   # bench.py's convention
    mfu_6nd = 6.0 * n_params * tokens_per_s / PEAK_FLOPS["bfloat16"]
    mfu = ((6.0 * n_params + attn_flops_per_token) * tokens_per_s
           / PEAK_FLOPS["bfloat16"])
    print(f"training path: bf16, B {B} T {T}: losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{bf16['launches_per_step'][0]}; step {step_ms:.2f} ms "
          f"(iterations 3-{TRAIN_ITERS}), {tokens_per_s:.0f} tokens/s, MFU "
          f"{mfu:.4f} (6ND only {mfu_6nd:.4f}), peak memory "
          f"{peak_gb:.2f} GB")

    # the same 8 steps in f32 on the card, same weights and batch
    f32 = run_training(torch, _lm(torch, "cuda", L), B, T, TRAIN_ITERS, None)
    torch.cuda.empty_cache()
    ref = f32["losses"]
    first_rel = abs(losses[0] - ref[0]) / abs(ref[0])
    dec_rel = decrease_rel_err(losses, ref)
    print(f"training path: bf16 vs f32 on the card: first loss "
          f"{losses[0]:.6f} vs {ref[0]:.6f}, rel {first_rel:.3e} (tol "
          f"{TRAIN_FIRST_REL_TOL}); decreases L_k - L_1 "
          f"{[round(x - losses[0], 6) for x in losses[1:]]} vs "
          f"{[round(x - ref[0], 6) for x in ref[1:]]}, worst rel "
          f"{dec_rel:.3e} (tol {TRAIN_DECREASE_REL_TOL})")
    if len(ref) != TRAIN_ITERS or not first_rel <= TRAIN_FIRST_REL_TOL:
        failures.append(f"first loss bf16 vs f32 rel {first_rel:.3e}")
    if not dec_rel <= TRAIN_DECREASE_REL_TOL:
        failures.append(f"loss decreases bf16 vs f32 rel {dec_rel:.3e}")

    # a 2-layer copy at full width in f32: the card against the CPU
    small = {dev: run_training(torch, _lm(torch, dev, SMALL_LAYERS),
                               SMALL_BATCH, SMALL_T, SMALL_ITERS, None,
                               updates=True)
             for dev in ("cuda", "cpu")}
    card, cpu = small["cuda"]["losses"], small["cpu"]["losses"]
    traj_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    traj_dec_rel = decrease_rel_err(card, cpu)
    got, want = small["cuda"]["updates"], small["cpu"]["updates"]
    scale = max(max_row_norm(torch, u) for u in want.values())
    upd_err = {n: row_rel_err(torch, got[n], u, scale)
               for n, u in want.items()}
    worst = max(upd_err, key=upd_err.get)
    print(f"training path: 2-layer f32 losses card {card} cpu {cpu}: max "
          f"rel {traj_rel:.3e} (rtol {TRAJ_RTOL}), decreases worst rel "
          f"{traj_dec_rel:.3e} (tol {TRAJ_DECREASE_REL_TOL}); updates "
          f"p_{SMALL_ITERS} - p_0 of {len(want)} parameters, worst row err "
          f"{upd_err[worst]:.3e} in {worst} (tol {TRAJ_UPDATE_ROW_TOL})")
    if len(card) != SMALL_ITERS or not traj_rel <= TRAJ_RTOL:
        failures.append(f"2-layer f32 card vs cpu: {card} vs {cpu}")
    if not traj_dec_rel <= TRAJ_DECREASE_REL_TOL:
        failures.append(f"2-layer f32 loss decreases card vs cpu rel "
                        f"{traj_dec_rel:.3e}")
    if not upd_err[worst] <= TRAJ_UPDATE_ROW_TOL:
        failures.append(f"2-layer f32 updates card vs cpu: {worst} row err "
                        f"{upd_err[worst]:.3e}")
    if small["cuda"]["launches"]["flash_bwd_dq"] != SMALL_LAYERS * SMALL_ITERS:
        failures.append(f"2-layer card run launches "
                        f"{small['cuda']['launches']}")
    return dict(
        n_params=n_params, batch=B, seq_len=T, lr=TRAIN_LR,
        losses=losses, step_s=bf16["step_s"],
        launches_per_step=bf16["launches_per_step"][0],
        launches=bf16["launches"], skipped_steps=bf16["skipped_steps"],
        step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu,
        mfu_6nd=mfu_6nd, peak_memory_gb=peak_gb,
        timing="host clock between loop iterations 3-8, each ending in "
               "the loss read-back (a device sync)",
        f32_losses=ref, bf16_vs_f32_first_rel=first_rel,
        bf16_vs_f32_decrease_rel=dec_rel,
        small_f32=dict(layers=SMALL_LAYERS, batch=SMALL_BATCH, seq_len=SMALL_T,
                       card_losses=card, cpu_losses=cpu, max_rel=traj_rel,
                       decrease_rel=traj_dec_rel, update_row_err=upd_err)
    ), failures


def _kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "K1 flash_fwd"
    if "flash_bwd_dkv" in name:
        return "K2 flash_bwd_dkv"
    if "flash_bwd_dq" in name:
        return "K3 flash_bwd_dq"
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
    report = {}
    for label, n in (("prefill", 1), ("generate", MAX_NEW)):
        def run():
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen(params, prompts, n)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        run()
        report[label] = dict(new_tokens=n, **profile_window(torch, run))
        print_profile(f"profile {label} ({n} new tokens, batch {BATCH}, "
                      f"prompt {PROMPT_LENS[0]})", report[label])
    return report


def profile_window(torch, run):
    """Wall (min of 3 runs of ``run`` without the profiler), then one run
    under ``torch.profiler``: device time by kernel and by group,
    launches, and the device's busy share of that wall."""
    from torch.profiler import ProfilerActivity, profile

    cuda_type = torch.autograd.DeviceType.CUDA
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
    return dict(
        wall_ms=wall_s * 1e3, device_ms=device_ms,
        busy_share=device_ms / (wall_s * 1e3) if device_ms else None,
        launches=sum(c for _, c in by_kernel.values()),
        groups={k: dict(ms=v[0], launches=v[1]) for k, v in groups.items()},
        top_kernels=[dict(name=k[:120], ms=v[0], launches=v[1])
                     for k, v in top])


def print_profile(title: str, rep: dict):
    busy = (f"{rep['busy_share']:.4f}" if rep["device_ms"]
            else "not measured (no device time in the trace)")
    print(f"{title}: wall {rep['wall_ms']:.3f} ms, device "
          f"{rep['device_ms']:.3f} ms, busy share {busy}, "
          f"{rep['launches']} launches")
    for k, v in sorted(rep["groups"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {k:>48}: {v['ms']:9.3f} ms  {v['launches']:6d} launches")
    for t in rep["top_kernels"]:
        print(f"    {t['ms']:9.3f} ms {t['launches']:6d}x  {t['name'][:100]}")


def profile_training(torch):
    """``--profile``: one bf16 training step of phase 5 (B 16, T 1024)
    under ``torch.profiler``, after two warm iterations; each timed run
    is one more iteration of the same LocalOptimizer."""
    model = _lm(torch, "cuda", FLAGSHIP["num_layers"])
    opt = make_trainer(torch, model, TRAIN_BATCH, TRAIN_T, 2, torch.bfloat16)
    opt.optimize()

    def run():
        state = opt.optim_method.state
        opt.set_end_when(lambda s, last=state["neval"]: s["neval"] > last)
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    rep = profile_window(torch, run)
    print_profile(f"profile training step (bf16, batch {TRAIN_BATCH}, "
                  f"T {TRAIN_T})", rep)
    return rep


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the build, profile the served generator "
                         "and one training step instead of phases 3-6")
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

    # phase 2: build — both CUDA libraries at once, then Triton's K4
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import layer_norm as ln

    t0 = time.perf_counter()
    _support.load_cuda_libraries("flash_fwd", "flash_bwd")
    cuda_build_s = time.perf_counter() - t0
    for lib in ("flash_fwd", "flash_bwd"):
        for line in _support.BUILD_INFO[lib][1].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {lib}: {line.strip()}")
    t0 = time.perf_counter()
    x = torch.ones(4, 1024, device="cuda", dtype=torch.bfloat16)
    ln._layer_norm_cuda(x, x[0], x[0], 1e-5)
    torch.cuda.synchronize()
    triton_build_s = time.perf_counter() - t0
    print(f"build: flash_fwd.cu + flash_bwd.cu (nvcc, sm_90a, in parallel) "
          f"{cuda_build_s:.1f} s (each: "
          f"{ {k: round(v[0], 1) for k, v in _support.BUILD_INFO.items()} }"
          f") -> {_support.BUILD_DIR}; layer_norm (triton, first launch) "
          f"{triton_build_s:.1f} s")

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.profile:
        report = dict(served=profile_served(torch),
                      training_step=profile_training(torch))
        (out / "chip_profile.json").write_text(json.dumps(dict(
            device=kind, nvidia_smi=smi, torch=torch.__version__,
            profile=report), indent=1))
        print(smi)
        return 0

    # phase 3: kernel parity
    flash_rows = check_flash(torch, F)
    ln_rows = check_layer_norm(torch, F)
    bwd_rows = check_flash_bwd(torch, F)
    failures = [f"K1 {r['case']}: row err {r['row_rel_err']:.3e} lse "
                f"{r['lse_err']:.3e}" for r in flash_rows if not r["ok"]]
    failures += [f"K4 {r['case']}: err {r['max_abs_err']:.3e}"
                 for r in ln_rows if not r["ok"]]
    failures += [f"K2/K3 {r['case']}: row err {r['row_rel_err']}"
                 for r in bwd_rows if not r["ok"]]

    # phase 4: the serving path
    served, path_failures = serve_flagship(torch)
    failures += path_failures

    # phase 5: the training path
    trained, train_failures = train_flagship(torch)
    failures += train_failures

    # launches summed over both paths, each read from zero
    launches = {n: sum(b["launches"][n] for b in served["batches"])
                + trained["launches"][n] for n in launch_counters()}
    rows = {"flash_fwd": dict(flash_rows[0]),
            "layer_norm_fwd": dict(ln_rows[0]),
            "flash_bwd_dkv": dict(bwd_rows[0], **bwd_rows[0]["dkv"]),
            "flash_bwd_dq": dict(bwd_rows[0], **bwd_rows[0]["dq"])}
    kernels = []
    for name, route, source, replaces in (
            ("flash_fwd", "cuda", "bigdl_tpu_torch/ops/csrc/flash_fwd.cu",
             "bigdl_tpu/ops/flash_attention.py:150"),
            ("flash_bwd_dkv", "cuda", "bigdl_tpu_torch/ops/csrc/flash_bwd.cu",
             "bigdl_tpu/ops/flash_attention.py:236"),
            ("flash_bwd_dq", "cuda", "bigdl_tpu_torch/ops/csrc/flash_bwd.cu",
             "bigdl_tpu/ops/flash_attention.py:271"),
            ("layer_norm_fwd", "triton", "bigdl_tpu_torch/ops/layer_norm.py",
             "bigdl_tpu/ops/layer_norm.py:25")):
        row = rows[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"]))
        if launches[name] == 0:
            failures.append(f"{name} was never launched on the main paths")

    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=kind, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, cuda_build_s=cuda_build_s,
        build_s={k: v[0] for k, v in _support.BUILD_INFO.items()},
        triton_build_s=triton_build_s, flash=flash_rows, layer_norm=ln_rows,
        flash_bwd=bwd_rows, serving_path=served, training_path=trained,
        kernels=kernels, failures=failures, seconds=time.perf_counter()
        - T_START), indent=1))

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
