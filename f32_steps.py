#!/usr/bin/env python3
"""The f32 training steps of ``chip_smoke.py``'s phases 5, 6 and 8, the
f32 forward (K1, K6), dK/dV (K2, K7) and dQ (K3, K8) launches at each
LM step's shape, K5 in f32 at ResNet-50's four stage shapes, the f32
attention kernels at head dims 192 and 256 and the attention kernels
above 256 in both dtypes, on one GPU.

    python3 f32_steps.py [CHECKOUT]

runs the port package of CHECKOUT (default: this one) with this
checkout's ``chip_smoke.py`` helpers, so two checkouts (a parent and a
change) are measured the same way: the flagship TransformerLM trained 8
f32 steps at T 1024, B 16 (phase 5) and, block-sparse, at T 4096, B 4
(phase 6), the step time over iterations 3-8 and the operand copies and
kernel launches of a step; then K1-K3 (flash) or K6-K8 (block-sparse,
the flagship's mask) alone at that step's layer shape (8 heads of 128),
by CUDA-graph replay.  Then ResNet-50 trained 8 f32 steps at B 64 on
``"pallas"`` (phase 8's f32 run: step time, K5 launches a step) and the
wrapper's K5 call (forward, and dX on the flipped weights) alone at the
four stage shapes; then K1-K3 and K6-K8 in f32 at head dims 192 and 256
(B 2, H 8, T 1024, causal; K6-K8 under phase 3's sliding window 2 + 1
global at block 128), each pass on the route the checkout gives it (the
Hopper bodies' split products, or the wide route where a checkout has
one and no Hopper kernel for it), with the wide launches each makes;
then the forward and backward above head dim 256 in bf16 and f32 (K1-K3
and K6-K8 at D 320 and 512, the same shape and mask) on the checkout's
route (the chunked kernels, or the wide route of a checkout that has
one), with the wide launches of each, and the backward of one
``scaled_dot_product_attention`` call (with the elementwise mask for
K7/K8) on the same inputs.  Prints a line per leg and, last, the JSON
record.  Run parent, change, change, parent in one call to compare two
versions.
"""
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    repo = Path(argv[0] if argv else HERE).resolve()
    import torch

    if not torch.cuda.is_available():
        print("f32_steps: a CUDA card is required", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bigdl_tpu_torch.ops import _support, conv3x3
    from bigdl_tpu_torch.ops import block_sparse as bs
    from bigdl_tpu_torch.ops import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(repo):
        print(f"f32_steps: {fa.__file__} is not {repo}'s", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a checkout that has the wide route builds it at its first launch
    _support.load_cuda_libraries("flash_fwd", "flash_bwd", "block_sparse",
                                 "conv3x3")
    L, heads = cs.FLAGSHIP["num_layers"], cs.FLAGSHIP["num_heads"]
    D = cs.FLAGSHIP["embed_dim"] // heads
    out = {}
    for name, B, T, kw in (("phase5", cs.TRAIN_BATCH, cs.TRAIN_T, {}),
                           ("phase6", cs.BS_BATCH, cs.BS_T,
                            dict(max_len=cs.BS_T, seq_strategy="blocksparse",
                                 blocksparse=cs.BS_CFG))):
        run = cs.run_training(torch, cs._lm(torch, "cuda", L, **kw), B, T,
                              cs.TRAIN_ITERS, None)
        torch.cuda.empty_cache()
        steady = run["step_s"][2:]
        g = torch.Generator(device="cuda").manual_seed(5)
        q, k, v, d_o = (torch.randn(B, heads, T, D, device="cuda",
                                    generator=g) for _ in range(4))
        scale = 1 / math.sqrt(D)
        if kw:
            block = cs.BS_CFG["block"]
            mask = bs.sliding_window_mask(T // block, T // block,
                                          cs.BS_CFG["window"],
                                          cs.BS_CFG["globals"], True, block,
                                          block)
            def fwd():
                return bs._bs_fwd_cuda(q, k, v, mask, True, scale)

            o, lse = fwd()
            do, delta = fa._bwd_inputs(q, o, d_o)

            def dkv():
                return bs._launch_bs_dkv(q, k, v, do, lse, delta, mask, True,
                                         scale)

            def dq():
                return bs._launch_bs_dq(q, k, v, do, lse, delta, mask, True,
                                        scale)
        else:
            def fwd():
                return fa._flash_cuda(q, k, v, True, scale)

            o, lse = fwd()
            do, delta = fa._bwd_inputs(q, o, d_o)

            def dkv():
                return fa._launch_dkv(q, k, v, do, lse, delta, True, scale)

            def dq():
                return fa._launch_dq(q, k, v, do, lse, delta, True, scale)
        per_step = run["launches_per_step"][0]
        out[name] = dict(batch=B, seq_len=T,
                         step_ms=1e3 * sum(steady) / len(steady),
                         step_s=run["step_s"], losses=run["losses"],
                         launches_per_step=per_step,
                         operand_copies=per_step["attn_operand_copies"],
                         fwd_ms=cs.cuda_ms(fwd, iters=3, reps=2),
                         dkv_ms=cs.cuda_ms(dkv, iters=3, reps=2),
                         dq_ms=cs.cuda_ms(dq, iters=3, reps=2))
        print(f"{repo} {name}: f32 step {out[name]['step_ms']:.2f} ms "
              f"(iterations 3-{cs.TRAIN_ITERS}, B {B}, T {T}), operand "
              f"copies {out[name]['operand_copies']} a step; at its shape "
              f"forward {out[name]['fwd_ms']:.4f} ms, dK/dV "
              f"{out[name]['dkv_ms']:.4f} ms, dQ {out[name]['dq_ms']:.4f} "
              f"ms", flush=True)
        del q, k, v, d_o, o, lse, do, delta
        torch.cuda.empty_cache()
    out["phase8"] = resnet_leg(torch, cs, conv3x3, repo)
    out["wide"] = wide_leg(torch, cs, fa, bs, repo)
    out["above_256"] = above_256_leg(torch, cs, fa, bs, repo)
    print(json.dumps(dict(checkout=str(repo),
                          device=torch.cuda.get_device_name(0), **out)))
    return 0


def resnet_leg(torch, cs, conv3x3, repo):
    """Phase 8's f32 run (ResNet-50, B 64, 8 steps on "pallas") and the
    K5 call at the four stage shapes, forward and dX."""
    B = cs.RESNET_BATCH
    _, run = cs._train_resnet(torch, "cuda", "pallas", B, cs.TRAIN_ITERS,
                              None)
    torch.cuda.empty_cache()
    steady = run["step_s"][2:]
    rec = dict(batch=B, step_ms=1e3 * sum(steady) / len(steady),
               step_s=run["step_s"], losses=run["losses"],
               k5_launches_per_step=run["launches_per_step"][0]["conv3x3"],
               k5={})
    print(f"{repo} phase8: f32 step {rec['step_ms']:.2f} ms (iterations "
          f"3-{cs.TRAIN_ITERS}, B {B}), K5 {rec['k5_launches_per_step']} a "
          f"step", flush=True)
    for label, b, h, w, c, o, dt in cs.conv_cases(torch):
        if dt != torch.float32 or not label.startswith("stage"):
            continue
        g = torch.Generator(device="cuda").manual_seed(29)
        x = torch.randn(b, h, w, c, device="cuda", generator=g)
        wt = torch.randn(3, 3, c, o, device="cuda", generator=g) / (
            3 * math.sqrt(c))
        gy = torch.randn(b, h, w, o, device="cuda", generator=g)
        wk = wt.permute(0, 1, 3, 2).contiguous()
        wk_dx = wt.flip(0, 1).contiguous()
        rec["k5"][label] = dict(
            ms=cs.cuda_ms(lambda: conv3x3._conv3x3_cuda(x, wk)),
            dx_ms=cs.cuda_ms(lambda: conv3x3._conv3x3_cuda(gy, wk_dx)))
        print(f"{repo} K5 {label}: the wrapper's call {rec['k5'][label]['ms']:.4f}"
              f" ms, dX {rec['k5'][label]['dx_ms']:.4f} ms", flush=True)
        del x, wt, gy, wk, wk_dx
        torch.cuda.empty_cache()
    return rec


def wide_launches(fa) -> int:
    """The wide route's launches so far: 0 on a checkout without it."""
    counter = getattr(fa, "LAUNCHES_WIDE", None)
    return 0 if counter is None else counter.count


def wide_leg(torch, cs, fa, bs, repo):
    """K1, K2 and K3, then K6, K7 and K8 (phase 3's window 2 + 1 global at
    block 128), in f32 at head dims 192 and 256 (B 2, H 8, T 1024,
    causal), and the wide launches of each pass."""
    rec = {}
    mask = bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)
    for D in (192, 256):
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, d_o = (torch.randn(2, 8, 1024, D, device="cuda",
                                    generator=g) for _ in range(4))
        scale = 1 / math.sqrt(D)
        for name, fwd, dkv, dq in (
                ("flash", lambda: fa._flash_cuda(q, k, v, True, scale),
                 fa._launch_dkv, fa._launch_dq),
                ("block_sparse",
                 lambda: bs._bs_fwd_cuda(q, k, v, mask, True, scale),
                 lambda *a: bs._launch_bs_dkv(*a[:6], mask, *a[6:]),
                 lambda *a: bs._launch_bs_dq(*a[:6], mask, *a[6:]))):
            wide = wide_launches(fa)
            o, lse = fwd()
            wide_fwd = wide_launches(fa) - wide
            do, delta = fa._bwd_inputs(q, o, d_o)
            args = (q, k, v, do, lse, delta, True, scale)
            dkv(*args)
            dq(*args)
            rec[f"{name}_D{D}"] = dict(
                wide_launches=dict(fwd=wide_fwd, bwd=wide_launches(fa)
                                   - wide - wide_fwd),
                fwd_ms=cs.cuda_ms(fwd, iters=3, reps=2),
                dkv_ms=cs.cuda_ms(lambda: dkv(*args), iters=3, reps=2),
                dq_ms=cs.cuda_ms(lambda: dq(*args), iters=3, reps=2))
            print(f"{repo} f32 {name} D {D}: {rec[f'{name}_D{D}']}",
                  flush=True)
            del o, lse, do, delta
        del q, k, v, d_o
        torch.cuda.empty_cache()
    return rec


def above_256_leg(torch, cs, fa, bs, repo):
    """K1-K3 and K6-K8 (phase 3's window 2 + 1 global at block 128) at head
    dims 320 and 512, in bf16 and f32 (B 2, H 8, T 1024, causal), each
    pass on the route the checkout gives it (the chunked kernels, or the
    wide route of a checkout that has one), with the wide launches of the
    forward and of the backward (K2/K3, K7/K8 on the forward's O and
    LSE); beside them the backward of one ``scaled_dot_product_attention``
    call on the same inputs (``chip_smoke.sdpa_bwd_ms``; for K7/K8 with
    the elementwise mask)."""
    import torch.nn.functional as F

    rec = {}
    mask = bs.sliding_window_mask(8, 8, 2, 1, True, 128, 128)
    keep = bs._elementwise_keep(mask, True, "cuda")
    for dt in (torch.bfloat16, torch.float32):
        for D in (320, 512):
            g = torch.Generator(device="cuda").manual_seed(7)
            q, k, v, d_o = (torch.randn(2, 8, 1024, D, device="cuda",
                                        generator=g).to(dt) for _ in range(4))
            scale = 1 / math.sqrt(D)
            for name in ("flash", "block_sparse"):
                if name == "flash":
                    def fwd():
                        return fa._flash_cuda(q, k, v, True, scale)
                    dkv, dq = fa._launch_dkv, fa._launch_dq
                    sdpa_kw = dict(is_causal=True)
                else:
                    def fwd():
                        return bs._bs_fwd_cuda(q, k, v, mask, True, scale)

                    def dkv(*a):
                        return bs._launch_bs_dkv(*a[:6], mask, *a[6:])

                    def dq(*a):
                        return bs._launch_bs_dq(*a[:6], mask, *a[6:])
                    sdpa_kw = dict(attn_mask=keep)
                wide = wide_launches(fa)
                o, lse = fwd()
                wide = wide_launches(fa) - wide
                # the wide route takes milliseconds a call
                it = dict(iters=3, reps=2) if wide else dict(iters=20, reps=5)
                key = f"{name}_{str(dt)[6:]}_D{D}"
                rec[key] = dict(wide_launches=wide, fwd_ms=cs.cuda_ms(fwd, **it))
                do, delta = fa._bwd_inputs(q, o, d_o)
                args = (q, k, v, do, lse, delta, True, scale)
                wide = wide_launches(fa)
                dkv(*args)
                dq(*args)
                wide = wide_launches(fa) - wide
                it = dict(iters=3, reps=2) if wide else dict(iters=10, reps=5)
                sdpa_ms, backend = cs.sdpa_bwd_ms(torch, F, q, k, v, d_o,
                                                  **sdpa_kw)
                rec[key].update(
                    bwd_wide_launches=wide,
                    dkv_ms=cs.cuda_ms(lambda: dkv(*args), **it),
                    dq_ms=cs.cuda_ms(lambda: dq(*args), **it),
                    sdpa_bwd_ms=sdpa_ms, sdpa_backend=backend)
                print(f"{repo} {key}: {rec[key]}", flush=True)
                del o, lse, do, delta
            del q, k, v, d_o
            torch.cuda.empty_cache()
    return rec


if __name__ == "__main__":
    sys.exit(main())
