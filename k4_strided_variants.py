#!/usr/bin/env python3
"""K4 on a transposed activation, on one GPU.

    python3 k4_strided_variants.py

``Sequential(Transpose([(2, 3)]), LayerNorm(1024))`` hands K4 the view
[B, T, F] of a [B, F, T] tensor: its features are T apart.  This times,
at ``chip_smoke.py`` phase 11 (c)'s shape (B 16, F 1024, T 1024) in
bf16 and f32, by CUDA-graph replay (``chip_smoke.cuda_ms``):

* ``strided``: the shipped route, ``_ln_fwd_strided_kernel`` on the view
  (one row a program, the row-pitched kernel's arithmetic);
* ``copy route``: the route it replaced, a copy, then the row-pitched K4;
* ``copy`` and ``contiguous``: that route's two parts;
* ``rows R``: R adjacent rows a program, each row as ``strided`` does it
  (the same sums in the same order), so a 32-byte sector read for one
  row may serve the next ones from L1;
* ``tile R``: an [R, F] tile a program, loaded along the unit-stride T
  axis, each row's sums over the tile's layout (another order).

Each is held bit for bit against the row-pitched K4 on the contiguous
input (what phase 11 (c) asks) and against the plain version, at the
shape above and at two small ones (ragged rows and features).  The
variants exist only here; the package ships ``strided``.
"""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_strided_variants.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import layer_norm as ln

    ln._triton_kernel()
    triton, tl = ln.triton, ln.tl

    @triton.jit
    def rows_kernel(x_ptr, g_ptr, b_ptr, o_ptr, F, inner, s_outer, s_inner,
                    s_col, eps, R: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        nb = tl.cdiv(inner, R)
        o = pid // nb
        j0 = (pid % nb) * R
        cols = tl.arange(0, BLOCK)
        cm = cols < F
        g = tl.load(g_ptr + cols, mask=cm, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=cm, other=0.0).to(tl.float32)
        for i in tl.static_range(R):
            j = j0 + i
            mask = cm & (j < inner)
            x = tl.load(x_ptr + o * s_outer + j * s_inner
                        + cols.to(tl.int64) * s_col, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / F
            centered = tl.where(mask, x - mean, 0.0)
            var = tl.sum(centered * centered, axis=0) / F
            inv = 1.0 / tl.sqrt(var + eps)
            tl.store(o_ptr + (o * inner + j) * F + cols,
                     (centered * inv * g + b).to(o_ptr.dtype.element_ty),
                     mask=mask)

    @triton.jit
    def tile_kernel(x_ptr, g_ptr, b_ptr, o_ptr, F, inner, s_outer, s_inner,
                    s_col, eps, R: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0).to(tl.int64)
        nb = tl.cdiv(inner, R)
        o = pid // nb
        j = (pid % nb) * R + tl.arange(0, R)
        cols = tl.arange(0, BLOCK)
        cm = cols < F
        m2 = (j < inner)[:, None] & cm[None, :]
        x = tl.load(x_ptr + o * s_outer + j[:, None] * s_inner
                    + cols[None, :].to(tl.int64) * s_col, mask=m2,
                    other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / F
        centered = tl.where(m2, x - mean[:, None], 0.0)
        var = tl.sum(centered * centered, axis=1) / F
        inv = 1.0 / tl.sqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=cm, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=cm, other=0.0).to(tl.float32)
        y = centered * inv[:, None] * g[None, :] + b[None, :]
        tl.store(o_ptr + (o * inner + j[:, None]) * F + cols[None, :],
                 y.to(o_ptr.dtype.element_ty), mask=m2)

    def launch(kern, xv, g, b, R):
        B, T, F = xv.shape
        out = torch.empty(xv.shape, dtype=xv.dtype, device=xv.device)
        block = 1 << (F - 1).bit_length()
        kern[(B * triton.cdiv(T, R),)](
            xv, g, b, out, F, T, *xv.stride(), 1e-5, R=R, BLOCK=block,
            num_warps=min(max(block // 256, 1), 16))
        return out

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for B, F, T in ((16, 1024, 1024), (3, 96, 40), (2, 768, 50)):
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn(B, F, T, device="cuda", generator=gen).to(dt)
            g = (1 + 0.1 * torch.randn(F, device="cuda",
                                       generator=gen)).to(dt)
            b = (0.1 * torch.randn(F, device="cuda", generator=gen)).to(dt)
            xv = x.transpose(1, 2)
            xc = xv.contiguous()
            want = ln._layer_norm_cuda(xc, g, b, 1e-5)
            plain = ln._layer_norm_plain(xv, g, b, 1e-5).float()
            runs = {
                "strided": lambda: ln._layer_norm_cuda(xv, g, b, 1e-5),
                "copy route": lambda: ln._layer_norm_cuda(
                    xv.contiguous(), g, b, 1e-5),
                "copy": lambda: xv.contiguous(),
                "contiguous": lambda: ln._layer_norm_cuda(xc, g, b, 1e-5)}
            for R in (4, 16):
                runs[f"rows {R}"] = (
                    lambda R=R: launch(rows_kernel, xv, g, b, R))
            for R in (8, 16):
                runs[f"tile {R}"] = (
                    lambda R=R: launch(tile_kernel, xv, g, b, R))
            timed = B == 16
            for name, fn in runs.items():
                y = fn()
                torch.cuda.synchronize()
                check = "" if name == "copy" else (
                    f" bit for bit {bool(torch.equal(y, want))} err vs "
                    f"plain {(y.float() - plain).abs().max().item():.3e}")
                ms = f"{cs.cuda_ms(fn):.4f} ms" if timed else "not timed"
                print(f"[{B}, {T}, {F}] {str(dt)[6:]:>8} {name:>11}: "
                      f"{ms}{check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
