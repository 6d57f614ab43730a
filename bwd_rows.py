#!/usr/bin/env python3
"""The f32 dQ's hardest rows at phase 3's inputs, against the exact
value, on one GPU.

    python3 bwd_rows.py [--variants]

At ``chip_smoke.py``'s phase-3 inputs for the f32 K3 (B 2, H 8, T 1024,
causal, generator seed 13; head dims 192 and 256) runs the f32 dQ
(``_launch_dq``: the Hopper dQ block on split products), the plain f32
backward (``_flash_bwd_plain``) and the exact value: the same math in
f64 on the same O, LSE and delta (the f32 delta the kernel is given).
Prints K2's and K3's times (CUDA-graph replay), phase 3's dQ measure
(``chip_smoke.dq_row_err``) of the kernel against the f32 plain version
and against the exact value, and for the rows the first reads worst:
the row, its live keys, its two largest P, |dQ|, and how far the kernel
and the f32 plain version each lie from the exact value.  A row where
dS = P (dP - delta) cancels holds the rounding of dP, in either
version, times the cancellation.

With ``--variants`` the same for a build of ``flash_bwd.cu`` whose score
products (K2's and K3's) take a fresh partial per 32-column panel
instead of per k16 step (the first design; a text patch of
``attn_bwd_hopper.cuh``, built with ``nvcc`` into the git-ignored
``.torch_kernels/variants/``), on the same rows.  Prints a line per row
and, last, the JSON record.
"""
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: the first design: a fresh partial per 32-column panel of the scores
PANEL = [("wide_scores<D, kWideRows, true>", "wide_scores<D, kWideRows, false>"),
         ("wide_scores<D, KH, true>", "wide_scores<D, KH, false>")]


def build_panel_variant(_support):
    """flash_bwd.cu beside a patched attn_bwd_hopper.cuh (its quoted
    include finds it first), built and loaded."""
    src = (_support.CSRC / "attn_bwd_hopper.cuh").read_text()
    for old, new in PANEL:
        if old not in src:
            raise RuntimeError(f"attn_bwd_hopper.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    out = _support.BUILD_DIR / "variants" / "k3_panel_partials"
    out.mkdir(parents=True, exist_ok=True)
    (out / "attn_bwd_hopper.cuh").write_text(src)
    cu, so = out / "flash_bwd.cu", out / "libflash_bwd.so"
    cu.write_text((_support.CSRC / "flash_bwd.cu").read_text())
    proc = subprocess.run([_support._nvcc(), *_support.NVCC_FLAGS, "-I",
                           str(_support.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("bwd_rows: a CUDA card is required", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    _support.load_cuda_libraries("flash_fwd", "flash_bwd")
    builds = {"shipped": None}
    if "--variants" in argv:
        builds["panel_partials"] = build_panel_variant(_support)
    shipped_fn = fa._c_fn

    def use(lib):
        def c_fn(name, fn_name, argtypes):
            if name != "flash_bwd" or lib is None:
                return shipped_fn(name, fn_name, argtypes)
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            return fn
        fa._c_fn = c_fn

    def norm(t):
        return torch.linalg.vector_norm(t.double(), dim=-1)

    rec = dict(device=torch.cuda.get_device_name(0), head_dims={})
    for D in (192, 256):
        g = torch.Generator(device="cuda").manual_seed(13)
        q, k, v, d_o = (torch.randn(2, 8, 1024, D, device="cuda",
                                    generator=g) for _ in range(4))
        scale = 1 / math.sqrt(D)
        o, lse = fa._flash_cuda(q, k, v, True, scale)
        do, delta = fa._bwd_inputs(q, o, d_o)
        keep = fa._causal_keep(1024, 1024, "cuda")
        plain = fa._flash_bwd_plain(q, k, v, o, lse, d_o, True, scale)
        big = max(cs.max_row_norm(torch, t) for t in plain)
        s = q.double() @ k.double().transpose(-1, -2) * scale
        p = torch.exp(s.masked_fill(~keep, float("-inf"))
                      - lse.double().reshape(2, 8, 1024, 1))
        dp = d_o.double() @ v.double().transpose(-1, -2)
        exact = (p * (dp - delta.double().reshape(2, 8, 1024, 1))
                 ) @ k.double() * scale
        del s, dp
        runs, rows = {}, None
        for name, lib in builds.items():
            use(lib)
            dq = fa._launch_dq(q, k, v, do, lse, delta, True, scale)
            torch.cuda.synchronize()
            if rows is None:   # the shipped build's worst rows, one key excluded
                r = norm(dq - plain[0]) / (norm(plain[0]) + cs.ROW_FLOOR * big)
                r[..., keep.sum(dim=-1) == 1] = 0
                rows = [divmod(int(i), 1024) for i in
                        torch.topk(r.flatten(), 3).indices]
                rows = [(bh // 8, bh % 8, t) for bh, t in rows]
            runs[name] = dict(
                dkv_ms=cs.cuda_ms(lambda: fa._launch_dkv(
                    q, k, v, do, lse, delta, True, scale), iters=5, reps=3),
                dq_ms=cs.cuda_ms(lambda: fa._launch_dq(
                    q, k, v, do, lse, delta, True, scale), iters=5, reps=3),
                vs_plain=cs.dq_row_err(torch, dq, plain[0], keep, k, v, d_o,
                                       scale, big),
                vs_exact=cs.dq_row_err(torch, dq, exact, keep, k, v, d_o,
                                       scale, big),
                rows=[dict(row=[b, h, t],
                           kernel_from_exact=norm(dq[b, h, t]
                                                  - exact[b, h, t]).item())
                      for b, h, t in rows])
        use(None)
        info = []
        for b, h, t in rows:
            pr = p[b, h, t, :t + 1].sort(descending=True).values[:2].tolist()
            info.append(dict(row=[b, h, t], live_keys=t + 1, top_p=pr,
                             dq_norm=norm(exact[b, h, t]).item(),
                             plain_from_exact=norm(plain[0][b, h, t]
                                                   - exact[b, h, t]).item()))
        rec["head_dims"][D] = dict(rows=info, builds=runs)
        for name, run in runs.items():
            print(f"D {D} {name}: phase 3's dQ measure against the f32 plain "
                  f"version {run['vs_plain']:.3e}, against the exact value "
                  f"{run['vs_exact']:.3e}; K2 {run['dkv_ms']:.4f} ms, K3 "
                  f"{run['dq_ms']:.4f} ms", flush=True)
        for i, row in enumerate(info):
            print(f"  row {tuple(row['row'])}: {row['live_keys']} live keys, "
                  f"P {row['top_p'][0]:.4f} {row['top_p'][-1]:.4f}, |dQ| "
                  f"{row['dq_norm']:.3e}; from the exact value: plain f32 "
                  f"{row['plain_from_exact']:.3e}, "
                  + ", ".join(f"{n} {r['rows'][i]['kernel_from_exact']:.3e}"
                              for n, r in runs.items()), flush=True)
        del q, k, v, d_o, o, lse, do, delta, plain, p, exact
        torch.cuda.empty_cache()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
