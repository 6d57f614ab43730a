#!/usr/bin/env python3
"""Where K9's Hopper route spends its time, on one GPU.

    python3 k9_variants.py [--f32 | --routes CHECKOUT]

Builds ``bigdl_tpu_torch/ops/csrc/block_sparse.cu`` as it stands and
variants of it, each a text patch of the source that leaves one part of
K9's bf16 kernel out or changes its tile order (one ``nvcc`` each, all
started together, into the git-ignored ``.torch_kernels/variants/``):

* ``no_products``: the consumers wait for and release every stage but
  issue no wgmma, so the TMA loads and stores alone remain;
* ``no_stores``: the epilogue stages its tile but issues no TMA store;
* ``no_products_no_stores``: the loads alone;
* ``m_fastest``: M tiles vary fastest over the grid instead of N tiles.

Then it times each at the flagship MLP shape of ``chip_smoke.py`` phase 7
(x 16384 x 1024, W 1024 x 4096, block 128, density 0.5, bf16), forward
and dX (W read in place), by CUDA-graph replay (``chip_smoke.cuda_ms``),
the unpatched build first and last.  A variant's output is wrong by
construction; the unpatched build is held against the plain version.

With ``--f32`` it does the same for the f32 route (split products) at
the same shape in f32: the plans (KC, BN) the route is built for, 32 or
16 by 128 or 64, on the shipped build (each forward and dX, the split of
W into its pieces included), the variants ``f32_no_products`` (the
consumers split the x boxes and add their partials but issue no wgmma)
and ``f32_stages_3`` (a ring of three stages), the tile route, the split
of W alone and ``matmul(x, W∘mask)``.

With ``--routes CHECKOUT`` it times K9 of CHECKOUT's package (default:
this one) at the same shape, forward and dX, in bf16 and in f32, on the
route that checkout gives each, the f32 tile route and
``matmul(x, W∘mask)`` in both dtypes beside them: run parent, change,
change, parent in one call to compare two versions.

Prints the times, a JSON line of them (also written to
``chiprun_out/k9_variants[_f32|_routes].json``) and the card's name and
power limit; exits non-zero without a CUDA device.
"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

PRODUCTS = "if (live) {\n        const unsigned char* a = a_wg"
STORES = ("if (threadIdx.x % 128 == 0) {\n#pragma unroll\n"
          "        for (int p = 0; p < P::NP; ++p)\n          tma_store_2d")
ORDER = ("const int m0 = (blockIdx.x / n_tiles) * kMmRows;\n"
         "  const int n0 = (blockIdx.x % n_tiles) * BN;")
NO_PRODUCTS = (PRODUCTS, PRODUCTS.replace("if (live)", "if (false)"))
NO_STORES = (STORES, STORES.replace("threadIdx.x % 128 == 0", "false"))
M_FASTEST = (ORDER, "const int m_tiles = gridDim.x / n_tiles;\n"
                    "  const int m0 = (blockIdx.x % m_tiles) * kMmRows;\n"
                    "  const int n0 = (blockIdx.x / m_tiles) * BN;")
VARIANTS = {"no_products": [NO_PRODUCTS], "no_stores": [NO_STORES],
            "no_products_no_stores": [NO_PRODUCTS, NO_STORES],
            "m_fastest": [M_FASTEST]}
# the f32 route's (bs_mm_kernel_split's) parts
F32_PRODUCTS = ("wgmma_split_products<PW, KMAJ ? 0 : 1, RB, kSteps, PIECE, "
                "KSTEP, NP, NEXT>(acc, a, b);")
F32_STAGES = ("(int)((kMaxSmemBytes - 2048) / STAGE) < 8\n"
              "                                    ? (int)((kMaxSmemBytes - "
              "2048) / STAGE) : 8;")
F32_VARIANTS = {"f32_no_products": [(F32_PRODUCTS, "")],
                "f32_stages_3": [(F32_STAGES, "3;")]}
#: the f32 route's plans (KC, BN) timed at the MLP shape, the shipped one
#: (``_mm_plan``) first
F32_PLANS = ((32, 128), (32, 64), (16, 128), (16, 64))


def build(name, patches):
    """The patched library, built beside the shipped headers."""
    from bigdl_tpu_torch.ops import _support

    src = (_support.CSRC / "block_sparse.cu").read_text()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"{name}: block_sparse.cu no longer holds "
                               f"{old!r}")
        src = src.replace(old, new)
    out = _support.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"block_sparse_{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_support._nvcc(), *_support.NVCC_FLAGS, "-I",
                           str(_support.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


def _timed(cs, run, dx_run, iters=20):
    """(forward ms, dX ms) by CUDA-graph replay."""
    return cs.cuda_ms(run, iters=iters), cs.cuda_ms(dx_run, iters=iters)


def bf16_variants(torch, cs, bs, _support):
    """The bf16 route's variants (``VARIANTS``), the shipped build first
    and last."""
    libs = {"as_shipped": _support.load_cuda_library("block_sparse")}
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = {n: pool.submit(build, n, p) for n, p in VARIANTS.items()}
        libs.update({n: f.result() for n, f in built.items()})
    x, w, gy, mask = cs.mm_inputs(torch, *cs.MM_SHAPE, cs.MM_BLOCK,
                                  torch.bfloat16)
    err = cs.row_rel_err(torch, bs._bs_mm_cuda(x, w, mask),
                         bs._bs_mm_plain(x, w, mask))
    if err > cs.ROW_TOL["bfloat16"]:
        raise RuntimeError(f"row err {err:.3e}")
    times = {}
    try:
        for name in ["as_shipped", *VARIANTS, "as_shipped"]:
            _support._LIBS["block_sparse"] = libs[name]
            fwd, dx = _timed(cs, lambda: bs._bs_mm_cuda(x, w, mask),
                             lambda: bs._bs_mm_cuda(gy, w.t(),
                                                    mask.transposed()))
            times.setdefault(name, []).append(dict(fwd_ms=fwd, dx_ms=dx))
            print(f"K9 {name:>22}: forward {fwd:.4f} ms, dX {dx:.4f} ms")
    finally:
        _support._LIBS["block_sparse"] = libs["as_shipped"]
    return dict(row_rel_err=err, times=times)


def f32_variants(torch, cs, bs, _support):
    """The f32 route's variants (``F32_VARIANTS``, the shipped build
    first and last), its plans (``F32_PLANS``) on the shipped build, the
    tile route, the split of W and ``matmul(x, W∘mask)``."""
    libs = {"as_shipped": _support.load_cuda_library("block_sparse")}
    with ThreadPoolExecutor(max_workers=len(F32_VARIANTS)) as pool:
        built = {n: pool.submit(build, n, p) for n, p in F32_VARIANTS.items()}
        libs.update({n: f.result() for n, f in built.items()})
    x, w, gy, mask = cs.mm_inputs(torch, *cs.MM_SHAPE, cs.MM_BLOCK,
                                  torch.float32)
    err = cs.row_rel_err(torch, bs._bs_mm_cuda(x, w, mask),
                         bs._bs_mm_plain(x, w, mask))
    if err > cs.ROW_TOL["float32"]:
        raise RuntimeError(f"row err {err:.3e}")
    times = {}

    def record(name, fwd, dx):
        times.setdefault(name, []).append(dict(fwd_ms=fwd, dx_ms=dx))
        print(f"K9 f32 {name:>22}: forward {fwd:.4f} ms, dX {dx:.4f} ms")

    try:
        for name in ["as_shipped", *F32_VARIANTS, "as_shipped"]:
            _support._LIBS["block_sparse"] = libs[name]
            record(name, *_timed(cs, lambda: bs._bs_mm_cuda(x, w, mask),
                                 lambda: bs._bs_mm_cuda(gy, w.t(),
                                                        mask.transposed())))
    finally:
        _support._LIBS["block_sparse"] = libs["as_shipped"]
    for plan in (*F32_PLANS, None):
        record(f"plan {plan}" if plan else "tile route", *_timed(
            cs, lambda: bs._launch_mm(x, w, mask, plan),
            lambda: bs._launch_mm(gy, w.t(), mask.transposed(), plan),
            iters=20 if plan else 5))
    live = bs._elementwise_weight_mask(mask, "cuda")
    w_dense = torch.where(live, w, torch.zeros((), device="cuda"))
    extra = dict(split_w_ms=cs.cuda_ms(lambda: bs._mm_pieces(w)),
                 library_ms=cs.cuda_ms(lambda: torch.matmul(x, w_dense)))
    print(f"K9 f32 split of W {extra['split_w_ms']:.4f} ms, "
          f"matmul(x, W*mask) {extra['library_ms']:.4f} ms")
    return dict(row_rel_err=err, times=times, **extra)


def routes(torch, cs, bs):
    """K9 of the imported package in bf16 and f32 on the route it takes
    at the MLP shape, the f32 tile route and ``matmul(x, W∘mask)``."""
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        x, w, gy, mask = cs.mm_inputs(torch, *cs.MM_SHAPE, cs.MM_BLOCK, dt)
        tile_before = bs.LAUNCHES_MM_TILE.count
        err = cs.row_rel_err(torch, bs._bs_mm_cuda(x, w, mask),
                             bs._bs_mm_plain(x, w, mask))
        route = ("tile" if bs.LAUNCHES_MM_TILE.count > tile_before
                 else "hopper")
        fwd, dx = _timed(cs, lambda: bs._bs_mm_cuda(x, w, mask),
                         lambda: bs._bs_mm_cuda(gy, w.t(),
                                                mask.transposed()))
        live = bs._elementwise_weight_mask(mask, "cuda")
        w_dense = torch.where(live, w, torch.zeros((), dtype=dt,
                                                   device="cuda"))
        row = dict(route=route, row_rel_err=err, fwd_ms=fwd, dx_ms=dx,
                   library_ms=cs.cuda_ms(lambda: torch.matmul(x, w_dense)))
        if dt == torch.float32:
            row["tile_fwd_ms"], row["tile_dx_ms"] = _timed(
                cs, lambda: bs._launch_mm(x, w, mask, None),
                lambda: bs._launch_mm(gy, w.t(), mask.transposed(), None),
                iters=5)
        out[dname] = row
        print(f"K9 {dname:>8} {route:>6} route: forward {fwd:.4f} ms, dX "
              f"{dx:.4f} ms, row err {err:.3e}, matmul(x, W*mask) "
              f"{row['library_ms']:.4f} ms"
              + (f"; tile route {row['tile_fwd_ms']:.4f}, dX "
                 f"{row['tile_dx_ms']:.4f} ms" if "tile_fwd_ms" in row
                 else ""))
        del x, w, gy, w_dense
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse
    import importlib.util

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--f32", action="store_true",
                      help="the f32 route's variants and plans")
    mode.add_argument("--routes", nargs="?", const=str(REPO), default=None,
                      metavar="CHECKOUT",
                      help="K9 of CHECKOUT's package in both dtypes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_variants: FAIL: a CUDA card is required", file=sys.stderr)
        return 1
    checkout = Path(args.routes or REPO).resolve()
    if not (checkout / "bigdl_tpu_torch" / "__init__.py").exists():
        print(f"k9_variants: FAIL: bigdl_tpu_torch not found in {checkout}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(checkout))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import block_sparse as bs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if args.routes:
            name, result = "k9_variants_routes", dict(
                checkout=str(checkout), routes=routes(torch, cs, bs))
        elif args.f32:
            name, result = "k9_variants_f32", f32_variants(torch, cs, bs,
                                                           _support)
        else:
            name, result = "k9_variants", bf16_variants(torch, cs, bs,
                                                        _support)
    except RuntimeError as e:
        print(f"k9_variants: FAIL: {e}", file=sys.stderr)
        return 1
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  shape=list(cs.MM_SHAPE), block=cs.MM_BLOCK,
                  density=cs.MM_DENSITY, **result)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"{name}.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(result))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
