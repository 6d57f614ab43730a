#!/usr/bin/env python3
"""Where K9 spends its time, on one GPU.

    python3 k9_variants.py [--f32 | --coarse | --routes CHECKOUT]

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

With ``--f32`` it does the same for the f32 block route (split
products) at the same shape in f32: the plans (KC, BN) the route is built
for, 32 or 16 by 128 or 64, on the shipped build (each forward and dX,
the split of W into its pieces included), the variants
``f32_no_products`` (the consumers split the x boxes and add their
partials but issue no wgmma) and ``f32_stages_3`` (a ring of three
stages), the split of W alone and ``matmul(x, W∘mask)``.

With ``--coarse`` it times the coarse route at block 8 (x 4096 x 1024, W
1024 x 1024, density 0.5, phase 3's ``block8`` cases) in both dtypes on
each coarse tile (KC, BN) it is built for (``COARSE_PLANS``; forward and
dX, the masked copy of W included), the masked copy alone and
``matmul(x, W∘mask)``; then both routes at blocks 32, 64, 128 and 256
(``ROUTE_BLOCKS``), at that shape and the MLP shape, in both dtypes:
where ``_mm_plan``'s rule (``MM_BLOCK_ROUTE``) comes from.

With ``--routes CHECKOUT`` it times K9 of CHECKOUT's package (default:
this one), forward and dX, in bf16 and in f32, at the same MLP shape and
at block 8 (phase 3's ``block8`` shape), on the route that checkout
gives each, with ``matmul(x, W∘mask)`` beside them: run parent, change,
change, parent in one call to compare two versions.

Prints the times, a JSON line of them (also written to
``chiprun_out/k9_variants[_f32|_coarse|_routes].json``) and the card's name and
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
#: the coarse route's tiles (KC, BN) timed at block 8, by dtype, the
#: largest (``MM_COARSE_TILE``) first
COARSE_PLANS = {"bfloat16": ((64, 128), (64, 64), (32, 128), (32, 64)),
                "float32": ((32, 128), (32, 64), (16, 128), (16, 64))}
#: phase 3's block-8 shape: x (M, K), W (K, N), the block
BLOCK8 = (4096, 1024, 1024, 8)
#: the blocks ``--coarse`` times on both routes
ROUTE_BLOCKS = (32, 64, 128, 256)


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
    split of W and ``matmul(x, W∘mask)``."""
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
    for plan in map(bs.MmPlan._make, F32_PLANS):
        record(f"plan {tuple(plan[:2])}", *_timed(
            cs, lambda: bs._launch_mm(x, w, mask, plan),
            lambda: bs._launch_mm(gy, w.t(), mask.transposed(), plan)))
    live = bs._elementwise_weight_mask(mask, "cuda")
    w_dense = torch.where(live, w, torch.zeros((), device="cuda"))
    extra = dict(split_w_ms=cs.cuda_ms(lambda: bs._mm_pieces(w)),
                 library_ms=cs.cuda_ms(lambda: torch.matmul(x, w_dense)))
    print(f"K9 f32 split of W {extra['split_w_ms']:.4f} ms, "
          f"matmul(x, W*mask) {extra['library_ms']:.4f} ms")
    return dict(row_rel_err=err, times=times, **extra)


def coarse_plans(torch, cs, bs):
    """The coarse route at block 8 in both dtypes on each of
    ``COARSE_PLANS`` (forward and dX, each plan for the forward's W (K, N)
    and dX's Wᵀ (N, K) alike, as the shape is square), the masked copy of
    W alone on the shipped plan, and ``matmul(x, W∘mask)``; every plan's
    output held against the plain version."""
    M, K, N, block = BLOCK8
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[-1]
        x, w, gy, mask = cs.mm_inputs(torch, M, K, N, block, dt)
        ref = bs._bs_mm_plain(x, w, mask)
        rows = {}
        for kc, bn in COARSE_PLANS[dname]:
            plan = bs.MmPlan(kc, bn, True)
            err = cs.row_rel_err(torch, bs._launch_mm(x, w, mask, plan), ref)
            if err > cs.ROW_TOL[dname]:
                raise RuntimeError(f"{dname} plan {(kc, bn)}: row err "
                                   f"{err:.3e}")
            fwd, dx = _timed(cs, lambda: bs._launch_mm(x, w, mask, plan),
                             lambda: bs._launch_mm(gy, w.t(),
                                                   mask.transposed(), plan))
            rows[f"{kc}x{bn}"] = dict(fwd_ms=fwd, dx_ms=dx, row_rel_err=err)
            print(f"K9 coarse {dname:>8} plan ({kc:3d}, {bn:3d}): forward "
                  f"{fwd:.4f} ms, dX {dx:.4f} ms, row err {err:.3e}")
        plan = bs._mm_plan(dt, block, block, K, N)
        live = bs._elementwise_weight_mask(mask, "cuda")
        w_dense = torch.where(live, w, torch.zeros((), dtype=dt,
                                                   device="cuda"))
        out[dname] = dict(
            plans=rows, shipped=[plan.kc, plan.bn],
            masked_w_ms=cs.cuda_ms(lambda: bs._mm_masked(w, mask, plan)),
            library_ms=cs.cuda_ms(lambda: torch.matmul(x, w_dense)))
        print(f"K9 coarse {dname:>8} masked copy of W "
              f"{out[dname]['masked_w_ms']:.4f} ms, matmul(x, W*mask) "
              f"{out[dname]['library_ms']:.4f} ms")
        del x, w, gy, w_dense, ref
        torch.cuda.empty_cache()
    out["blocks"] = route_blocks(torch, cs, bs)
    return out


def route_blocks(torch, cs, bs):
    """Both routes at each of ``ROUTE_BLOCKS``, at phase 3's block-8 shape
    and the MLP shape, in both dtypes (forward and dX; the block route's
    plan from ``_block_plan``, the coarse route's from ``_coarse_plan``
    for the forward's W and dX's Wᵀ), each held against the plain
    version."""
    rows = []
    for M, K, N in (BLOCK8[:3], cs.MM_SHAPE):
        for block in ROUTE_BLOCKS:
            for dt in (torch.bfloat16, torch.float32):
                dname = str(dt).split(".")[-1]
                x, w, gy, mask = cs.mm_inputs(torch, M, K, N, block, dt)
                ref = bs._bs_mm_plain(x, w, mask)
                bp = bs._block_plan(dt, block, block)
                row = dict(shape=[M, K, N], block=block, dtype=dname,
                           taken="coarse" if bs._mm_plan(
                               dt, block, block, K, N).coarse else "block")
                for name, plan, dx_plan in (
                        ("block", bp, bp),
                        ("coarse", bs._coarse_plan(dt, K, N),
                         bs._coarse_plan(dt, N, K))):
                    err = cs.row_rel_err(
                        torch, bs._launch_mm(x, w, mask, plan), ref)
                    if err > cs.ROW_TOL[dname]:
                        raise RuntimeError(f"{name} route at block {block} "
                                           f"{dname}: row err {err:.3e}")
                    row[name] = dict(zip(("fwd_ms", "dx_ms"), _timed(
                        cs, lambda: bs._launch_mm(x, w, mask, plan),
                        lambda: bs._launch_mm(gy, w.t(), mask.transposed(),
                                              dx_plan))), kc=plan.kc,
                                     bn=plan.bn)
                rows.append(row)
                b, c = row["block"], row["coarse"]
                print(f"K9 {M}x{K}x{N} block {block:3d} {dname:>8}: block "
                      f"route {b['fwd_ms']:.4f} ms, dX {b['dx_ms']:.4f}; "
                      f"coarse {c['fwd_ms']:.4f}, dX {c['dx_ms']:.4f} "
                      f"(_mm_plan takes the {row['taken']} route)")
                del x, w, gy, ref
                torch.cuda.empty_cache()
    return rows


def _route_counts(bs, dt):
    """(launches off the route over the mask's blocks, by name) of the
    imported package: its tile route where it has one, else its coarse
    route in ``dt``."""
    counters = [getattr(bs, "LAUNCHES_MM_TILE", None),
                getattr(bs, "LAUNCHES_MM_COARSE", {}).get(dt)]
    return {c.name: c.count for c in counters if c is not None}


def routes(torch, cs, bs):
    """K9 of the imported package in bf16 and f32 at the MLP shape and at
    block 8, on the route it takes there, and ``matmul(x, W∘mask)``."""
    out = {}
    M, K, N, block = BLOCK8
    for shape, blk, tag in ((cs.MM_SHAPE, cs.MM_BLOCK, "mlp"),
                            ((M, K, N), block, "block8")):
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[-1]
            x, w, gy, mask = cs.mm_inputs(torch, *shape, blk, dt)
            before = _route_counts(bs, dt)
            err = cs.row_rel_err(torch, bs._bs_mm_cuda(x, w, mask),
                                 bs._bs_mm_plain(x, w, mask))
            after = _route_counts(bs, dt)
            route = next((name for name in after
                          if after[name] > before[name]), "block")
            fwd, dx = _timed(cs, lambda: bs._bs_mm_cuda(x, w, mask),
                             lambda: bs._bs_mm_cuda(gy, w.t(),
                                                    mask.transposed()),
                             iters=5 if "tile" in route else 20)
            live = bs._elementwise_weight_mask(mask, "cuda")
            w_dense = torch.where(live, w, torch.zeros((), dtype=dt,
                                                       device="cuda"))
            row = dict(route=route, row_rel_err=err, fwd_ms=fwd, dx_ms=dx,
                       library_ms=cs.cuda_ms(lambda: torch.matmul(x,
                                                                  w_dense)))
            out[f"{tag}_{dname}"] = row
            print(f"K9 {tag:>6} {dname:>8} route {route}: forward "
                  f"{fwd:.4f} ms, dX {dx:.4f} ms, row err {err:.3e}, "
                  f"matmul(x, W*mask) {row['library_ms']:.4f} ms")
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
    mode.add_argument("--coarse", action="store_true",
                      help="the coarse route's tiles at block 8")
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
        elif args.coarse:
            name, result = "k9_variants_coarse", coarse_plans(torch, cs, bs)
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
