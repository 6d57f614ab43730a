#!/usr/bin/env python3
"""Where K9's Hopper route spends its time, on one GPU.

    python3 k9_variants.py

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
Prints the times, a JSON line of them (also written to
``chiprun_out/k9_variants.json``) and the card's name and power limit;
exits non-zero without a CUDA device.
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k9_variants: FAIL: a CUDA card is required", file=sys.stderr)
        return 1
    if not (REPO / "bigdl_tpu_torch" / "__init__.py").exists():
        print(f"k9_variants: FAIL: bigdl_tpu_torch not found beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import block_sparse as bs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"as_shipped": _support.load_cuda_library("block_sparse")}
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = {n: pool.submit(build, n, p) for n, p in VARIANTS.items()}
        libs.update({n: f.result() for n, f in built.items()})

    x, w, gy, mask = cs.mm_inputs(torch, *cs.MM_SHAPE, cs.MM_BLOCK,
                                  torch.bfloat16)
    err = cs.row_rel_err(torch, bs._bs_mm_cuda(x, w, mask),
                         bs._bs_mm_plain(x, w, mask))
    if err > cs.ROW_TOL["bfloat16"]:
        print(f"k9_variants: FAIL: row err {err:.3e}", file=sys.stderr)
        return 1
    times = {}
    try:
        for name in ["as_shipped", *VARIANTS, "as_shipped"]:
            _support._LIBS["block_sparse"] = libs[name]
            fwd = cs.cuda_ms(lambda: bs._bs_mm_cuda(x, w, mask))
            dx = cs.cuda_ms(lambda: bs._bs_mm_cuda(gy, w.t(),
                                                   mask.transposed()))
            times.setdefault(name, []).append(dict(fwd_ms=fwd, dx_ms=dx))
            print(f"K9 {name:>22}: forward {fwd:.4f} ms, dX {dx:.4f} ms")
    finally:
        _support._LIBS["block_sparse"] = libs["as_shipped"]
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  shape=list(cs.MM_SHAPE), block=cs.MM_BLOCK,
                  density=cs.MM_DENSITY, row_rel_err=err, times=times)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k9_variants.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(times))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
