#!/usr/bin/env python3
"""Where the f32 forward (K1 in f32) spends its time, on one GPU.

    python3 k1_variants.py

Builds ``bigdl_tpu_torch/ops/csrc/flash_fwd.cu`` as it stands and
variants of it, each a text patch of ``attn_fwd_hopper.cuh``'s f32
consumer (``fwd_f32_consume``) that leaves one part out or changes it
(one ``nvcc`` each, all started together, into the git-ignored
``.torch_kernels/variants/``):

* ``no_score_products``: S is not formed (zero scores), the six wgmma
  of each score product left out;
* ``no_pv_products``: O += P . V is not formed, its six left out;
* ``no_products``: both;
* ``no_tile_splits``: the K and V tiles are not split into bf16 pieces
  (the q rows still are);
* ``pv_five_products``: P . V from five products on three pieces of P
  and two of V (a2 b2 + a3 b1, a1 b2 + a2 b1, a1 b1), the f32 dK/dV's
  plan, instead of six on three pieces of each;
* ``pv_three_products``: P . V from three on two pieces of each (a2 b1
  + a1 b2, a1 b1).

Both P . V variants stay within the f32 limit but leave O's error at
V's (or P's) rounding, which the backward's key-bias gradient does not
take (``tests/test_torch_f32_split.py``).

Then it times each at the f32 shape of ``chip_smoke.py`` phase 3 (B 2,
H 8, T 512, D 128, causal: 64 blocks) and at phase 5's layer shape (B 16,
H 8, T 1024: 1024 blocks) by CUDA-graph replay (``chip_smoke.cuda_ms``),
the unpatched build first and last.  A variant that leaves work out is
wrong by construction; the unpatched build and the P . V variants are
held against the plain version (row by row, the f32 limit).  Prints
the times, a JSON line of them (also written to
``chiprun_out/k1_variants.json``) and the card's name and power limit;
exits non-zero without a CUDA device.
"""
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

SCORES = ("wgmma_scores_split<D, C::PANEL_Q, C::PANEL_KV, THIRD>"
          "(sc, q_wg, k_t);")
PV = ("wgmma_accumulate_split<D, C::PANEL_KV, THIRD>"
      "(acc, a1, a2, a3, v_t);")
SPLIT_K = "split_tile<D, kConsumers>(k_t, kKvSplit);"
SPLIT_V = "split_tile<D, kConsumers>(v_t, kKvSplit);"
NO_SCORES = (SCORES, "for (int i = 0; i < kTileRows / 2; ++i) sc[i] = 0.0f;")
NO_PV = (PV, "")
NO_SPLITS = [(SPLIT_K, ";"), (SPLIT_V, ";")]
PV_FIVE = (PV, PV.replace(", THIRD>", ">"))
PV_THREE = (PV, "wgmma_accumulate<D, 2 * C::PANEL_KV>(acc, a2, v_t);\n"
                "      wgmma_accumulate<D, 2 * C::PANEL_KV>(acc, a1, v_t + "
                "C::PANEL_KV);\n"
                "      wgmma_accumulate<D, 2 * C::PANEL_KV>(acc, a1, v_t);")
VARIANTS = {"no_score_products": [NO_SCORES], "no_pv_products": [NO_PV],
            "no_products": [NO_SCORES, NO_PV], "no_tile_splits": NO_SPLITS,
            "pv_five_products": [PV_FIVE], "pv_three_products": [PV_THREE]}
#: the builds held against the plain version
CHECKED = ("as_shipped", "pv_five_products", "pv_three_products")
#: (label, B, H, T, D): phase 3's f32 case, phase 5's layer shape
SHAPES = (("phase3_f32", 2, 8, 512, 128), ("phase5_layer", 16, 8, 1024, 128))


def build(name, patches):
    """flash_fwd.cu beside the patched header, which its quoted include
    finds first; the other headers from the shipped sources."""
    from bigdl_tpu_torch.ops import _support

    src = (_support.CSRC / "attn_fwd_hopper.cuh").read_text()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"{name}: attn_fwd_hopper.cuh no longer "
                               f"holds {old!r}")
        src = src.replace(old, new)
    out = _support.BUILD_DIR / "variants" / f"k1_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "attn_fwd_hopper.cuh").write_text(src)
    cu, so = out / "flash_fwd.cu", out / f"lib{name}.so"
    cu.write_text((_support.CSRC / "flash_fwd.cu").read_text())
    proc = subprocess.run([_support._nvcc(), *_support.NVCC_FLAGS, "-I",
                           str(_support.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_variants: FAIL: a CUDA card is required", file=sys.stderr)
        return 1
    if not (REPO / "bigdl_tpu_torch" / "__init__.py").exists():
        print(f"k1_variants: FAIL: bigdl_tpu_torch not found beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _support
    from bigdl_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"as_shipped": _support.load_cuda_library("flash_fwd")}
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        built = {n: pool.submit(build, n, p) for n, p in VARIANTS.items()}
        libs.update({n: f.result() for n, f in built.items()})

    g = torch.Generator(device="cuda").manual_seed(23)
    inputs = {label: [torch.randn(B, H, T, D, device="cuda", generator=g)
                      for _ in range(3)] for label, B, H, T, D in SHAPES}
    errs, times = {}, {}
    try:
        for name in ["as_shipped", *VARIANTS, "as_shipped"]:
            _support._LIBS["flash_fwd"] = libs[name]
            row = {}
            for label, *_, D in SHAPES:
                q, k, v = inputs[label]
                scale = D ** -0.5
                if name in CHECKED \
                        and label == SHAPES[0][0]:
                    errs[name] = cs.row_rel_err(
                        torch, fa._flash_cuda(q, k, v, True, scale)[0],
                        fa._flash_plain(q, k, v, True, scale)[0])
                row[label] = cs.cuda_ms(lambda: fa._flash_cuda(
                    q, k, v, True, scale))
            times.setdefault(name, []).append(row)
            print(f"K1 f32 {name:>18}: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in row.items()), flush=True)
    finally:
        _support._LIBS["flash_fwd"] = libs["as_shipped"]
    print(f"row errors {errs}")
    bad = {n: e for n, e in errs.items() if not e <= cs.ROW_TOL["float32"]}
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  shapes=[list(s) for s in SHAPES], row_rel_err=errs,
                  times=times)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k1_variants.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(times))
    print(smi)
    if bad:
        print(f"k1_variants: FAIL: row errors {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
