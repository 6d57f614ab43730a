#!/usr/bin/env python3
"""Where the f32 forward (K1 in f32) spends its time, on one GPU.

    python3 k1_variants.py           # D 128 (fwd_f32_consume)
    python3 k1_variants.py --wide    # D 192 and 256 (fwd_f32_consume, WIDE)
    python3 k1_variants.py --chunked # above 256, bf16 and f32 (chunk_consume)

Builds ``bigdl_tpu_torch/ops/csrc/flash_fwd.cu`` as it stands and
variants of it, each a text patch of ``attn_fwd_hopper.cuh``'s f32
consumer (``fwd_f32_consume``) or of the wide products it shares with
the backward (``hopper_common.cuh``'s ``wide_scores``) that leaves one
part out or changes it
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

With ``--wide`` the patches are of the consumer at D 192 and 256
(``fwd_f32_consume`` with ``WIDE``, ``wide_scores``), timed at B 2, H 8, T 1024,
causal:

* ``no_score_products``, ``no_pv_products``, ``no_products``: as above;
* ``one_accumulator``: S over all of D in one wgmma accumulator (96
  roundings toward zero at D 256) instead of a fresh partial per q panel
  of 32 columns (12), added in f32;
* ``unrolled``: the score products' loop over q panels unrolled with the
  next panel split while the last one's products run at D 256 too (as at
  D 192), which spills there;
* ``rolled``: the loop kept at D 192 too, a k16 step split before its
  products (as at D 256).

and each build's ptxas report (registers, spills, "Performance"
remarks) for those kernels is printed beside its times.

With ``--chunked`` the patches are of the chunked forward above head
dim 256 (``attn_fwd_chunk_kernel``), in bf16 and in f32, timed at B 2,
H 8, T 1024, causal, D 320 and 512, with their ptxas reports:

* ``no_score_products``, ``no_pv_products``: as above;
* ``q_loaded_once``: each stage's q panel loaded for the first key tile
  only (later tiles read what the stage last held): what keeping the
  block's q rows in shared memory would save, their room aside;
* ``one_chunk``: one block a row block and head, forming O's first 256
  columns only: S formed once where the shipped grid forms it in every
  chunk, which bounds what handing P to the blocks of the other chunks
  (instead of each forming S anew) could save.

Then it times each at the f32 shape of ``chip_smoke.py`` phase 3 (B 2,
H 8, T 512, D 128, causal: 64 blocks) and at phase 5's layer shape (B 16,
H 8, T 1024: 1024 blocks) by CUDA-graph replay (``chip_smoke.cuda_ms``),
the unpatched build first and last.  A variant that leaves work out is
wrong by construction; the unpatched build and the P . V variants (with
``--wide``: every build that does all the work) are held against the
plain version (row by row, the f32 limit).  Prints the times, a JSON
line of them (also written to ``chiprun_out/k1_variants.json``, or
``k1_variants_wide.json``) and the card's name and power limit; exits
non-zero without a CUDA device.
"""
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

SCORES = ("wgmma_scores_split<D, C::PANEL_Q, C::PANEL_KV, THIRD>"
          "(sc, q_wg, k_t);")
PV = ("wgmma_accumulate_split<D, C::PANEL_KV, THIRD, BK / 16>"
      "(acc, a1, a2, a3, v_t);")
SPLIT_K = "split_tile<D, kConsumers, BK>(k_t, kKvSplit);"
SPLIT_V = "split_tile<D, kConsumers, BK>(v_t, kKvSplit);"
NO_SCORES = (SCORES, "for (int i = 0; i < kTileRows / 2; ++i) sc[i] = 0.0f;")
NO_PV = (PV, "")
NO_SPLITS = [(SPLIT_K, ";"), (SPLIT_V, ";")]
PV_FIVE = (PV, PV.replace("THIRD, ", "0, "))
PV_THREE = (PV, "wgmma_accumulate<D, 2 * C::PANEL_KV, BK / 16>(acc, a2, v_t);\n"
                "      wgmma_accumulate<D, 2 * C::PANEL_KV, BK / 16>(acc, a1, v_t + "
                "C::PANEL_KV);\n"
                "      wgmma_accumulate<D, 2 * C::PANEL_KV, BK / 16>(acc, a1, v_t);")
VARIANTS = {"no_score_products": [NO_SCORES], "no_pv_products": [NO_PV],
            "no_products": [NO_SCORES, NO_PV], "no_tile_splits": NO_SPLITS,
            "pv_five_products": [PV_FIVE], "pv_three_products": [PV_THREE]}
#: the builds held against the plain version
CHECKED = ("as_shipped", "pv_five_products", "pv_three_products")
#: (label, B, H, T, D): phase 3's f32 case, phase 5's layer shape
SHAPES = (("phase3_f32", 2, 8, 512, 128), ("phase5_layer", 16, 8, 1024, 128))

# --wide: the consumer at D 192 and 256
W_SCORES = ("wgmma_rs<N, 0>(part, a[pa][j], smem_desc<P::RB>"
            "(b + 2 * (c % P::PW)), j0 + j + t > 0);")
W_NO_SCORES = (W_SCORES, "(void)b; part[0] = 0.0f;")
W_ONE_ACC = [(W_SCORES, W_SCORES.replace("j0 + j + t > 0", "g + j0 + j + t > 0")),
             ("wide_products<D, 2, N>(part,", "wide_products<D, 2, N>(sc,"),
             ("wide_products<D, 1, N>(part,", "wide_products<D, 1, N>(sc,"),
             ("      add_partial<N>(sc, part);", "")]
W_ROLLED = "constexpr bool kWideRolled = D > 192;"
WIDE_VARIANTS = {
    "no_score_products": [W_NO_SCORES], "no_pv_products": [NO_PV],
    "no_products": [W_NO_SCORES, NO_PV], "one_accumulator": W_ONE_ACC,
    "unrolled": [(W_ROLLED, "constexpr bool kWideRolled = false;")],
    "rolled": [(W_ROLLED, "constexpr bool kWideRolled = true;")]}
WIDE_CHECKED = ("as_shipped", "one_accumulator", "unrolled", "rolled")
WIDE_SHAPES = (("D192", 2, 8, 1024, 192), ("D256", 2, 8, 1024, 256))

# --chunked: the forward above head dim 256, both dtypes
C_SCORES = [("wgmma_ss<kTileRows, 0>(sc, smem_desc<128>(q + 32 * j), "
             "smem_desc<128>(k + 32 * j),\n                           "
             "!first || j > 0);", "(void)q; (void)k; (void)first;"),
            ("wide_products<kChunkPanel, 1, kWideRows>(part, a, k, g, j);",
             "part[0] = 0.0f;")]
C_PV = [("wgmma_accumulate<kChunkCols, C::LPANEL_KV, BK / 16>(acc, a1, v_st);",
         ";"),
        ("wgmma_accumulate_split<kChunkCols, BK * P::RB, BK * kChunkCols * 4, "
         "BK / 16>(\n            acc, a1, a2, a3, v_st);", ";")]
C_Q_ONCE = [("mbar_arrive_expect_tx(&full[s], C::Q_LOAD + (part ? 0 : "
             "C::K_LOAD));",
             "mbar_arrive_expect_tx(&full[s], (it == 0 ? C::Q_LOAD : 0) + "
             "(part ? 0 : C::K_LOAD));"),
            ("tma_load_4d(q_st + g * C::LPANEL_Q, tm_q, &full[s], col, "
             "b * kBlockRows, h, bb);",
             "if (it == 0) tma_load_4d(q_st + g * C::LPANEL_Q, tm_q, "
             "&full[s], col, b * kBlockRows, h, bb);")]
C_ONE_CHUNK = [("inline int chunk_count(int D) { return (D + kChunkCols - 1) "
                "/ kChunkCols; }", "inline int chunk_count(int) { return 1; }")]
CHUNKED_VARIANTS = {"no_score_products": C_SCORES, "no_pv_products": C_PV,
                    "q_loaded_once": C_Q_ONCE, "one_chunk": C_ONE_CHUNK}
CHUNKED_CHECKED = ("as_shipped",)
CHUNKED_SHAPES = tuple((f"{dt}_D{D}", 2, 8, 1024, D, dt)
                       for dt in ("bf16", "f32") for D in (320, 512))


def build(name, patches):
    """flash_fwd.cu beside the patched headers, which its quoted includes
    find first; the other headers from the shipped sources.  Returns
    the library and nvcc's ptxas report."""
    from bigdl_tpu_torch.ops import _support

    headers = ("attn_fwd_hopper.cuh", "hopper_common.cuh")
    src = {h: (_support.CSRC / h).read_text() for h in headers}
    for old, new in patches:
        held = [h for h in headers if old in src[h]]
        if not held:
            raise RuntimeError(f"{name}: no header holds {old!r}")
        for h in held:
            src[h] = src[h].replace(old, new)
    out = _support.BUILD_DIR / "variants" / f"k1_{name}"
    out.mkdir(parents=True, exist_ok=True)
    for h in headers:
        (out / h).write_text(src[h])
    cu, so = out / "flash_fwd.cu", out / f"lib{name}.so"
    cu.write_text((_support.CSRC / "flash_fwd.cu").read_text())
    proc = subprocess.run([_support._nvcc(), *_support.NVCC_FLAGS, "-I",
                           str(_support.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so)), proc.stderr


def wide_ptxas(report: str, chunked: bool = False) -> dict:
    """Registers, spills and "Performance" remarks of the f32 K1 at D 192
    and 256 (``chunked``: K1's chunked forward in each dtype) from a
    ptxas report."""
    import chip_smoke as cs

    pattern = (r"attn_fwd_chunk_kernelI(13__nv_bfloat16|f)NS_" if chunked
               else r"attn_fwd_split_kernelILi(192|256)E")
    out = {}
    for fn, rep in cs.ptxas_functions(report).items():
        m = re.search(pattern, fn)
        if m:
            key = ({"f": "f32"}.get(m.group(1), "bf16") if chunked
                   else f"D{m.group(1)}")
            out[key] = dict(rep, remarks=[
                line.strip() for line in report.splitlines()
                if "Performance" in line and fn in line])
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wide", action="store_true",
                    help="the consumer at D 192 and 256 instead of D 128")
    ap.add_argument("--chunked", action="store_true",
                    help="the chunked forward above D 256, bf16 and f32")
    args = ap.parse_args(argv)
    wide, chunked = args.wide, args.chunked
    variants, checked, shapes = (
        (CHUNKED_VARIANTS, CHUNKED_CHECKED, CHUNKED_SHAPES) if chunked
        else (WIDE_VARIANTS, WIDE_CHECKED, WIDE_SHAPES) if wide
        else (VARIANTS, CHECKED, SHAPES))

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
    with ThreadPoolExecutor(max_workers=len(variants) + 1) as pool:
        built = {n: pool.submit(build, n, p) for n, p in
                 {"as_shipped": [], **variants}.items()}
        built = {n: f.result() for n, f in built.items()}
    libs = {n: lib for n, (lib, _) in built.items()}
    ptxas = {}
    if wide or chunked:
        ptxas = {n: wide_ptxas(report, chunked)
                 for n, (_, report) in built.items()}
        for n, rep in ptxas.items():
            print(f"K1 {n:>18}: ptxas {rep}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(23)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    inputs = {label: [torch.randn(B, H, T, D, device="cuda", generator=g)
                      .to(dtypes[dt[0]] if dt else torch.float32)
                      for _ in range(3)]
              for label, B, H, T, D, *dt in shapes}
    errs, times = {}, {}
    before = _support._LIBS.get("flash_fwd")
    try:
        for name in ["as_shipped", *variants, "as_shipped"]:
            _support._LIBS["flash_fwd"] = libs[name]
            row = {}
            for label, _, _, _, D, *_ in shapes:
                q, k, v = inputs[label]
                scale = D ** -0.5
                if name in checked and (wide or chunked
                                        or label == shapes[0][0]):
                    errs.setdefault(name, {})[label] = cs.row_rel_err(
                        torch, fa._flash_cuda(q, k, v, True, scale)[0],
                        fa._flash_plain(q, k, v, True, scale)[0])
                row[label] = cs.cuda_ms(lambda: fa._flash_cuda(
                    q, k, v, True, scale))
            times.setdefault(name, []).append(row)
            print(f"K1 {name:>18}: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in row.items()), flush=True)
    finally:
        if before is None:
            _support._LIBS.pop("flash_fwd", None)
        else:
            _support._LIBS["flash_fwd"] = before
    print(f"row errors {errs}")
    bad = {n: e for n, e in errs.items()
           if not all(err <= cs.ROW_TOL["bfloat16" if label.startswith("bf16")
                                        else "float32"]
                      for label, err in e.items())}
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  shapes=[list(s) for s in shapes], row_rel_err=errs,
                  times=times, ptxas=ptxas)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = ("k1_variants_chunked.json" if chunked else
            "k1_variants_wide.json" if wide else "k1_variants.json")
    (out / name).write_text(json.dumps(report, indent=1))
    print(json.dumps(times))
    print(smi)
    if bad:
        print(f"k1_variants: FAIL: row errors {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
