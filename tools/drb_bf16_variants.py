#!/usr/bin/env python3
"""Time variants of the bf16 DRB kernel (``drb.cu::drb_kernel_bf16``) on one
CUDA card, to see where its time goes where no profiler of kernels runs.

    python3 tools/drb_bf16_variants.py [--variants NAME,NAME,...]

Each variant is this checkout's ``drb.cu`` with one textual change, built
with the same ``nvcc`` flags into ``build/drb_variants/`` (all builds run
in parallel):

* ``base``: the kernel as it is;
* ``cut_launch``, ``cut_prologue``, ``cut_stage1`` .. ``cut_stage4``: the
  kernel returning at its start, after its prologue (x, weights, zeroed
  frame) or after stage k (wrong results; time up to that point);
* ``x_skipped``: no x copy or transposition (wrong results: x's cost);
* ``chunks_rolled``: the chunk loop of a stage's chain not unrolled;
* ``warpgroups3``: 3 warpgroups a CTA instead of 2;
* ``pipelined``: two accumulator sets in turn, tile t + 2's chain issued
  before tile t's epilogue;
* ``no_weight_wait``: stages 3-5 do not wait for their weights (wrong
  results), ``no_stage_fence``: no proxy fence at stage ends,
  ``no_out_stores``: no stage-output stores (wrong results);
* ``timeline``: ``clock64()`` stamps in CTA 0, printed per warpgroup at
  B=128 and B=150: after the first barrier, the prologue's steps, and per
  stage its weight wait, each M-tile's commit, wait and epilogue end, and
  its closing barrier (SM clocks since the first stamp).

For each it prints one JSON line: the ptxas register line and any note
that ptxas serialized ``wgmma``; the largest difference from the bf16 twin
in bf16 ulps of the output's largest value (variants that drop work are
wrong by construction); and the kernel's mean time from CUDA events
(``tools/time_kernels.py``'s ``cuda_ms``) at B=150, 132, 128 and the band
(8, 16, 32, 112), in turns over two repeats. Also the host's time per
``drb_forward`` call.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(150, 16, 16, 16), (132, 16, 16, 16), (128, 16, 16, 16), (8, 16, 32, 112)]
DBG = "if (blockIdx.x == 0 && (threadIdx.x & 127) == 0) dbg_ts[threadIdx.x >> 7][{}] = clock64();"
WAIT = "    mbar_wait(bar_s(buf), ((s - 1) >> 1) & 1);\n"
STAGE_END = "bar_s(buf));\n    }\n  }\n\n  // The block output, staged"
PROLOGUE_END = "  fence_proxy_async();\n  __syncthreads();\n\n  // Warp-uniform"
START = "  uint32_t* sm32 = reinterpret_cast<uint32_t*>(smem_bf16);\n"
CHUNK_LOOP = "#pragma unroll\n      for (int c = 0; c < (F == 16 ? 5 : 3); ++c) {"
X_BLOCK = ("  if (vec_io) {  // x by bulk copies", "  // Group 0 zeroed (its SAME ring)")
X_TRANSPOSE = ("  // x into group 0, channel-last:", "  __syncthreads();\n  // The out groups zeroed")
FENCE = "    fence_proxy_async();\n    __syncthreads();\n    if (threadIdx.x == 0 && s + 2 <= 5) {"
STORE = ("              sm32[(out0 + nb * out_plane + q) * 4 + tq] = "
         "bf16x2_bits(__floats2bfloat162_rn(y0, y1));\n")
TILE_LOOP = "#pragma unroll 1\n    for (int t = wg; t < ntiles; t += kWarpgroups) {\n"
TILE_END = "      }\n    }\n    fence_proxy_async();"


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"drb.cu no longer has this text once: {old[:70]!r}")
    return text.replace(old, new)


def cut(text: str, a: str, b: str) -> str:
    """text with the part from a up to (not including) b removed."""
    i, j = text.index(a), text.index(b)
    return text[:i] + text[j:]


def pipelined(src: str) -> str:
    """Two accumulator sets in turn: the chain and the epilogue of a tile
    become lambdas, and tile t + 2's chain is issued before tile t's
    epilogue."""
    i = src.index(TILE_LOOP)
    j = src.index("    fence_proxy_async();\n    __syncthreads();\n    if (threadIdx.x == 0 && s + 2 <= 5)")
    body = src[i + len(TILE_LOOP):j]
    c0 = body.index("      const int m_first = q0 - 1 + t * kMOut;\n")
    c1 = body.index("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_acc(acc);\n")
    chain = body[c0:c1].replace("      float acc[NACC];\n", "")
    e0 = c1 + len("      wgmma_commit();\n      wgmma_wait<0>();\n      fence_acc(acc);\n")
    epilogue = body[e0:body.rindex("    }\n")]
    loop = ("    auto issue = [&](float (&acc)[NACC], int t) {\n" + chain + "    };\n"
            "    auto finish = [&](float (&acc)[NACC], int t) {\n"
            "      const int m_first = q0 - 1 + t * kMOut;\n" + epilogue + "    };\n"
            "    float acc_a[NACC], acc_b[NACC];\n"
            "    if (wg < ntiles) issue(acc_a, wg);\n"
            "    wgmma_commit();\n"
            "#pragma unroll 1\n"
            "    for (int t = wg; t < ntiles; t += 2 * kWarpgroups) {\n"
            "      const int t1 = t + kWarpgroups, t2 = t + 2 * kWarpgroups;\n"
            "      if (t1 < ntiles) issue(acc_b, t1);\n"
            "      wgmma_commit();\n      wgmma_wait<1>();\n      fence_acc(acc_a);\n"
            "      finish(acc_a, t);\n"
            "      if (t1 >= ntiles) break;\n"
            "      if (t2 < ntiles) issue(acc_a, t2);\n"
            "      wgmma_commit();\n      wgmma_wait<1>();\n      fence_acc(acc_b);\n"
            "      finish(acc_b, t1);\n"
            "    }\n"
            "    wgmma_wait<0>();\n")
    return src[:i] + loop + src[j:]


def timeline(src: str) -> str:
    tile = "3 * ((t - wg) / kWarpgroups)"
    text = sub(src, "  extern __shared__ __align__(128) uint4 smem_bf16[];\n",
               "  extern __shared__ __align__(128) uint4 smem_bf16[];\n"
               "  __shared__ unsigned long long dbg_ts[2][64];\n")
    text = sub(text, "  __syncthreads();\n  if (vec_io) {  // x by bulk copies",
               "  __syncthreads();\n  " + DBG.format(0) + "\n  if (vec_io) {  // x by bulk copies")
    text = sub(text, "  if (vec_io) mbar_wait(bar_s(2), 0);\n",
               "  " + DBG.format(57) + "\n  if (vec_io) mbar_wait(bar_s(2), 0);\n  " + DBG.format(58) + "\n")
    text = sub(text, "  __syncthreads();\n  // The out groups zeroed",
               "  " + DBG.format(59) + "\n  __syncthreads();\n  // The out groups zeroed")
    text = sub(text, PROLOGUE_END, PROLOGUE_END.replace(
        "__syncthreads();\n", "__syncthreads();\n  " + DBG.format(1) + "\n"))
    text = sub(text, WAIT, WAIT + "    " + DBG.format("2 + (s - 1) * 11") + "\n")
    text = sub(text, "      wgmma_commit();\n      wgmma_wait<0>();\n      fence_acc(acc);\n",
               "      wgmma_commit();\n      " + DBG.format(f"2 + (s - 1) * 11 + 1 + {tile}")
               + "\n      wgmma_wait<0>();\n      fence_acc(acc);\n      "
               + DBG.format(f"2 + (s - 1) * 11 + 2 + {tile}") + "\n")
    text = sub(text, TILE_END, "      }\n      " + DBG.format(f"2 + (s - 1) * 11 + 3 + {tile}")
               + "\n    }\n    fence_proxy_async();")
    text = sub(text, FENCE, FENCE.replace(
        "__syncthreads();\n", "__syncthreads();\n    " + DBG.format("2 + (s - 1) * 11 + 10") + "\n"))
    last = text.rindex("\n}\n", 0, text.index("using KernelFnBf16"))
    return (text[:last] + "\n  " + DBG.format(63) + "\n  __syncthreads();\n"
            "  if (blockIdx.x == 0 && threadIdx.x < 128)\n"
            "    reinterpret_cast<unsigned long long*>(out)[threadIdx.x] =\n"
            "        dbg_ts[threadIdx.x >> 6][threadIdx.x & 63];" + text[last:])


def variants(src: str) -> dict:
    out = {"base": src,
           "cut_launch": sub(src, START, START + "  if (blockIdx.x >= 0) return;\n"),
           "cut_prologue": sub(src, PROLOGUE_END, PROLOGUE_END.replace(
               "__syncthreads();\n", "__syncthreads();\n  if (blockIdx.x >= 0) return;\n"))}
    for k in range(1, 5):
        out[f"cut_stage{k}"] = sub(src, STAGE_END, STAGE_END.replace(
            "    }\n  }\n", f"    }}\n    if (s == {k}) return;\n  }}\n"))
    out["x_skipped"] = cut(cut(src, *X_BLOCK), *X_TRANSPOSE).replace(
        "  if (vec_io) mbar_wait(bar_s(2), 0);\n", "")
    out["chunks_rolled"] = sub(src, CHUNK_LOOP, CHUNK_LOOP.replace("#pragma unroll\n", "#pragma unroll 1\n"))
    out["warpgroups3"] = sub(src, "constexpr int kWarpgroups = 2;", "constexpr int kWarpgroups = 3;")
    out["pipelined"] = pipelined(src)
    out["no_weight_wait"] = sub(src, WAIT, "    if (s < 3) " + WAIT.lstrip())
    out["no_stage_fence"] = sub(src, FENCE, FENCE.replace("    fence_proxy_async();\n", ""))
    out["no_out_stores"] = sub(src, STORE, "              if (y0 == 12345.f) sm32[q] = 0u;\n")
    out["timeline"] = timeline(src)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default="", help="comma-separated names (default: all)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("drb_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from time_kernels import cuda_ms, drb_params

    from downgan_tpu_torch.ops.cuda import drb

    texts = variants(drb.SOURCE.read_text())
    if args.variants:
        texts = {k: texts[k] for k in args.variants.split(",")}
    build = ROOT / "build" / "drb_variants"
    build.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = build / f"drb_{name}.cu"
        src.write_text(text)
        so = build / f"libdrb_{name}.so"
        procs[name] = (src, so, subprocess.Popen([drb._nvcc(), *drb.NVCC_FLAGS, "-o", str(so), str(src)],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                 text=True))
    built = {}
    for name, (src, so, proc) in procs.items():
        log = proc.communicate()[0]
        built[name] = so if proc.returncode == 0 else None
        print(json.dumps({"variant": name, "built": proc.returncode == 0,
                          "ptxas": sorted({ln.split(":", 1)[1].strip() for ln in log.splitlines()
                                           if "Used" in ln}),
                          "serialized": sorted({m.group(0) for m in re.finditer(r"\(C75\d\d\)[^']*", log)}),
                          "errors": log[-1500:] if proc.returncode else ""}), flush=True)

    def load(so):
        drb._lib = None
        drb.library_path = lambda: so  # already built: load_library only loads it
        return drb.load_library()

    rng = torch.Generator().manual_seed(1234)
    cases = []
    for shape in SHAPES:
        ws, bs = drb_params(shape[1], rng, "cuda")
        x = torch.randn(*shape, generator=rng).cuda().to(torch.bfloat16)
        with torch.inference_mode():
            twin = drb.drb_forward_reference(x, ws, bs).double()
        cases.append((shape, x, ws, bs, drb.pack_drb_weights(ws, bs, torch.bfloat16), twin))
    card = torch.cuda.get_device_name(0)
    for rep in range(2):
        for name, so in built.items():
            if so is None or name == "timeline":
                continue
            load(so)
            row = {"variant": name, "repeat": rep, "card": card}
            with torch.inference_mode():
                for shape, x, ws, bs, packed, twin in cases:
                    key = "x".join(map(str, shape))
                    got = drb.drb_forward(x, ws, bs, packed).double()
                    ulp = 2.0 ** (math.floor(math.log2(twin.abs().max().item())) - 7)
                    row["ulps_" + key] = (got - twin).abs().max().item() / ulp
                    row["ms_" + key] = cuda_ms(
                        lambda: drb.drb_forward(x, ws, bs, packed), iters=50)
            print(json.dumps(row), flush=True)
    if built.get("timeline"):
        load(built["timeline"])
        for shape, x, ws, bs, packed, twin in cases[:3:2]:  # B=150 and B=128
            with torch.inference_mode():
                for _ in range(20):
                    out = drb.drb_forward(x, ws, bs, packed)
                torch.cuda.synchronize()
                ts = out.reshape(-1).view(torch.int64)[:128].cpu().tolist()
            for wg in range(2):
                t = ts[64 * wg:64 * wg + 64]
                rel = {"prologue": {k: t[i] - t[0] for k, i in (
                    ("zeroed_copies_issued", 57), ("x_arrived", 58), ("x_transposed", 59), ("end", 1))}}
                for s in range(1, 6):
                    b = 2 + (s - 1) * 11
                    rel[f"stage{s}"] = {"weights_in": t[b] - t[0],
                                        "tiles_commit_wait_epilogue": [t[b + 1 + i] - t[0] if t[b + 1 + i] else None
                                                                       for i in range(9)],
                                        "barrier": t[b + 10] - t[0]}
                rel["end"] = t[63] - t[0]
                print(json.dumps({"timeline": list(shape), "warpgroup": wg, "sm_clocks": rel, "card": card}),
                      flush=True)
    load(built["base"]) if built.get("base") else None
    shape, x, ws, bs, packed, twin = cases[2]
    with torch.inference_mode():
        drb.drb_forward(x, ws, bs, packed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            drb.drb_forward(x, ws, bs, packed)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"host_us_per_drb_forward_call": host_us, "shape": list(shape), "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
