#!/usr/bin/env python3
"""Measure the throughput of ``wgmma.mma_async`` m64nNk16 (bf16, both
operands in shared memory, K-major without swizzle) on one CUDA card, for
N = 16 (the bf16 DRB kernel's width at F = 16) and wider.

    python3 tools/wgmma_rate.py [--chains 200] [--steps 45]

Builds ``tools/wgmma_rate.cu`` with ``nvcc`` for sm_90a into
``build/wgmma_rate/`` and runs, for each N and each number of warpgroups
resident per SM (A's core matrices contiguous, SBO 8, or overlapping by
two rows, SBO 6, as the DRB kernel reads them), one CTA per SM (or two)
whose warpgroups issue ``chains``
chains of ``steps`` k-steps each (one commit and wait per chain), as the
DRB kernel's stages do. Prints one JSON line per configuration: the time
from CUDA events, the bf16 TFLOP/s reached, its share of the card's dense
bf16 peak, and the SM clocks each wgmma takes per SM at the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "wgmma_rate.cu"
BUILD = HERE.parent / "build" / "wgmma_rate"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=200)
    parser.add_argument("--steps", type=int, default=45, help="k-steps per chain, a multiple of 9")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wgmma_rate: no CUDA device", file=sys.stderr)
        return 1
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / "libwgmma_rate.so"
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.wgmma_rate.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    lib.wgmma_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = torch.cuda.get_device_name(0)
    out = torch.zeros(4 * sms, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for n, sbo in ((16, 8), (32, 8), (48, 8), (64, 8), (16, 6), (48, 6)):
        for per_sm, warpgroups in ((1, 1), (1, 2), (1, 3), (1, 4), (2, 2), (2, 3)):
            ctas = per_sm * sms

            def launch():
                err = lib.wgmma_rate(n, ctas, warpgroups, args.chains, args.steps, sbo,
                                     out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            launch()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                launch()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
            per_sm_wgmmas = per_sm * warpgroups * args.chains * args.steps
            flops = 2 * 64 * n * 16 * per_sm_wgmmas * sms
            rows.append(dict(n=n, a_sbo_16b=sbo, ctas_per_sm=per_sm, warpgroups_per_cta=warpgroups, ms=ms,
                             tflops=flops / (ms * 1e-3) / 1e12, ns_per_wgmma_per_sm=ms * 1e6 / per_sm_wgmmas))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    mhz = float(smi.split()[0])
    for row in rows:
        row.update(share_of_bf16_peak=row["tflops"] / 989.0,
                   clocks_per_wgmma_per_sm_at_max_clock=row["ns_per_wgmma_per_sm"] * mhz * 1e-3,
                   nvidia_smi=smi, card=name)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
