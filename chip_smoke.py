#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``downgan_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- the card (``nvidia-smi`` name and power limit on a line of
               its own), torch and CUDA versions;
2. build    -- builds ``downgan_tpu_torch/ops/cuda/drb.cu`` for sm_90a from
               the checkout, with the compiler's register report (and fails
               on a spill);
3. kernel   -- the DRB kernel against its plain PyTorch twin on the card
               (TF32 off), at the generator's shapes, domain bands, images of
               several 16x16 tiles (halo'd on every side, ragged) and F=8;
               at B=150 and at a domain band it times the kernel, the twin
               and the cuDNN five-conv chain beside the kernel's bound (the
               3xTF32 tensor-core floor, or the bytes if they take longer);
4. generator-- the florida generator at full width (1,696,514 params,
               seeded weights): the kernel path against every DRB on the
               plain twin at B=150, against the CPU at B=2, and its forward
               throughput;
5. profile  -- ``torch.profiler`` over 3 forwards at B=150: device time by
               kernel name (a report: where the profiler sees no device
               time it says so and the run goes on);
6. serving  -- the main path: ``serve_model(BatchingSRModel(...))`` answers
               concurrent /v1/generate requests and a /v1/generate-domain
               request over HTTP; responses are checked against direct
               calls, /metrics against the traffic, and the DRB kernel's
               launch count (reset just before) against 48 per dispatch.

Then it prints ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX or of the JAX package ``downgan_tpu``.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_ATOL = KERNEL_RTOL = 1e-5  # 3xTF32 tensor-core products vs fp32, sums of <= 720 terms
GEN_ATOL = GEN_RTOL = 1e-4  # the same difference carried through 48 DRBs
SERVE_ATOL = 1e-6  # same program and batch shape on both sides
B_MAIN = 150  # Config.chunk_size and the serving batch
# Dense peaks (NVIDIA data sheets, no sparsity), at the card's full power
# limit: fp32 outside the tensor cores and TF32 on them in TFLOP/s, HBM in TB/s.
PEAKS = (("H100 PCIe", 51.2, 378.0, 2.0), ("H100 NVL", 60.0, 417.5, 3.9),
         ("H100", 67.0, 495.0, 3.35), ("H200", 67.0, 495.0, 4.8))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_peaks(name: str):
    for key, *rates in PEAKS:
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates known for {name!r}")


def drb_params(f: int, rng: torch.Generator, device):
    """Random DRB weights with the generator's init bound, U(+-1/sqrt(fan_in))."""
    ws, bs = [], []
    for s in range(1, 6):
        bound = 1.0 / (9 * s * f) ** 0.5
        ws.append(((torch.rand(f, s * f, 3, 3, generator=rng) * 2 - 1) * bound).to(device))
        bs.append(((torch.rand(f, generator=rng) * 2 - 1) * bound).to(device))
    return ws, bs


def drb_flops(b: int, f: int, h: int, w: int) -> int:
    return sum(2 * 9 * (s * f) * f * h * w for s in range(1, 6)) * b


@contextlib.contextmanager
def drbs_on_plain_twin(gen):
    """Route every DRB of ``gen`` through the plain twin, for the yardstick."""
    from downgan_tpu_torch.models.generator import DenseResidualBlock
    from downgan_tpu_torch.ops.cuda.drb import drb_forward_reference

    def plain(block, x):
        return drb_forward_reference(x, *block.stage_params())

    blocks = [m for m in gen.modules() if isinstance(m, DenseResidualBlock)]
    for m in blocks:
        m.forward = functools.partial(plain, m)
    try:
        yield len(blocks)
    finally:
        for m in blocks:
            del m.forward


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    return smi, name


def phase_build():
    from downgan_tpu_torch.ops.cuda import drb

    t0 = time.perf_counter()
    drb.load_library()
    seconds = time.perf_counter() - t0
    lines = drb.library_path().with_suffix(".log").read_text().splitlines()
    usage, instance = {}, "?"
    for ln in lines:  # "Compiling entry function '..drb_kernelILi16ELi18EE..'", then "Used"
        found = re.search(r"drb_kernelILi(\d+)ELi(\d+)E", ln)
        if found:
            instance = "F={} pitch={}".format(*found.groups())
        elif "Used" in ln:
            usage[instance] = ln.split(":", 1)[1].strip()
    spills = [ln.strip() for ln in lines
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    emit("build", seconds=seconds, library=str(drb.library_path().relative_to(ROOT)),
         ptxas=usage, spills=spills)
    check(not spills, f"the DRB kernel spills registers: {spills}")


def cudnn_chain(x, ws, bs):
    """The same DRB as five cuDNN convolutions and concats: the library
    yardstick (no single PyTorch call computes a DRB)."""
    acts = x
    for s in range(5):
        y = torch.nn.functional.conv2d(acts, ws[s], bs[s], padding=1)
        if s < 4:
            acts = torch.cat([acts, torch.nn.functional.leaky_relu(y, 0.01)], 1)
    return y * 0.2 + x


def time_drb(x, ws, bs, want, peaks):
    """Kernel, plain twin and cuDNN-chain times for one DRB input, beside
    the kernel's bound for the same work: the larger of its 3xTF32
    tensor-core floor (three TF32 products per fp32 product) and its bytes
    at the memory rate. The fp32 CUDA-core time of the same FLOP is printed
    for information."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward, drb_forward_reference, pack_drb_weights

    check(torch.allclose(cudnn_chain(x, ws, bs), want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
          "the cuDNN five-conv chain disagrees with the plain twin")
    packed = pack_drb_weights(ws, bs)
    kernel_ms = cuda_ms(lambda: drb_forward(x, ws, bs, packed), iters=50)
    plain_ms = cuda_ms(lambda: drb_forward_reference(x, ws, bs), iters=20)
    library_ms = cuda_ms(lambda: cudnn_chain(x, ws, bs), iters=50)
    torch.backends.cudnn.allow_tf32 = True  # for information: not the same precision
    try:
        tf32_err = (cudnn_chain(x, ws, bs) - want).abs().max().item()
        tf32_ms = cuda_ms(lambda: cudnn_chain(x, ws, bs), iters=50)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    b, f, h, w = x.shape
    fp32_tflops, tf32_tflops, tbps = peaks
    flops = drb_flops(b, f, h, w)
    nbytes = 2 * x.numel() * 4 + packed.numel() * 4
    floor_ms = 3 * flops / (tf32_tflops * 1e12) * 1e3
    bytes_ms = nbytes / (tbps * 1e12) * 1e3
    bound_ms = max(floor_ms, bytes_ms)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timing = dict(shape=[b, f, h, w], ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                  bound_ms=bound_ms, bound_by="operations" if floor_ms >= bytes_ms else "bytes",
                  tf32_floor_ms=floor_ms, share_of_bound=bound_ms / kernel_ms,
                  fp32_cuda_core_ms_information=flops / (fp32_tflops * 1e12) * 1e3,
                  vs_library=library_ms / kernel_ms, flops=flops, bytes=nbytes,
                  fp32_tflops_peak=fp32_tflops, tf32_tflops_peak=tf32_tflops, hbm_tbps_peak=tbps,
                  achieved_tflops=flops / (kernel_ms * 1e-3) / 1e12,
                  ctas=b * -(-h // 16) * -(-w // 16), sms=sms,
                  cudnn_tf32_on_ms_not_same_precision=tf32_ms,
                  cudnn_tf32_on_max_abs_err_vs_twin=tf32_err)
    if (h, w) == (16, 16):  # the tail of whole-sample units: one and two per SM
        for n in (sms, 2 * sms):
            xn = torch.randn(n, f, h, w, device=x.device)
            timing[f"ms_at_b{n}"] = cuda_ms(lambda: drb_forward(xn, ws, bs, packed), iters=50)
    emit("kernel_timing", **timing)
    return timing


def phase_kernel(rng, peaks):
    """The kernel against its twin at every shape; times at the generator's
    shape (B=150, the main path's) and at the domain band."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward, drb_forward_reference

    shapes = [(1, 16, 16, 16), (3, 16, 16, 16), (B_MAIN, 16, 16, 16), (8, 16, 32, 56),
              (8, 16, 32, 112), (3, 8, 16, 16), (2, 8, 12, 20), (2, 16, 56, 112),
              (1, 16, 37, 53), (1, 8, 40, 24)]
    timed = {(B_MAIN, 16, 16, 16): None, (8, 16, 32, 112): None}
    errors = {}
    with torch.inference_mode():
        for shape in shapes:
            ws, bs = drb_params(shape[1], rng, "cuda")
            x = torch.randn(*shape, generator=rng).cuda()
            got = drb_forward(x, ws, bs)
            want = drb_forward_reference(x, ws, bs)
            torch.cuda.synchronize()
            errors[shape] = abs_err = (got - want).abs().max().item()
            rel_err = ((got - want).abs() / want.abs().clamp_min(1e-3)).max().item()
            ok = torch.allclose(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
            emit("kernel", shape=list(shape), max_abs_err=abs_err, max_rel_err=rel_err,
                 atol=KERNEL_ATOL, rtol=KERNEL_RTOL, ok=ok)
            check(ok, f"DRB kernel disagrees with its plain twin at {shape}: {abs_err}")
            if shape in timed:
                timed[shape] = time_drb(x, ws, bs, want, peaks)
    return max(errors.values()), timed[(B_MAIN, 16, 16, 16)], timed[(8, 16, 32, 112)]


def phase_generator(config, rng):
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.state import make_generator

    gen = make_generator(config, "cuda", rng=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == 1_696_514, f"florida generator has {n_params} params, not 1,696,514")
    x = torch.randn(B_MAIN, config.n_covariates, config.coarse_size, config.coarse_size,
                    generator=rng).cuda()
    shape = (B_MAIN, config.n_predictands, config.fine_size, config.fine_size)
    cpu_gen = copy.deepcopy(gen).cpu()  # outside inference mode: real parameters
    with torch.inference_mode():
        before = drb_forward.launches
        out = gen(x)
        torch.cuda.synchronize()
        per_forward = drb_forward.launches - before
        with drbs_on_plain_twin(gen) as n_drb:
            ref = gen(x)
        check(tuple(out.shape) == shape and bool(torch.isfinite(out).all()),
              f"generator output {tuple(out.shape)} is not finite {shape}")
        check(per_forward == n_drb == 48, f"{per_forward} kernel launches for {n_drb} DRBs")
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, atol=GEN_ATOL, rtol=GEN_RTOL),
              f"generator: kernel path vs plain twin max abs err {err}")
        cpu_err = (gen(x[:2]).cpu() - cpu_gen(x[:2].cpu())).abs().max().item()
        check(cpu_err <= GEN_ATOL * max(1.0, ref.abs().max().item()),
              f"generator: card vs CPU max abs err {cpu_err}")
        fwd_ms = cuda_ms(lambda: gen(x), iters=10)
    emit("generator", params=n_params, batch=B_MAIN, out_shape=list(shape),
         drb_launches_per_forward=per_forward, max_abs_err_vs_plain_twin=err,
         max_abs_err_vs_cpu_b2=cpu_err, atol=GEN_ATOL, rtol=GEN_RTOL,
         forward_ms=fwd_ms, patches_per_s=B_MAIN / (fwd_ms * 1e-3))
    return gen


def kernel_class(name: str) -> str:
    low = name.lower()
    if "drb_kernel" in low:
        return "drb_kernel"
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "implicit")):
        return "cudnn_conv"
    if "pixel" in low or "copy" in low or "permute" in low:
        return "copy_or_pixel_shuffle"
    return "elementwise_and_other"


def phase_profile(config, gen, rng):
    """Device time by kernel over 3 generator forwards at B=150, from
    ``torch.profiler``. A report: if the profiler records no device time,
    it says so and the run goes on."""
    from torch.profiler import ProfilerActivity, profile

    n_fwd = 3
    x = torch.randn(B_MAIN, config.n_covariates, config.coarse_size, config.coarse_size,
                    generator=rng).cuda()
    with torch.inference_mode():
        gen(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(n_fwd):
                gen(x)
            end.record()
            torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    kernels, classes = [], {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        cls = kernel_class(evt.key)
        kernels.append({"kernel": evt.key[:110], "class": cls, "ms_per_forward": us / 1e3 / n_fwd,
                        "calls_per_forward": evt.count / n_fwd})
        entry = classes.setdefault(cls, {"ms_per_forward": 0.0, "calls_per_forward": 0.0})
        entry["ms_per_forward"] += us / 1e3 / n_fwd
        entry["calls_per_forward"] += evt.count / n_fwd
    if not kernels:
        emit("profile", note="device time not measured: the profiler recorded no device events")
        return
    kernels.sort(key=lambda k: -k["ms_per_forward"])
    busy = sum(k["ms_per_forward"] for k in kernels)
    emit("profile", forwards=n_fwd, batch=B_MAIN, forward_ms_events=window_ms / n_fwd,
         device_busy_ms_per_forward=busy, device_busy_share=busy * n_fwd / window_ms,
         by_class=classes, kernels=kernels[:15])


def phase_serving(config, gen, rng):
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.serving import (BatchingSRModel, SRModel, generate_domain_remote,
                                           generate_remote, serve_model)

    weights = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    model = BatchingSRModel(config, weights, batch_size=B_MAIN, max_wait_ms=20.0)
    direct = SRModel(config, weights, batch_size=B_MAIN)
    server = serve_model(model, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        cs, c = config.coarse_size, config.n_covariates
        n_clients, n_requests, n_patches = 8, 3, 8
        inputs = [[torch.randn(n_patches, cs, cs, c, generator=rng).numpy()
                   for _ in range(n_requests)] for _ in range(n_clients)]
        domain = torch.randn(2, 56, 112, c, generator=rng).numpy()
        results = [[None] * n_requests for _ in range(n_clients)]
        errors = []
        barrier = threading.Barrier(n_clients)

        def client(i):
            try:
                barrier.wait()
                for r in range(n_requests):
                    results[i][r] = generate_remote(url, inputs[i][r])
            except Exception as exc:  # noqa: BLE001 -- reported and failed below
                errors.append((i, repr(exc)))

        drb_forward.launches = 0  # the main path's run starts here
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        patch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fields = generate_domain_remote(url, domain, tile_rows=16, overlap=8)
        domain_s = time.perf_counter() - t0
        launches = drb_forward.launches  # the main path's run ends here
        metrics = json.loads(urllib.request.urlopen(f"{url}/metrics").read())
        check(not errors and not any(t.is_alive() for t in clients), f"client errors {errors}")

        n_req = n_clients * n_requests
        check(metrics["requests"] == n_req + 1, f"/metrics requests {metrics['requests']}")
        check(metrics["samples"] == n_req * n_patches + 2, f"/metrics samples {metrics['samples']}")
        check(3 <= metrics["dispatches"] <= n_req + 1, f"/metrics dispatches {metrics['dispatches']}")
        check(launches == 48 * metrics["dispatches"],
              f"{launches} DRB kernel launches for {metrics['dispatches']} dispatches")
        patch_err = 0.0
        for i in range(n_clients):
            for r in range(n_requests):
                got = results[i][r]
                check(got.shape == (n_patches, config.fine_size, config.fine_size,
                                    config.n_predictands) and np.isfinite(got).all(),
                      f"client {i} request {r}: bad response {got.shape}")
                patch_err = max(patch_err, float(np.abs(got - direct.generate(inputs[i][r])).max()))
        want = direct.generate_domain(domain, tile_rows=16, overlap=8)
        check(fields.shape == (2, 56 * 8, 112 * 8, config.n_predictands)
              and np.isfinite(fields).all(), f"domain response {fields.shape}")
        domain_err = float(np.abs(fields - want).max())
        check(patch_err <= SERVE_ATOL and domain_err <= SERVE_ATOL,
              f"served vs direct: patches {patch_err}, domain {domain_err}")
    finally:
        server.shutdown()
        server.server_close()
        model.close()
    emit("serving", requests=n_req, patches=n_req * n_patches, patch_phase_s=patch_s,
         patches_per_s=n_req * n_patches / patch_s, domain_request_s=domain_s,
         domain_shape=list(domain.shape), metrics=metrics, drb_launches=launches,
         max_abs_err_patches=patch_err, max_abs_err_domain=domain_err, atol=SERVE_ATOL)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from downgan_tpu_torch.config.config import Config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, name = phase_device()
    peaks = card_peaks(name)
    phase_build()
    rng = torch.Generator().manual_seed(1234)
    kernel_err, timing, band = phase_kernel(rng, peaks)
    config = Config.from_json((ROOT / "examples" / "florida.json").read_text())
    gen = phase_generator(config, rng)
    phase_profile(config, gen, rng)
    launches = phase_serving(config, gen, rng)
    check(launches > 0, "the main path launched no DRB kernel")
    print(json.dumps({"kernels": [{
        "name": "drb_forward", "route": "cuda", "impl": "cuda",
        "source": "downgan_tpu_torch/ops/cuda/drb.cu",
        "replaces": "downgan_tpu/ops/pallas/drb.py:120",
        "launches": launches, "max_abs_err": kernel_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"],
        "tf32_floor_ms": timing["tf32_floor_ms"], "shape": timing["shape"],
        "band": {k: band[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "tf32_floor_ms",
                                      "library_ms")},
        "card": smi}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
