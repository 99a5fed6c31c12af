#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``downgan_tpu_torch``): the
end-to-end flows that the CPU tests cannot run, checked on one CUDA card.

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It measures no speed: the benchmark (``python3 -m portbench.run``) times
the port end to end and ``tools/time_kernels.py`` times each kernel alone.
The kernels against their plain twins, shape by shape, are the
``cuda``-marked tests of ``tests/test_torch_*.py``; the smoke runs their
cases at the main paths' shapes (``KERNEL_TESTS``).

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- the card (``nvidia-smi`` name and power limit on a line of
               its own), torch and CUDA versions;
2. build    -- builds ``downgan_tpu_torch/ops/cuda/drb.cu`` (the fp32, bf16
               and wide DRB kernels, the backward kernels and their
               reductions)
               for sm_90a from the checkout, with the compiler's register
               report (and fails on a spill); kernels -- ``KERNEL_TESTS``
               by pytest in a child process, each kernel's wrapper against
               its plain twin at the main paths' shapes (fp32 at B=150, 128
               and the spatial halo bands, the backward kernel at B=128,
               bf16 at B=150 and 128, wide and its backward kernel at
               B=128): all pass, none skip;
3. generator-- the florida generator at full width (1,696,514 params,
               seeded weights): the kernel path against every DRB on the
               plain twin at B=150 and against the CPU at B=2, and a
               generator built inside ``torch.inference_mode()`` against the
               normal build, bit for bit; generator_bf16 the same in bf16
               (48 bf16 launches a forward);
4. serving  -- the serving path: ``serve_model(BatchingSRModel(...))``
               answers concurrent /v1/generate requests and a
               /v1/generate-domain request over HTTP; responses are checked
               against direct calls, /metrics against the traffic, and the
               DRB kernel's launch count (reset just before) against 48 per
               dispatch;
5. esrgan   -- ESRGAN at its published widths (``generator_arch:
               "esrgan"``): the generator (17,068,994 params) through
               ``make_generator`` at B=128, 69 wide launches a forward,
               against its DRBs on the twin; a 5-step round of
               ``Trainer.step_fn`` at B=32, 759 wide launches and 69 wide
               backward kernels, no recompute;
6. train_parity -- six florida train steps (full width, batch 4) on the card
               and on the CPU from the same weights and alphas: step-0
               gradients, per-step losses and metrics, the final parameters,
               48 DRB launches per generator forward, and the kernel path
               after a generator update against the plain-twin path (the
               packed weights were refreshed); fused_parity one fused round
               of examples/production_tuned.json at batch 4, card against
               CPU, in fp32 (the same tolerances) and in bf16 (loose ones);
7. variants_parity -- three florida steps at batch 4 with every training
               variant on (frequency separation, the conditional critic,
               flips, the divergence, vorticity and EOF terms, grad_accum 2,
               a cosine schedule with warmup) and critic_iterations 2, so
               that the generator's second update runs at the full rate,
               card against CPU from the same weights, EOF basis, alphas and
               flip masks, 48 DRB launches in every generator forward;
8. training -- ``cli train --config examples/florida.json --synthetic
               --samples 1440 --epochs 2`` in-process at florida batch 128:
               its epoch means, 48 DRB launches in each of its generator
               forwards (counted by kind), 48 backward kernels and no
               recompute a generator update;
9. training_tuned -- ``cli train --config examples/production_tuned.json
               --synthetic --samples 1440 --epochs 2`` (bf16, fused
               5-critic rounds, the metric pass on the reused fake): 2 rounds
               an epoch, 28 generator forwards, 1,344 bf16 DRB launches;
               serving_bf16 that run restored as ``serve --checkpoint``
               restores it (a bf16 model) and served over HTTP, patches and a
               domain request against the bf16 model's direct forward;
10. resume  -- the same command as 8, checkpointed, sent SIGTERM after its
               step 3 and run again with ``--resume``, against an
               uninterrupted run (epoch-1 means, every parameter and Adam
               moment: bit for bit, cuDNN deterministic), once plain and once
               with ``hp.ema_decay = 0.999`` and ``--track-best MSSSIM``; the
               best bundle, restored through ``serve --checkpoint``'s
               resolution, served over HTTP against the EMA generator's direct
               forward; 48 DRB launches in every generator forward (test
               passes and EMA scoring included); the kernel path against the
               twin after EMA updates and after a checkpoint load;
               checkpoint bytes;
11. host_feed -- the same command as 8 with ``--host-feed`` (the set in
               host RAM, batches through pinned buffers and a copy stream),
               cuDNN deterministic, held bit for bit against 10's
               uninterrupted plain run (every epoch's means, the final
               state); 48 DRB launches per generator forward;
12. stream  -- the same 1,440 samples as int16 CF-packed ``(time, var, lat,
               lon)`` files on disk (``np.memmap``s, so no h5py is needed;
               the CPU tests hold NetCDF staging to the JAX package),
               trained two epochs through ``LazyField``/``StreamDataset``
               and the feed, held bit for bit against a host-fed run on the
               same decoded arrays; whether the native host library built;
13. stochastic -- ``cli train --config examples/florida.json --synthetic
               --samples 1440 --epochs 1 --noise-channels 4`` in-process (the
               stochastic RRDB, 1,697,090 params): 48 DRB launches in every
               generator forward, finite means, the card's forward against
               the CPU's with the same weights and latent at B=2, and the
               fp32 and bf16 forwards with the latent at B=150 (48 fp32 or
               bf16 launches);
14. ensemble -- ``ensemble_metrics`` with 8 members over that run's
               144-sample test split (CRPS, spread, MAEs) against a float64
               numpy computation of the same members, each member drawn twice
               bit for bit;
15. serving_stochastic -- that generator served over HTTP: coalesced
               requests equal to direct calls bit for bit (the fixed latent
               in each request's own block layout) and a domain request (the
               whole-domain latent) equal to the direct tiler's;
16. generate -- batch generation (``cli generate``'s loop): the training
               phase's checkpoint restored through ``generate``'s source
               resolution, 1,440 synthetic samples through
               ``generate_fields_iter`` (10 chunks of 150, a 90-row tail, 480
               DRB launches) equal to ``generate_fields`` bit for bit; the
               streamed writer's block source (``generated_blocks``) equal to
               the in-memory result bit for bit, plain, tiled with
               ``--tile-rows 16`` and a 4-member ensemble of the stochastic
               generator (the block source needs no h5py: no file is
               written); 4 samples against the CPU; the same in bf16 from the
               training_tuned run;
17. evaluate -- ``cli evaluate`` in-process: the training phase's
               checkpoint over 1,440 synthetic samples (12 batches, 48 DRB
               launches each); at 144 samples the same against the command on
               the CPU, the resume phase's EMA run with ``--ema``, the
               exported bundle (``--weights-only``: no Wass, the warning on
               stderr) and ``--ensemble 4`` on the stochastic run;
18. tiles_split -- ``tiled_sr_inference(devices=["cuda:0", "cuda:0"])``
               against one device on 8 samples of 32x112, deterministic and
               stochastic, bit for bit, and a ``BatchingSRModel`` over two
               replicas against one;
19. srresnet -- ``cli train ... --epochs 1 --generator-arch srresnet`` (the
               SRResNet family, 115,414 params, no DRB and so no
               hand-written kernel), its forward against the CPU's at B=2,
               and the trained model served over HTTP;
20. variants -- ``cli train --config examples/florida.json --synthetic
               --samples 1440 --epochs 1`` with every variant's flag (the
               EOF basis fit at staging), and again from a config file with
               the physics terms and metrics: epoch means, launches by
               kind, and a lone critic update's peak memory lower with
               grad_accum 2 than with 1;
21. variants_tuned -- ``cli train --config examples/production_tuned.json
               ... --epochs 1 --augment-flips --critic-conditional
               --grad-accum 2``: bf16 fused rounds, 768 bf16 DRB launches.
22. dp      -- data-parallel training at florida width: (a) ``python -m
               torch.distributed.run --nproc-per-node 1 -m
               downgan_tpu_torch.cli train --synthetic --samples 1440
               --epochs 1 --multihost`` (NCCL, world size 1; run as
               ``chip_smoke.py --train-cli OUT train ...``, which holds cuDNN
               deterministic and counts launches) against the plain command,
               epoch means and checkpoint bit for bit; two ranks building
               ``drb.cu`` at once; (b) two gloo ranks sharing the card
               (``Trainer(multihost=True)``, 64 rows each of a global batch
               of 128), six fp32 reference steps, the ranks bit for bit and
               each within the Adam tolerances of one rank on the global
               batch; (c) the same for two bf16 fused rounds of
               examples/production_tuned.json. 48 DRB launches in every
               forward of every rank; the epoch's means of 2 ranks within
               the card step tolerances of one rank's.
23. spatial -- halo-exchange spatial sharding at florida width and depth:
               four gloo ranks sharing the card as a 2 x 2 (data, spatial)
               grid. (a) ``sharded_generator_apply`` at B=150 over 2 shards
               (8 coarse rows a rank, DRB bands of 13 rows) and 4 (4 rows,
               halos from two neighbours), 48 DRB launches a forward a rank
               on halo-extended bands, against the unsharded forward (bit
               for bit expected; else within 1e-5, the first stage that
               differs named); (b) at B=32 over 2 shards against the
               unsharded networks: the sharded generator's parameter
               gradients of a scalar of its output (the DRB backward over
               the bands, the halos' adjoints), and ``sharded_critic_apply``,
               the GP and its parameter gradients (the double backward
               through the collectives); (c) six steps of
               ``build_spatial_train_step`` at B=32 over 2 ranks, bit for
               bit across the ranks, each within the Adam tolerances of one
               process's ``build_train_step``; (d) two steps of
               ``build_dp_spatial_train_step`` on the grid against 2-rank
               data parallelism on the same global batch of 32.
24. tooling -- the rest of the CLI, in-process: ``profile`` (the generator
               forward at B=150, 3 fp32 reference steps at B=128, 2 bf16
               fused rounds; a Chrome trace naming the DRB kernel, 48
               launches a generator forward), the FLOP census of florida
               (``meta`` equal to the CPU's, beside the JAX package's
               figures), ``tune`` over two candidates in their own processes
               and ``show-config`` of its recommendation, ``import-torch`` of
               a seeded florida generator and critic (the bundle bit for bit
               the direct load) and ``export-torch`` of the training run's
               checkpoint imported again, grid rows on the card against the
               CPU, the figures' note without matplotlib, ``export-mlflow``
               of the training run and ``serve-tracking`` over its root.

Then it prints ``{"kernels": [...]}``: each hand-written kernel's
launches on the main paths above, by path, and its bound at the main
paths' shapes from the benchmark's own functions. Last it prints ``{"ok":
true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``. It imports nothing of JAX or of the JAX package
``downgan_tpu``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import functools
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_ATOL = KERNEL_RTOL = 1e-5  # 3xTF32 tensor-core products vs fp32, sums of <= 720 terms
GEN_ATOL = GEN_RTOL = 1e-4  # the same difference carried through 48 DRBs
SERVE_ATOL = 1e-6  # same program and batch shape on both sides
# Step-0 gradient of the generator loss with respect to the fake, card vs
# CPU, outside the elements where the L1 term's sign flips, relative to its
# largest entry: the fake differs by up to GEN_ATOL (1e-4); ten times that.
STEP_GRAD_TOL = 1e-3
# Step-0 parameter gradients (the critic loss's, GP double backward included;
# the generator's for one upstream gradient) are held to a float64 CPU
# backward: they are ill-conditioned in fp32 (a LeakyReLU's slope flips
# where the forward moves by 1e-6; deep in the generator's trunk the
# gradients are ~1e-5), so in their worst tensor the CPU's own fp32
# gradients are up to ~3e-2 off float64, relative to that tensor's largest
# entry, and a single flip decides which tensor that is (this phase's
# report, on the H100).
# Over the whole gradient as one vector the error is stable: the card's
# relative L2 error may be at most twice the CPU fp32's. And no tensor may
# be off by more than 0.1 in relative L2, over three times the worst fp32
# error: a wrong formula gives O(1).
GRAD_VS_CPU_FP32, GRAD_TENSOR_TOL = 2.0, 0.1
# Per-step losses and metrics, card vs CPU: means of fields that differ by
# up to GEN_ATOL, and the critic's scores of them.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# Parameters after six steps: Adam's normalized step can turn an ulp-level
# difference in a near-zero gradient into up to 2 * lr in one element, so
# 2 * lr per update the network took; the bulk (the median element) must
# agree to 1e-5.
ADAM_ATOL_PER_UPDATE, ADAM_MEDIAN_ATOL = 2 * 2.5e-4, 1e-5
B_MAIN = 150  # Config.chunk_size and the serving batch
B_TRAIN = 128  # hp.batch_size of examples/florida.json and production_tuned.json
B_PARITY = 4  # the train_parity and fused_parity phases' batch (the CPU side's cost)
BF16 = torch.bfloat16
# The bf16 florida generator, kernel path against every DRB on the bf16
# twin, relative to the output's largest magnitude: the two paths' DRBs
# are each one rounding flip apart in a few elements (one bf16 ulp is 2**-8
# of a value), carried through 48 blocks and the upsampling convs
# (measured on the H100: 8.0e-3).
GEN_BF16_REL = 2e-2
# A bf16 fused round at batch 4, card against CPU (tests/test_torch_fused.py
# holds the CPU port to JAX's bf16 round the same way): losses and metrics
# to 2e-2 relative or 1e-3 absolute; every parameter within 2 * lr per
# update (Adam's first steps are lr * sign(g), and a small gradient's sign
# can differ between cuDNN's bf16 convolutions and the CPU's; one such
# element of the generator measured 2 * lr apart on the H100), the median
# element within 1e-4 (measured: 1.4e-5).
BF16_STEP_RTOL, BF16_STEP_ATOL, BF16_MEDIAN_ATOL = 2e-2, 1e-3, 1e-4
# Ensemble scores on the card (fp32 sums over 4.7 M points a member)
# against a float64 numpy computation of the same members.
ENSEMBLE_RTOL = 1e-5
# Each hand-written kernel's wrapper against its plain twin at the shapes
# the main paths give it, as cases of the cuda tests: the fp32 forward at
# the serving and training batches and on the spatial path's halo bands
# (13 rows over 2 shards, 9 and 13 over 4); the backward kernel and its
# reduction at the training batch, against the float64 twin on the kernel's
# own sides and bit for bit over calls, and ``DRBFunction`` on that route;
# the bf16 forward at the serving and tuned training batches and bf16
# ``DRBFunction``; the wide forward and wide ``DRBFunction`` at ESRGAN's
# training batch.
KERNEL_TESTS = [
    "tests/test_torch_drb.py::test_cuda_kernel_matches_twin[B150-F16-16x16]",
    "tests/test_torch_drb.py::test_cuda_kernel_matches_twin[B128-F16-16x16]",
    "tests/test_torch_drb.py::test_cuda_kernel_matches_twin[B150-F16-13x16]",
    "tests/test_torch_drb.py::test_cuda_kernel_matches_twin[B150-F16-9x16]",
    "tests/test_torch_drb.py::test_cuda_kernel_matches_twin[B32-F16-13x16]",
    "tests/test_torch_drb.py::test_cuda_kernel_matches_twin[B16-F16-13x16]",
    "tests/test_torch_drb.py::test_cuda_backward_kernel_matches_float64[128-16]",
    "tests/test_torch_drb.py::test_cuda_backward_kernel_is_bit_for_bit_and_computes_only_what_is_needed",
    "tests/test_torch_drb.py::test_cuda_drb_function_gradients_match_the_twin_at_b128",
    "tests/test_torch_drb.py::test_cuda_bf16_kernel_matches_twin[B150-F16-16x16]",
    "tests/test_torch_drb.py::test_cuda_bf16_kernel_matches_twin[B128-F16-16x16]",
    "tests/test_torch_drb.py::test_cuda_bf16_drb_function_gradients_match_float64[reference-inputs]",
    "tests/test_torch_drb.py::test_cuda_bf16_drb_function_gradients_match_float64[init-scale]",
    "tests/test_torch_esrgan.py::test_cuda_wide_kernel_matches_twin_at_b128[B128]",
    "tests/test_torch_esrgan.py::test_cuda_wide_drb_function_backward_matches_autograd_through_the_twin",
    "tests/test_torch_esrgan.py::test_cuda_wide_backward_kernel_matches_float64[128]",
]


def emit(phase: str, **fields) -> None:
    """One JSON line."""
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def reset_launch_counts() -> None:
    from downgan_tpu_torch.ops.cuda.drb import drb_backward, drb_forward

    drb_forward.launches = drb_forward.launches_bf16 = drb_forward.launches_wide = 0
    drb_backward.launches = drb_backward.launches_wide = drb_backward.recomputes = 0


@contextlib.contextmanager
def drb_backward_on_recompute():
    """Every ``DRBFunction`` backward on the cuDNN recompute while the block
    runs: the route the spatial path's DRB bands take (they are not
    16x16). A one-process yardstick of the sharded path then differentiates
    each block on the same LeakyReLU sides as the bands do; the backward
    kernel takes the forward kernel's sides, which differ from cuDNN's
    fp32 recompute where a pre-activation lies within rounding of zero."""
    from downgan_tpu_torch.ops.cuda import drb

    real = drb.backward_on_kernel, drb.backward_on_wide_kernel
    drb.backward_on_kernel = drb.backward_on_wide_kernel = lambda *args, **kwargs: False
    try:
        yield
    finally:
        drb.backward_on_kernel, drb.backward_on_wide_kernel = real


@contextlib.contextmanager
def drbs_on_plain_twin(gen):
    """Route every DRB of ``gen`` through the plain twin, for the yardstick."""
    from downgan_tpu_torch.models.generator import DenseResidualBlock
    from downgan_tpu_torch.ops.cuda.drb import drb_forward_reference

    def plain(block, x):
        return drb_forward_reference(x, *block.stage_params(), slope=block.slope)

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
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         packages=package_versions(("h5py", "netCDF4", "xarray", "scipy", "yaml", "click")))
    return smi, name


def package_versions(names) -> dict:
    """Each package's version, or null where it does not import (what later
    slices, e.g. the NetCDF data tiers on h5py, can count on here)."""
    import importlib

    out = {}
    for pkg in names:
        try:
            out[pkg] = getattr(importlib.import_module(pkg), "__version__", "present")
        except ImportError:
            out[pkg] = None
    return out


def phase_build():
    from downgan_tpu_torch.ops.cuda import drb

    drb.load_library()
    lines = drb.library_path().with_suffix(".log").read_text().splitlines()
    usage, instance = {}, "?"
    for ln in lines:  # "Compiling entry function '..drb_kernel_bf16ILi16ELi18EE..'", then "Used"
        found = re.search(r"15drb_kernel_bf16ILi(\d+)ELi(\d+)E|10drb_kernelILi(\d+)ELi(\d+)E", ln)
        if found:
            bf16 = found.group(1) is not None
            f, pitch = found.groups()[:2] if bf16 else found.groups()[2:]
            instance = "{} F={} pitch={}".format("bf16" if bf16 else "fp32", f, pitch)
        elif "15drb_kernel_wide" in ln and "Compiling" in ln:
            instance = "fp32 wide nf=64 gc=32"
        elif "19drb_backward_kernelILi" in ln and "Compiling" in ln:
            instance = "fp32 backward F={}".format(
                re.search(r"19drb_backward_kernelILi(\d+)E", ln).group(1))
        elif "15drb_grad_reduce" in ln and "Compiling" in ln:
            instance = "fp32 backward reduction"
        elif "24drb_backward_kernel_wide" in ln and "Compiling" in ln:
            instance = "fp32 wide backward nf=64 gc=32"
        elif "20drb_grad_reduce_wide" in ln and "Compiling" in ln:
            instance = "fp32 wide backward reduction"
        elif "20drb_dgrad_frags_wide" in ln and "Compiling" in ln:
            instance = "fp32 wide backward's transposed weights"
        elif "Used" in ln:
            usage[instance] = ln.split(":", 1)[1].strip()
    spills = [ln.strip() for ln in lines
              if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    # ptxas says so where it has to serialize the bf16 kernel's wgmma chains.
    wgmma_notes = sorted({ln.strip() for ln in lines if "Potential Performance Loss" in ln})
    emit("build", library=str(drb.library_path().relative_to(ROOT)),
         ptxas=usage, spills=spills, wgmma_notes=wgmma_notes)
    check(not spills, f"the DRB kernel spills registers: {spills}")
    check(len(usage) == 15, f"expected 15 kernel instances (fp32 and bf16 x F in {{8, 16}} x "
          f"2 pitches, the wide fp32 one, the fp32 backward at F in {{8, 16}} and its "
          f"reduction, the wide backward, its transposed weights and its reduction), the "
          f"compiler reports {sorted(usage)}")


def phase_kernels():
    """``KERNEL_TESTS`` run by pytest in a child process on the card: each
    must pass, none may skip."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernels_") as tmp:
        report = Path(tmp) / "report.xml"
        proc = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest",
                               "-p", "no:cacheprovider", f"--junitxml={report}", *KERNEL_TESTS],
                              cwd=ROOT, capture_output=True, text=True, timeout=900)
        outcomes = {}
        if report.exists():
            for case in ET.parse(report).getroot().iter("testcase"):
                kinds = [c.tag for c in case if c.tag in ("failure", "error", "skipped")]
                outcomes[case.get("name")] = kinds[0] if kinds else "passed"
    passed = sorted(n for n, o in outcomes.items() if o == "passed")
    emit("kernels", tests=len(KERNEL_TESTS), passed=len(passed),
         not_passed={n: o for n, o in outcomes.items() if o != "passed"}, pytest_rc=proc.returncode)
    check(proc.returncode == 0 and len(passed) == len(KERNEL_TESTS),
          f"the kernels' main-path cases: {len(passed)} of {len(KERNEL_TESTS)} passed "
          f"(rc {proc.returncode}):\n{proc.stdout[-4000:]}{proc.stderr[-2000:]}")


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
        # A generator built inside inference mode (inference-tensor
        # parameters, no version counters): its DRBs repack at every
        # forward and give the normal build's output bit for bit.
        inference_gen = make_generator(config, "cuda", rng=torch.Generator().manual_seed(0))
        before = drb_forward.launches
        inference_out = inference_gen(x)
        torch.cuda.synchronize()
        inference_launches = drb_forward.launches - before
        check(all(p.is_inference() for p in inference_gen.parameters()),
              "the generator built in inference mode has parameters that are not inference tensors")
        check(inference_launches == 48 and torch.equal(inference_out, out),
              f"a generator built in inference mode: {inference_launches} launches, "
              f"{(inference_out - out).abs().max().item()} off the normal build")
        del inference_gen
    emit("generator", params=n_params, batch=B_MAIN, out_shape=list(shape),
         drb_launches_per_forward=per_forward, max_abs_err_vs_plain_twin=err,
         max_abs_err_vs_cpu_b2=cpu_err, atol=GEN_ATOL, rtol=GEN_RTOL,
         inference_mode_build_bit_for_bit=True, inference_mode_build_launches=inference_launches)
    return gen


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
        clients = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        fields = generate_domain_remote(url, domain, tile_rows=16, overlap=8)
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
    emit("serving", requests=n_req, patches=n_req * n_patches, domain_shape=list(domain.shape),
         metrics=metrics, drb_launches=launches, max_abs_err_patches=patch_err,
         max_abs_err_domain=domain_err, atol=SERVE_ATOL)
    return launches


def phase_esrgan(rng):
    """ESRGAN at its published widths (the wide DRB kernel alone is held to
    its twin by tests/test_torch_esrgan.py): the generator (filters 64, 23
    RRDBs) through ``make_generator`` at B = 128 against its DRBs on the
    twin, 69 wide launches a forward; then a 5-step round of
    ``Trainer.step_fn`` at B = 32 on 160 synthetic samples, its launches
    counted from zero: 69 wide backward kernels and no recompute. Returns
    the round's wide forward and wide backward launches."""
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.data.dataset import DeviceDataset
    from downgan_tpu_torch.ops.cuda.drb import drb_backward, drb_forward
    from downgan_tpu_torch.training.state import make_generator
    from downgan_tpu_torch.training.trainer import Trainer

    florida = Config.from_json((ROOT / "examples" / "florida.json").read_text())
    config = florida.replace(generator_arch="esrgan", filters=64, num_res_blocks=23)
    gen = make_generator(config, "cuda", rng=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == 17_068_994, f"ESRGAN generator has {n_params} params, not 17,068,994")
    xg = torch.randn(B_TRAIN, config.n_covariates, 16, 16, generator=rng).cuda()
    with torch.inference_mode():
        before = (drb_forward.launches, drb_forward.launches_wide)
        out = gen(xg)
        torch.cuda.synchronize()
        per_forward = (drb_forward.launches - before[0], drb_forward.launches_wide - before[1])
        with drbs_on_plain_twin(gen) as n_drb:
            ref = gen(xg)
        gen_err = ((out - ref).abs().max() / ref.abs().max()).item()
    check(per_forward == (69, 69) and n_drb == 69,
          f"{per_forward} (all, wide) launches a forward for {n_drb} DRBs")
    check(gen_err <= GEN_RTOL, f"ESRGAN generator, kernel path vs twin: {gen_err} of the largest")
    emit("esrgan_generator", params=n_params, batch=B_TRAIN, drb_launches_per_forward=per_forward,
         max_err_vs_twin_relative_to_largest=gen_err, tolerance=GEN_RTOL)
    del gen, out, ref

    # ---- Trainer.step_fn, one 5-step round at B=32
    cfg = config.replace(hp=dataclasses.replace(config.hp, batch_size=32))
    g = torch.Generator().manual_seed(5)
    ds = DeviceDataset(torch.randn(160, 7, 16, 16, generator=g).cuda(),
                       torch.randn(160, 2, 128, 128, generator=g).cuda())
    tr = Trainer(cfg, ds, device="cuda")
    reset_launch_counts()  # the ESRGAN training path's run starts here
    metrics = [tr.step_fn(tr.state, ds.coarse[i * 32:(i + 1) * 32], ds.fine[i * 32:(i + 1) * 32])
               for i in range(5)]
    torch.cuda.synchronize()
    launched = (drb_forward.launches, drb_forward.launches_wide)
    backward_routes = (drb_backward.launches, drb_backward.recomputes)
    finite = all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values())
    # a round: 5 critic fakes, 1 generator update, 5 metric-pass fakes
    check(finite and launched == (69 * 11, 69 * 11), f"ESRGAN round: finite={finite}, "
          f"{launched} (all, wide) launches (69 x 11 wide forwards expected)")
    wide_backward = drb_backward.launches_wide
    check(backward_routes == (69, 0) and wide_backward == 69,
          f"ESRGAN round: {backward_routes} (kernel, recompute) DRB backwards, {wide_backward} "
          f"wide backward kernels (69 and no recompute expected)")
    emit("esrgan_training", batch=32, steps=5, launches=launched[0], wide_launches=launched[1],
         wide_backward_launches=wide_backward,
         critic_loss=[float(m["critic_loss"]) for m in metrics])
    del tr, ds
    return launched[1], wide_backward


def phase_generator_bf16(config, rng):
    """The florida generator computing in bf16 at B=150: every DRB through
    the bf16 kernel (48 launches), against every DRB on the bf16 twin; its
    distance from the fp32 generator with the same weights is reported."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.state import make_generator

    cfg = config.replace(hp=dataclasses.replace(config.hp, compute_dtype="bfloat16"))
    gen = make_generator(cfg, "cuda", rng=torch.Generator().manual_seed(0))
    fp32 = make_generator(config, "cuda", rng=torch.Generator().manual_seed(0))
    x = torch.randn(B_MAIN, config.n_covariates, config.coarse_size, config.coarse_size,
                    generator=rng).cuda()
    with torch.inference_mode():
        before = (drb_forward.launches, drb_forward.launches_bf16)
        out = gen(x)
        torch.cuda.synchronize()
        per_forward = (drb_forward.launches - before[0], drb_forward.launches_bf16 - before[1])
        with drbs_on_plain_twin(gen) as n_drb:
            ref = gen(x)
        want32 = fp32(x)
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        vs_fp32 = (out - want32).abs().max().item()
        check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
              "bf16 generator output is not finite fp32")
        check(per_forward == (48, 48) and n_drb == 48,
              f"{per_forward} (all, bf16) kernel launches for {n_drb} DRBs")
        check(err <= GEN_BF16_REL * scale, f"bf16 generator: kernel path vs plain twin {err}")
    emit("generator_bf16", batch=B_MAIN, drb_launches_per_forward=per_forward[1],
         max_abs_err_vs_plain_twin=err, relative_to_largest=err / scale, tolerance=GEN_BF16_REL,
         max_abs_diff_vs_fp32_generator=vs_fp32, fp32_relative=vs_fp32 / scale)


def float64_copy(module):
    """A float64 copy of ``module`` whose layers compute in float64 (their
    ``compute_dtype`` would cast activations back to fp32)."""
    copied = copy.deepcopy(module).double()
    for m in copied.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return copied


def generator_forward_fp64(gen, x):
    """``Generator.forward`` without its casts (to its compute dtype in, to
    float32 out), for a :func:`float64_copy`."""
    out1 = gen.conv1(x)
    return gen.conv3(gen.upsampling(out1 + gen.conv2(gen.res_blocks(out1))))


def per_tensor_rel_err(got, want):
    """The largest, over tensors, of max |got - want| over max |want|."""
    return max(((g.cpu() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def phase_train_parity(config):
    """Six florida steps (full width, batch 4) on the card and on the CPU
    from the same weights, data and alphas."""
    import dataclasses

    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.ops.losses import content_loss
    from downgan_tpu_torch.training.state import make_train_state
    from downgan_tpu_torch.training.wgan import build_train_step, critic_loss

    n_steps = 6
    cfg = config.replace(hp=dataclasses.replace(config.hp, batch_size=B_PARITY))
    coarse, fine = synthetic_dataset(n_samples=B_PARITY * n_steps, seed=11)
    cpu_ds = DeviceDataset.from_numpy(coarse, fine, "cpu")
    alphas = torch.rand(n_steps, B_PARITY, 1, 1, 1, generator=torch.Generator().manual_seed(12))
    states = {dev: make_train_state(cfg, dev) for dev in ("cuda", "cpu")}
    for name, p in states["cuda"].generator.state_dict().items():
        check(torch.equal(p.cpu(), states["cpu"].generator.state_dict()[name]),
              f"seeded generators differ at {name}")

    def batch(dev, i):
        rows = torch.arange(B_PARITY * i, B_PARITY * (i + 1))
        return [t.to(dev) for t in cpu_ds.gather(rows)]

    def step0_grads(dev, d_fake=None):
        """Step 0's critic-loss gradients; the generator loss's gradient
        with respect to its fake; and the generator's parameter gradients
        for the upstream gradient ``d_fake`` (default: this device's)."""
        st = states[dev]
        coarse0, fine0 = batch(dev, 0)
        with torch.no_grad():
            fake = st.generator(coarse0)
        c_grads = torch.autograd.grad(critic_loss(cfg, st.critic, fake, fine0, alphas[0].to(dev))[0],
                                      list(st.critic.parameters()), allow_unused=True)
        fake = st.generator(coarse0)
        g_loss = (-st.critic(fake).mean() * cfg.hp.gamma
                  + cfg.hp.content_lambda * content_loss(fake, fine0))
        (own,) = torch.autograd.grad(g_loss, fake, retain_graph=True)
        g_grads = torch.autograd.grad(fake, list(st.generator.parameters()),
                                      own if d_fake is None else d_fake.to(dev))
        return c_grads, own, g_grads, fake.detach(), fine0

    # The L1 term's gradient, sign(fake - fine), flips where the two
    # devices' fakes (within GEN_ATOL) straddle the target; the generator's
    # backward is compared for the same upstream gradient (the CPU's).
    cg_cpu, d_fake_cpu, gg_cpu, fake_cpu, fine0 = step0_grads("cpu")
    cg_card, d_fake_card, gg_card, fake_card, _ = step0_grads("cuda", d_fake_cpu)
    flipped = torch.sign(fake_card.cpu() - fine0) != torch.sign(fake_cpu - fine0)
    check(bool((fake_cpu - fine0)[flipped].abs().le(GEN_ATOL).all()),
          "the L1 gradient flips sign away from the target")
    d_fake_err = ((d_fake_card.cpu() - d_fake_cpu)[~flipped].abs().max()
                  / d_fake_cpu.abs().max()).item()
    check(d_fake_err <= STEP_GRAD_TOL, f"step-0 d loss / d fake, card vs CPU: {d_fake_err}")

    # float64 yardsticks on the CPU, for the same inputs.
    with torch.no_grad():
        fake0_cpu = states["cpu"].generator(batch("cpu", 0)[0])
    critic64 = float64_copy(states["cpu"].critic)
    cg64 = torch.autograd.grad(
        critic_loss(cfg, lambda x: critic64.classifier(critic64.features(x).flatten(1)),
                    fake0_cpu.double(), fine0.double(), alphas[0].double())[0],
        list(critic64.parameters()), allow_unused=True)
    gen64 = float64_copy(states["cpu"].generator)
    gg64 = torch.autograd.grad(generator_forward_fp64(gen64, batch("cpu", 0)[0].double()),
                               list(gen64.parameters()), d_fake_cpu.double())
    grad_err = {"d_loss_d_fake_outside_flips": d_fake_err, "l1_sign_flips": int(flipped.sum())}
    for net, card, cpu, f64 in (("critic", cg_card, cg_cpu, cg64),
                                ("generator", gg_card, gg_cpu, gg64)):
        # The last critic bias gets no gradient from the loss (C(fake) and
        # C(real) enter with opposite signs and the GP does not see it).
        kept = [(a, b, c.float()) for a, b, c in zip(card, cpu, f64) if c is not None]
        card, cpu, f64 = zip(*kept)
        flat = lambda gs: torch.cat([g.cpu().reshape(-1) for g in gs])  # noqa: E731
        l2 = lambda gs: ((flat(gs) - flat(f64)).norm() / flat(f64).norm()).item()  # noqa: E731
        grad_err[net] = {
            "card_vs_fp64_l2": l2(card), "cpu_fp32_vs_fp64_l2": l2(cpu),
            "card_vs_fp64_worst_tensor_l2": max(((a.cpu() - c).norm() / c.norm()).item()
                                                for a, c in zip(card, f64)),
            "card_vs_fp64_worst_tensor_max": per_tensor_rel_err(card, f64),
            "cpu_fp32_vs_fp64_worst_tensor_max": per_tensor_rel_err(cpu, f64)}
        check(grad_err[net]["card_vs_fp64_l2"]
              <= GRAD_VS_CPU_FP32 * grad_err[net]["cpu_fp32_vs_fp64_l2"]
              and grad_err[net]["card_vs_fp64_worst_tensor_l2"] <= GRAD_TENSOR_TOL,
              f"step-0 {net} gradients: {grad_err}")

    steps = {dev: build_train_step(cfg, st.generator, st.critic) for dev, st in states.items()}
    metrics = {"cuda": [], "cpu": []}
    launches, twin_err = [], None
    for i in range(n_steps):
        for dev in ("cuda", "cpu"):
            before = drb_forward.launches
            m = steps[dev](states[dev], *batch(dev, i), alphas[i].to(dev))
            metrics[dev].append({k: float(v) for k, v in m.items()})
            if dev == "cuda":
                launches.append(drb_forward.launches - before)
        if i == 0:  # the metric pass's fake after step 0's generator update
            gen = states["cuda"].generator
            coarse0, fine0 = batch("cuda", 0)
            with torch.no_grad():
                fake = gen(coarse0)
                with drbs_on_plain_twin(gen):
                    fake_twin = gen(coarse0)
            twin_err = (fake - fake_twin).abs().max().item()
            check(torch.allclose(fake, fake_twin, atol=GEN_ATOL, rtol=GEN_RTOL),
                  f"after a generator update the kernel path is {twin_err} off the plain twin's")
            check(abs(float(content_loss(fine0, fake)) - metrics["cuda"][0]["MAE"]) <= 1e-6,
                  "the step's metric pass did not score this fake")
    want_launches = [48 * (2 + (i % 5 == 0)) for i in range(n_steps)]
    check(launches == want_launches, f"DRB launches per step {launches}, not {want_launches}")
    metric_err = 0.0
    for i, (mc, mp) in enumerate(zip(metrics["cuda"], metrics["cpu"])):
        for k in mp:
            err = abs(mc[k] - mp[k])
            metric_err = max(metric_err, err / (STEP_ATOL + STEP_RTOL * abs(mp[k])))
            check(err <= STEP_ATOL + STEP_RTOL * abs(mp[k]),
                  f"step {i} {k}: card {mc[k]} vs CPU {mp[k]}")
        check((mc["gen_loss"] != 0.0) == (i % 5 == 0), f"step {i}: generator schedule")
    param_err = {}
    updates = {"generator": sum(i % 5 == 0 for i in range(n_steps)), "critic": n_steps}
    for net in ("generator", "critic"):
        card, cpu = (getattr(states[d], net).state_dict() for d in ("cuda", "cpu"))
        diff = torch.cat([(card[k].cpu() - cpu[k]).abs().reshape(-1) for k in cpu])
        atol = ADAM_ATOL_PER_UPDATE * updates[net]
        param_err[net] = {"max": diff.max().item(), "median": diff.median().item(), "atol": atol}
        check(param_err[net]["max"] <= atol and param_err[net]["median"] <= ADAM_MEDIAN_ATOL,
              f"{net} parameters after {n_steps} steps, card vs CPU: {param_err[net]}")
    emit("train_parity", batch=B_PARITY, steps=n_steps, step0_grad_err_relative=grad_err,
         step_grad_tol=STEP_GRAD_TOL, metrics_card=metrics["cuda"],
         worst_metric_err_over_tolerance=metric_err, metric_rtol=STEP_RTOL, metric_atol=STEP_ATOL,
         param_err=param_err, adam_median_atol=ADAM_MEDIAN_ATOL,
         drb_launches_per_step=launches, kernel_vs_twin_after_update=twin_err)


@contextlib.contextmanager
def launches_per_generator_forward():
    """Each generator forward's own DRB kernel launches, in call order, while
    the block runs (forward hooks on every ``Generator`` and
    ``ShardedGenerator``)."""
    from torch.nn.modules.module import (register_module_forward_hook,
                                         register_module_forward_pre_hook)

    from downgan_tpu_torch.models.generator import Generator
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.parallel.spatial import ShardedGenerator

    pending, per_forward = [], []
    kinds = (Generator, ShardedGenerator)  # a sharded forward runs the blocks itself

    def pre(module, args):
        if isinstance(module, kinds):
            pending.append(drb_forward.launches)

    def post(module, args, out):
        if isinstance(module, kinds):
            per_forward.append(drb_forward.launches - pending.pop())

    hooks = [register_module_forward_pre_hook(pre), register_module_forward_hook(post)]
    try:
        yield per_forward
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def after_each_train_step(hook, before=None):
    """Call ``hook(state, metrics)`` after every step (or fused round) of the
    train steps the trainer builds while the block runs, and ``before(state)``
    before each, if given."""
    import downgan_tpu_torch.training.trainer as trainer_module

    real = {name: getattr(trainer_module, name) for name in ("build_train_step",
                                                             "build_fused_round")}

    def wrapping(real_build):
        def build(*args, **kwargs):
            inner = real_build(*args, **kwargs)

            def step(state, *a, **k):
                if before is not None:
                    before(state)
                metrics = inner(state, *a, **k)
                hook(state, metrics)
                return metrics

            step.forwards = inner.forwards
            return step

        return build

    for name, real_build in real.items():
        setattr(trainer_module, name, wrapping(real_build))
    try:
        yield
    finally:
        for name, real_build in real.items():
            setattr(trainer_module, name, real_build)


def phase_training(tracking_root: Path):
    """The training path through its CLI, in-process."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_backward, drb_forward

    step_metrics = []  # every step's metrics
    with launches_per_generator_forward() as per_forward, \
            after_each_train_step(lambda state, metrics: step_metrics.append(metrics)):
        reset_launch_counts()  # the training path's run starts here
        trainer = cli_main(["train", "--config", str(ROOT / "examples" / "florida.json"),
                            "--synthetic", "--samples", "1440", "--epochs", "2",
                            "--tracking-root", str(tracking_root)])
        torch.cuda.synchronize()
        launches = drb_forward.launches  # the training path's run ends here
        backward_routes = (drb_backward.launches, drb_backward.recomputes)

    history, forwards = trainer.history, dict(trainer.forwards)
    check(trainer.config.hp.batch_size == B_TRAIN and trainer.config.filters == 16
          and trainer.config.num_res_blocks == 16, "not the florida configuration")
    check(len(trainer.train_ds) == 1296 and len(trainer.test_ds) == 144, "not the 90/10 split")
    check([r["steps"] for r in history] == [10, 10], f"steps per epoch {history}")
    for r in history:
        values = [*r["train"].values(), *r["test"].values()]
        check(all(np.isfinite(v) for v in values), f"non-finite epoch means {r}")
    c0 = float(step_metrics[0]["critic_loss"])
    check(90.0 < c0 < 100.5, f"step 0 critic_loss {c0} is not GP-dominated (~100)")
    want_forwards = {"critic_fake": 20, "update": 4, "metric": 20, "test": 4}
    check(forwards == want_forwards, f"generator forwards {forwards}, not {want_forwards}")
    check(len(per_forward) == sum(forwards.values()) and set(per_forward) == {48},
          f"DRB launches per generator forward {sorted(set(per_forward))} over "
          f"{len(per_forward)} forwards")
    check(launches == 48 * sum(forwards.values()), f"{launches} DRB launches")
    # each generator update's backward: 48 backward kernels, no cuDNN recompute
    check(backward_routes == (48 * forwards["update"], 0),
          f"{backward_routes} (kernel, recompute) DRB backwards over {forwards['update']} "
          f"generator updates, not 48 kernels and 0 recomputes each")
    gen_losses = [float(m["gen_loss"]) for m in step_metrics]
    for e, r in enumerate(history):
        window = gen_losses[r["steps"] * e:r["steps"] * (e + 1)]
        check(abs(r["train"]["gen_loss"] - sum(window) / sum(v != 0.0 for v in window))
              <= 1e-5 * abs(r["train"]["gen_loss"]), "gen_loss rescale")

    emit("training", command="cli train --config examples/florida.json --synthetic --samples 1440 "
         "--epochs 2", batch=B_TRAIN, epochs=history, step0_critic_loss=c0,
         generator_forwards=forwards, drb_launches=launches, drb_launches_per_forward=48,
         drb_backward_launches=backward_routes[0], drb_backward_recomputes=backward_routes[1])
    return launches, backward_routes[0], trainer.ckpt.directory


def tuned_config(batch: int, compute_dtype: str):
    """examples/production_tuned.json (bf16, fused rounds, the metric pass
    on the reused fake) at ``batch`` and ``compute_dtype``."""
    from downgan_tpu_torch.config.config import Config

    tuned = Config.from_json((ROOT / "examples" / "production_tuned.json").read_text())
    return tuned.replace(hp=dataclasses.replace(tuned.hp, batch_size=batch,
                                                compute_dtype=compute_dtype))


def phase_fused_parity():
    """One fused round of the tuned configuration (florida width and depth,
    batch 4: the CPU side's cost) on the card and on the CPU from the same
    weights, data and alphas: in fp32 with train_parity's tolerances, in
    bf16 with the loose ones stated at the top."""
    from downgan_tpu_torch.data.dataset import synthetic_dataset
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.state import make_train_state
    from downgan_tpu_torch.training.wgan import build_fused_round

    report = {}
    for dtype in ("float32", "bfloat16"):
        cfg = tuned_config(B_PARITY, dtype)
        n = cfg.hp.critic_iterations
        coarse, fine = synthetic_dataset(n_samples=B_PARITY * n, seed=13)
        coarse_n = torch.from_numpy(coarse).permute(0, 3, 1, 2).reshape(n, B_PARITY, 7, 16, 16)
        fine_n = torch.from_numpy(fine).permute(0, 3, 1, 2).reshape(n, B_PARITY, 2, 128, 128)
        alphas = torch.rand(n, B_PARITY, 1, 1, 1, generator=torch.Generator().manual_seed(14))
        metrics, states = {}, {}
        for dev in ("cuda", "cpu"):
            st = states[dev] = make_train_state(cfg, dev)
            fused_round = build_fused_round(cfg, st.generator, st.critic)
            before = (drb_forward.launches, drb_forward.launches_bf16)
            m = fused_round(st, coarse_n.to(dev).contiguous(), fine_n.to(dev).contiguous(),
                            alphas.to(dev))
            metrics[dev] = {k: float(v) for k, v in m.items()}
            if dev == "cuda":
                launched = (drb_forward.launches - before[0], drb_forward.launches_bf16 - before[1])
                check(fused_round.forwards == {"critic_fake": n, "update": 1, "metric": 0},
                      f"{dtype} fused round forwards {fused_round.forwards}")
        want = 48 * (n + 1)
        check(launched == ((want, want) if dtype == "bfloat16" else (want, 0)),
              f"{dtype} fused round: {launched} (all, bf16) DRB launches, not {want}")
        rtol, atol = (BF16_STEP_RTOL, BF16_STEP_ATOL) if dtype == "bfloat16" else (STEP_RTOL,
                                                                                   STEP_ATOL)
        metric_err = {}
        for k, want_v in metrics["cpu"].items():
            err = abs(metrics["cuda"][k] - want_v)
            metric_err[k] = err / (atol + rtol * abs(want_v))
            check(err <= atol + rtol * abs(want_v),
                  f"{dtype} fused round {k}: card {metrics['cuda'][k]} vs CPU {want_v}")
        lr = cfg.hp.lr
        param_err = {}
        for net, updates in (("generator", 1), ("critic", n)):
            card, cpu = (getattr(states[d], net).state_dict() for d in ("cuda", "cpu"))
            diff = torch.cat([(card[k].cpu() - cpu[k]).abs().reshape(-1) for k in cpu])
            # 2 * lr per update (opposite first steps, lr * sign(g)), plus
            # 2**-20 for the fp32 rounding of the parameters themselves.
            atol_p = 2 * lr * updates + 2.0 ** -20
            median_atol = BF16_MEDIAN_ATOL if dtype == "bfloat16" else ADAM_MEDIAN_ATOL
            param_err[net] = {"max": diff.max().item(), "median": diff.median().item(),
                              "atol": atol_p, "median_atol": median_atol}
            check(param_err[net]["max"] <= atol_p and param_err[net]["median"] <= median_atol,
                  f"{dtype} fused round {net} parameters, card vs CPU: {param_err[net]}")
        report[dtype] = {"metrics_card": metrics["cuda"], "metrics_cpu": metrics["cpu"],
                         "metric_err_over_tolerance": metric_err, "param_err": param_err,
                         "drb_launches": launched[0], "rtol": rtol, "atol": atol}
    emit("fused_parity", batch=B_PARITY, rounds=1, critic_updates=n, report=report)


def phase_training_tuned(tracking_root: Path):
    """The tuned training path through its CLI, in-process: ``cli train
    --config examples/production_tuned.json --synthetic --samples 1440
    --epochs 2`` (bf16 compute, fused 5-critic rounds, the metric pass on
    the reused fake) at batch 128."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_backward, drb_forward

    round_metrics = []
    with launches_per_generator_forward() as per_forward, \
            after_each_train_step(lambda state, metrics: round_metrics.append(metrics)):
        reset_launch_counts()  # the tuned training path's run starts here
        trainer = cli_main(["train", "--config", str(ROOT / "examples" / "production_tuned.json"),
                            "--synthetic", "--samples", "1440", "--epochs", "2",
                            "--tracking-root", str(tracking_root)])
        torch.cuda.synchronize()
        launches = (drb_forward.launches, drb_forward.launches_bf16)  # ... and ends here
        backward_routes = (drb_backward.launches, drb_backward.recomputes)
    # What the run ended with, for serving_bf16.
    trained = {k: v.detach().cpu().clone() for k, v in trainer.state.generator.state_dict().items()}

    cfg, history, forwards = trainer.config, trainer.history, dict(trainer.forwards)
    check((cfg.hp.compute_dtype, cfg.hp.schedule, cfg.hp.metrics_reuse_fake, cfg.hp.batch_size,
           cfg.filters, cfg.num_res_blocks) == ("bfloat16", "fused", True, B_TRAIN, 16, 16),
          "not the tuned florida configuration")
    check(trainer.state.generator.compute_dtype == BF16 and trainer.state.critic.compute_dtype == BF16,
          "the tuned run's networks do not compute in bf16")
    check(len(trainer.train_ds) == 1296 and len(trainer.test_ds) == 144, "not the 90/10 split")
    check([r["steps"] for r in history] == [2, 2] and trainer.state.step == 20,
          f"rounds per epoch {[r['steps'] for r in history]}, step {trainer.state.step}")
    for r in history:
        values = [*r["train"].values(), *r["test"].values()]
        check(all(np.isfinite(v) for v in values), f"non-finite epoch means {r}")
    c0 = float(round_metrics[0]["critic_loss"])
    check(90.0 < c0 < 100.5, f"round 0 critic_loss {c0} is not GP-dominated (~100)")
    want_forwards = {"critic_fake": 20, "update": 4, "metric": 0, "test": 4}
    check(forwards == want_forwards, f"generator forwards {forwards}, not {want_forwards}")
    check(len(per_forward) == 28 and set(per_forward) == {48},
          f"DRB launches per generator forward {sorted(set(per_forward))} over "
          f"{len(per_forward)} forwards")
    check(launches == (1344, 1344), f"{launches} (all, bf16) DRB launches, not 1,344 bf16")
    check(backward_routes == (0, 48 * forwards["update"]),
          f"{backward_routes} (kernel, recompute) bf16 DRB backwards: bf16 keeps the recompute")
    gen_losses = [float(m["gen_loss"]) for m in round_metrics]
    for e, r in enumerate(history):  # the rounds' own gen_loss, not rescaled
        check(abs(r["train"]["gen_loss"] - sum(gen_losses[2 * e:2 * e + 2]) / 2)
              <= 1e-5 * abs(r["train"]["gen_loss"]), "gen_loss of the fused schedule")

    emit("training_tuned", command="cli train --config examples/production_tuned.json "
         "--synthetic --samples 1440 --epochs 2", batch=B_TRAIN, epochs=history,
         round0_critic_loss=c0, generator_forwards=forwards, drb_launches=launches[0],
         drb_launches_bf16=launches[1], drb_launches_per_forward=48)
    return launches[1], trainer, trained


def serve_and_compare(config, weights, rng, n_clients, n_requests, sizes, domain_shape):
    """``weights`` served over HTTP by ``BatchingSRModel`` to concurrent
    clients (request ``r`` of each client ``sizes[r]`` patches) and, given
    ``domain_shape``, one domain request, against a direct ``SRModel``;
    returns /healthz, /metrics, the DRB launches (all and bf16) of the
    served traffic, the largest differences and both models' compute
    dtypes."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.serving import (BatchingSRModel, SRModel, generate_domain_remote,
                                           generate_remote, serve_model)

    model = BatchingSRModel(config, weights, batch_size=B_MAIN, max_wait_ms=20.0)
    direct = SRModel(config, weights, batch_size=B_MAIN)
    server = serve_model(model, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    cs, c = config.coarse_size, config.n_covariates
    inputs = [[torch.randn(sizes[r], cs, cs, c, generator=rng).numpy()
               for r in range(n_requests)] for _ in range(n_clients)]
    domain = torch.randn(*domain_shape, c, generator=rng).numpy() if domain_shape else None
    results = [[None] * n_requests for _ in range(n_clients)]
    errors = []

    def client(i):
        try:
            for r in range(n_requests):
                results[i][r] = generate_remote(url, inputs[i][r])
        except Exception as exc:  # noqa: BLE001 -- reported and failed below
            errors.append((i, repr(exc)))

    try:
        health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
        reset_launch_counts()  # the served traffic starts here
        clients = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        fields = generate_domain_remote(url, domain, tile_rows=16, overlap=8) \
            if domain_shape else None
        launches = (drb_forward.launches, drb_forward.launches_bf16)  # ... and ends here
        metrics = json.loads(urllib.request.urlopen(f"{url}/metrics").read())
    finally:
        server.shutdown()
        server.server_close()
        model.close()
        thread.join(timeout=60)
    check(not errors and not any(t.is_alive() for t in clients), f"client errors {errors}")
    patch_err = 0.0
    for i in range(n_clients):
        for r in range(n_requests):
            got = results[i][r]
            check(got.shape == (sizes[r], config.fine_size, config.fine_size,
                                config.n_predictands) and np.isfinite(got).all(),
                  f"client {i} request {r}: bad response {got.shape}")
            patch_err = max(patch_err, float(np.abs(got - direct.generate(inputs[i][r])).max()))
    domain_err = None
    if domain_shape:
        want = direct.generate_domain(domain, tile_rows=16, overlap=8)
        check(fields.shape == want.shape and np.isfinite(fields).all(),
              f"domain response {fields.shape}")
        domain_err = float(np.abs(fields - want).max())
    return {"health": health, "metrics": metrics, "drb_launches": launches[0],
            "drb_launches_bf16": launches[1],
            "domain_shape": list(domain_shape) if domain_shape else None,
            "max_abs_err_patches": patch_err, "max_abs_err_domain": domain_err,
            "compute_dtypes": [str(m._gen.compute_dtype) for m in (model, direct)]}


def phase_serving_bf16(trainer, trained, rng):
    """The tuned run's generator restored from its checkpoint directory the
    way ``serve --checkpoint`` restores it (a bf16 model, from the run's
    logged config) and served over HTTP: concurrent /v1/generate requests
    and a /v1/generate-domain request through the 32x112 bands, against
    the same bf16 model's direct forward."""
    from downgan_tpu_torch.cli.__main__ import _resolve_source, build_parser

    parser = build_parser()
    config, weights = _resolve_source(parser.parse_args(
        ["serve", "--checkpoint", trainer.ckpt.directory]), parser)
    check(config.hp.compute_dtype == "bfloat16", "the run's logged config is not bf16")
    check(set(weights) == set(trained) and all(torch.equal(weights[k], v)
                                               for k, v in trained.items()),
          "the restored weights are not the generator the run ended with")
    n_clients, n_requests, n_patches = 4, 2, 8
    report = serve_and_compare(config, weights, rng, n_clients, n_requests,
                               sizes=(n_patches,) * n_requests, domain_shape=(2, 56, 112))
    check(report.pop("compute_dtypes") == [str(BF16)] * 2,
          "the served generator does not compute in bf16")
    launches = (report["drb_launches"], report["drb_launches_bf16"])
    check(launches == (48 * report["metrics"]["dispatches"],) * 2,
          f"{launches} (all, bf16) DRB launches for {report['metrics']['dispatches']} dispatches")
    check(report["max_abs_err_patches"] <= SERVE_ATOL and report["max_abs_err_domain"] <= SERVE_ATOL,
          f"served vs direct bf16: patches {report['max_abs_err_patches']}, "
          f"domain {report['max_abs_err_domain']}")
    report.pop("health")
    emit("serving_bf16", source="serve --checkpoint <the tuned run's checkpoints>",
         requests=n_clients * n_requests + 1, patches=n_clients * n_requests * n_patches,
         atol=SERVE_ATOL, **report)
    return launches[1]


def flat_state(trainer) -> dict:
    """Every tensor of ``trainer``'s train state (networks, Adam moments and
    steps, EMA generator) by name, and the step."""
    out = {"step": torch.tensor(trainer.state.step)}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}.{i}", v)
        elif isinstance(obj, torch.Tensor):
            out[prefix[1:]] = obj.detach()

    walk("", trainer.state.state_dict())
    return out


def state_report(a_trainer, b_trainer) -> dict:
    """Two trainers' final train states, tensor by tensor: equal bit for bit
    or the largest difference by part."""
    a, b = flat_state(a_trainer), flat_state(b_trainer)
    check(set(a) == set(b), "the two runs' states hold different tensors")
    unequal = sorted(k for k in a if not torch.equal(a[k], b[k]))
    max_diff = {}
    for k in a:
        if a[k].is_floating_point() and a[k].numel():
            part = k.split(".")[0]
            diff = (a[k].double() - b[k].double()).abs().max().item()
            max_diff[part] = max(max_diff.get(part, 0.0), diff)
    return {"held": "bit_identical", "tensors": len(a), "tensors_unequal": len(unequal),
            "first_unequal": unequal[:5], "max_abs_diff": max_diff}


def compare_resumed(straight, resumed) -> dict:
    """The resumed run against the uninterrupted one, bit for bit: epoch 1's
    means and every tensor of the final state. With cuDNN deterministic the
    two runs do the same operations on the same inputs."""
    report = state_report(straight, resumed)
    want, got = straight.history[-1], resumed.history[-1]
    splits = [k for k in ("train", "test", "test_ema") if k in want]
    check(splits == [k for k in ("train", "test", "test_ema") if k in got] and want["epoch"] == 1,
          f"epoch records differ in kind: {want} / {got}")
    report["means_unequal"] = [f"{sp}.{k}" for sp in splits for k in want[sp]
                               if want[sp][k] != got[sp][k]]
    check(not report["tensors_unequal"] and not report["means_unequal"],
          f"resumed vs uninterrupted run: {report}")
    return report


def compare_trajectories(reference, other, what: str) -> dict:
    """Two whole runs of the same training from other residencies, bit for
    bit: every epoch's train and test means, the generator forwards and
    every tensor of the final state (cuDNN deterministic on both)."""
    report = state_report(reference, other)
    report["means_unequal"] = [
        f"epoch{r['epoch']}.{sp}.{k}" for r, o in zip(reference.history, other.history)
        for sp in ("train", "test") for k in r[sp] if r[sp][k] != o.get(sp, {}).get(k)]
    check(len(reference.history) == len(other.history) == 2, f"{what}: epochs run")
    check(reference.forwards == other.forwards,
          f"{what}: generator forwards {other.forwards}, not {reference.forwards}")
    check(not report["tensors_unequal"] and not report["means_unequal"],
          f"{what} vs device-resident run: {report}")
    return report


def feed_counts(trainer) -> list:
    """Each train epoch of a host-fed trainer: the batches its feed read and
    the pinned bytes of its ring."""
    return [{"epoch": r["epoch"], "batches": stats.batches, "pinned_bytes": stats.pinned_bytes}
            for r, stats in zip(trainer.history, trainer.feed_stats)]


@contextlib.contextmanager
def cudnn_deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def phase_resume(config, rng, smi: str):
    """The resume path: ``cli train`` (florida, batch 128, 2 epochs) run
    uninterrupted, then sent SIGTERM after its step 3 and run again with
    ``--resume``; plain, and with the EMA and best-epoch tracking; the best
    bundle served over HTTP; checkpoint bytes."""
    from downgan_tpu_torch.cli.__main__ import _resolve_source, build_parser
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.serving import BatchingSRModel, generate_remote, serve_model
    from downgan_tpu_torch.training.wgan import ema_update

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_resume_")
    root = Path(tmp.name)
    ema_config = config.replace(hp=dataclasses.replace(config.hp, ema_decay=0.999))
    (root / "florida_ema.json").write_text(ema_config.to_json())
    variants = {"plain": (ROOT / "examples" / "florida.json", []),
                "ema": (root / "florida_ema.json", ["--track-best", "MSSSIM"])}
    sigterm_after = {"step": None}

    def preempt(state, metrics):
        if sigterm_after["step"] is not None and state.step == sigterm_after["step"] + 1:
            sigterm_after["step"] = None
            os.kill(os.getpid(), signal.SIGTERM)  # a real signal, to the trainer's handler

    def train(cfg_path, extra, ckpt_dir, *more):
        return cli_main(["train", "--config", str(cfg_path), "--synthetic", "--samples", "1440",
                         "--epochs", "2", "--checkpoint-dir", str(ckpt_dir),
                         "--tracking-root", str(root / "exps"), *extra, *more])

    runs, steps_after_stop = {}, {}
    with cudnn_deterministic():
        with launches_per_generator_forward() as per_forward, after_each_train_step(preempt):
            drb_forward.launches = 0  # the resume path's run starts here
            for name, (cfg_path, extra) in variants.items():
                straight = train(cfg_path, extra, root / name / "straight")
                sigterm_after["step"] = 3
                stopped = train(cfg_path, extra, root / name / "resumed")
                check(sigterm_after["step"] is None, "no SIGTERM was sent")
                steps_after_stop[name] = stopped.ckpt.all_steps()
                resumed = train(cfg_path, extra, root / name / "resumed", "--resume")
                runs[name] = (straight, stopped, resumed)
            torch.cuda.synchronize()
            launches = drb_forward.launches  # the resume path's run ends here

    report = {}
    for name, (straight, stopped, resumed) in runs.items():
        check(stopped.preempted and stopped.epoch == 1 and len(stopped.history) == 1
              and "test" not in stopped.history[0] and steps_after_stop[name] == [0],
              f"{name}: the SIGTERM run did not stop after epoch 0 with its checkpoint "
              f"({stopped.epoch}, {steps_after_stop[name]})")
        check(not resumed.preempted and resumed.epoch == 2
              and [r["epoch"] for r in resumed.history] == [1] and resumed.ckpt.latest_step() == 1,
              f"{name}: --resume did not finish epoch 1")
        check([r.run.meta["status"] for r in (straight, stopped, resumed)]
              == ["FINISHED", "KILLED", "FINISHED"], f"{name}: run statuses")
        want = {"critic_fake": 20, "update": 4, "metric": 20, "test": 4}
        for trainer, fw in ((straight, want), (stopped, {"critic_fake": 10, "update": 2,
                                                         "metric": 10, "test": 0}),
                            (resumed, {"critic_fake": 10, "update": 2, "metric": 10, "test": 2})):
            if name == "ema":
                fw = {**fw, "test_ema": fw["test"]}
            check(trainer.forwards == fw,
                  f"{name}: generator forwards {trainer.forwards}, not {fw}")
        report[name] = {
            "vs_uninterrupted": compare_resumed(straight, resumed),
            "epoch1_means_resumed": {k: resumed.history[0][k] for k in ("train", "test", "test_ema")
                                     if k in resumed.history[0]}}
    n_forwards = sum(sum(t.forwards.values()) for r in runs.values() for t in r)
    check(len(per_forward) == n_forwards and set(per_forward) == {48}
          and launches == 48 * n_forwards,
          f"{launches} DRB launches over {len(per_forward)} generator forwards "
          f"({sorted(set(per_forward))} each), {n_forwards} counted by the trainers")

    # The EMA run's best bundle, restored the way `serve --checkpoint` does.
    ema_straight, _, ema_resumed = runs["ema"]
    g_ema = ema_resumed.state.g_ema
    best_dir = Path(ema_resumed.run.artifact_dir) / "best"
    best = json.loads((best_dir / "best.json").read_text())
    check(best["metric"] == "MSSSIM" and best["mode"] == "max" and best["ema"] is True
          and best["epoch"] == 1, f"best.json {best}")
    parser = build_parser()
    bundle_config, weights = _resolve_source(parser.parse_args(
        ["serve", "--checkpoint", str(best_dir)]), parser)
    check(bundle_config == ema_config.replace(hp=dataclasses.replace(ema_config.hp, epochs=2)),
          "the bundle's config is not the run's")
    check(all(torch.equal(weights[k], v.cpu()) for k, v in g_ema.state_dict().items()),
          "the best bundle is not the EMA generator of epoch 1")
    model = BatchingSRModel(bundle_config, weights, batch_size=B_MAIN, max_wait_ms=20.0)
    server = serve_model(model, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    x = torch.randn(B_MAIN, config.coarse_size, config.coarse_size, config.n_covariates,
                    generator=rng).numpy()
    try:
        drb_forward.launches = 0  # the bundle-serving path's run starts here
        served = generate_remote(url, x)
        bundle_launches = drb_forward.launches  # ... and ends here
        dispatches = json.loads(urllib.request.urlopen(f"{url}/metrics").read())["dispatches"]
    finally:
        server.shutdown()
        server.server_close()
        model.close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the bundle server did not stop")
    with torch.inference_mode():
        direct = g_ema(torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous())
        direct = direct.permute(0, 2, 3, 1).cpu().numpy()
    serve_err = float(np.abs(served - direct).max())
    check(served.shape == direct.shape and np.isfinite(served).all() and serve_err <= SERVE_ATOL,
          f"served best bundle vs the EMA generator's direct forward: {serve_err}")
    check(bundle_launches == 48 * dispatches, f"{bundle_launches} DRB launches for "
          f"{dispatches} dispatches")

    # The kernel path against the twin: the uninterrupted run's EMA generator
    # (packed at epoch 0's test pass, updated at steps 10 and 15, scored
    # again), once more after an explicit EMA update, and the resumed plain
    # generator after a checkpoint load over its packed weights.
    coarse, _ = ema_straight.train_ds.gather(torch.arange(B_TRAIN, device="cuda"))

    def twin_err(gen):
        with torch.inference_mode():
            fast = gen(coarse)
            with drbs_on_plain_twin(gen):
                slow = gen(coarse)
        check(torch.allclose(fast, slow, atol=GEN_ATOL, rtol=GEN_RTOL),
              "the kernel path is off the plain twin's: stale packed weights")
        return (fast - slow).abs().max().item()

    twin = {"ema_after_training": twin_err(ema_straight.state.g_ema)}
    ema_update(0.5, ema_straight.state.g_ema, list(ema_straight.state.generator.parameters()))
    twin["ema_after_update"] = twin_err(ema_straight.state.g_ema)
    plain_resumed = runs["plain"][2]
    plain_resumed.state.load_state_dict(plain_resumed.ckpt.restore(0))
    twin["after_checkpoint_load"] = twin_err(plain_resumed.state.generator)

    # Checkpoint bytes of the uninterrupted runs' last epoch, with and without the EMA.
    values = sum(t.numel() for k, t in flat_state(ema_resumed).items()
                 if t.is_floating_point() and not k.endswith(".step"))
    ckpt_bytes = os.path.getsize(ema_straight.ckpt.directory + "/1.pt")
    plain_bytes = os.path.getsize(runs["plain"][0].ckpt.directory + "/1.pt")
    emit("resume", card=smi,
         command="cli train --config examples/florida.json --synthetic --samples 1440 "
         "--epochs 2 --checkpoint-dir D [--track-best MSSSIM on florida at hp.ema_decay=0.999]; "
         "SIGTERM after step 3; --resume", batch=B_TRAIN, runs=report,
         drb_launches=launches, generator_forwards=n_forwards, drb_launches_per_forward=48,
         best=best, bundle_serving={"patches": B_MAIN, "dispatches": dispatches,
                                    "drb_launches": bundle_launches, "max_abs_err": serve_err,
                                    "atol": SERVE_ATOL},
         kernel_vs_twin_max_abs_err=twin, twin_atol=GEN_ATOL, twin_rtol=GEN_RTOL,
         checkpoint={"bytes_with_ema": ckpt_bytes, "bytes_without_ema": plain_bytes,
                     "fp32_values_with_ema": values})
    # The EMA run stays on disk for the evaluate phase (main removes it).
    return launches, bundle_launches, runs["plain"][0], (tmp, runs["ema"][0].ckpt.directory,
                                                         root / "florida_ema.json")


def phase_host_feed(device_run, smi: str):
    """The host-fed path: ``cli train --config examples/florida.json
    --synthetic --samples 1440 --epochs 2 --host-feed`` in-process, cuDNN
    deterministic, held bit for bit against ``device_run``, the resume
    phase's uninterrupted run of the same command from the device."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.data.feed import HostDataset
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_feed_") as root, \
            cudnn_deterministic(), launches_per_generator_forward() as per_forward:
        drb_forward.launches = 0  # the host-fed path's run starts here
        host = cli_main(["train", "--config", str(ROOT / "examples" / "florida.json"),
                         "--synthetic", "--samples", "1440", "--epochs", "2", "--host-feed",
                         "--tracking-root", root])
        torch.cuda.synchronize()
        launches = drb_forward.launches  # the host-fed path's run ends here
    check(isinstance(host.train_ds, HostDataset) and isinstance(host.test_ds, HostDataset)
          and len(host.train_ds) == 1296 and len(host.test_ds) == 144,
          "the host-fed run did not train from host RAM")
    report = compare_trajectories(device_run, host, "host-fed run")
    n_forwards = sum(host.forwards.values())
    check(len(per_forward) == n_forwards and set(per_forward) == {48}
          and launches == 48 * n_forwards,
          f"{launches} DRB launches over {len(per_forward)} generator forwards")
    emit("host_feed", card=smi, command="cli train --config examples/florida.json --synthetic "
         "--samples 1440 --epochs 2 --host-feed", batch=B_TRAIN, vs_device_resident=report,
         host_fed=feed_counts(host), generator_forwards=host.forwards, drb_launches=launches,
         drb_launches_per_forward=48,
         h2d_bytes_per_batch=B_TRAIN * 4 * (2 * 128 * 128 + 7 * 16 * 16))
    return launches


def pack_int16(arr: np.ndarray):
    """CF-pack a float field as ERA files are: an int16 payload with
    ``scale_factor`` and ``add_offset``."""
    lo, hi = float(arr.min()), float(arr.max())
    scale = max(hi - lo, 1e-6) / 65500.0
    offset = (hi + lo) / 2.0
    return np.round((arr - offset) / scale).astype(np.int16), {"scale_factor": scale,
                                                                "add_offset": offset}


def phase_stream(config, smi: str):
    """The streaming path: the synthetic florida set of 1,440 samples laid
    out on disk as ``(time, var, lat, lon)`` int16 CF-packed files (the
    preprocessed layout, as ``np.memmap``s, so no h5py is needed), trained
    for two epochs through ``LazyField``, ``StreamDataset`` and the feed,
    and held bit for bit against a host-fed run on the same decoded
    arrays."""
    from downgan_tpu_torch.data import native
    from downgan_tpu_torch.data.dataset import synthetic_dataset
    from downgan_tpu_torch.data.feed import HostDataset
    from downgan_tpu_torch.data.stream import LazyField, StreamDataset
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.trainer import Trainer

    config = config.replace(hp=dataclasses.replace(config.hp, fused_epoch=False, epochs=2))
    coarse, fine = synthetic_dataset(n_samples=1440, coarse_size=config.coarse_size,
                                     fine_size=config.fine_size, n_covariates=config.n_covariates,
                                     n_predictands=config.n_predictands, seed=config.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as root:
        fields, disk_bytes = {}, 0
        for kind, arr in (("coarse", coarse), ("fine", fine)):
            for split, rows in (("train", slice(0, 1296)), ("test", slice(1296, 1440))):
                packed, attrs = pack_int16(np.transpose(arr[rows], (0, 3, 1, 2)))
                path = Path(root) / f"{kind}_{split}.int16"
                packed.tofile(path)
                disk_bytes += packed.nbytes
                fields[kind, split] = LazyField(
                    np.memmap(path, dtype=np.int16, mode="r", shape=packed.shape), attrs=attrs)
        streamed = {split: StreamDataset(fields["coarse", split], fields["fine", split])
                    for split in ("train", "test")}
        decoded = {split: HostDataset(np.asarray(ds.coarse), np.asarray(ds.fine))
                   for split, ds in streamed.items()}
        with cudnn_deterministic():
            host = Trainer(config, decoded["train"], decoded["test"], print_every=100)
            host.train()
            with launches_per_generator_forward() as per_forward:
                drb_forward.launches = 0  # the streaming path's run starts here
                stream = Trainer(config, streamed["train"], streamed["test"], print_every=100)
                stream.train()
                torch.cuda.synchronize()
                launches = drb_forward.launches  # the streaming path's run ends here
    report = compare_trajectories(host, stream, "streamed run")
    n_forwards = sum(stream.forwards.values())
    check(len(per_forward) == n_forwards and set(per_forward) == {48}
          and launches == 48 * n_forwards,
          f"{launches} DRB launches over {len(per_forward)} generator forwards")
    emit("stream", card=smi, data="synthetic florida set, 1,296 + 144 samples, int16 CF-packed "
         "(time, var, lat, lon) np.memmap files read by LazyField", disk_bytes=disk_bytes,
         netcdf_staging={"run": False, "h5py": package_versions(("h5py",))["h5py"],
                         "held_by": "tests/test_torch_data.py, on the CPU, against the JAX "
                         "package"},
         native_library=native.available(), vs_host_fed_decoded=report,
         streamed=feed_counts(stream), host_fed_decoded=feed_counts(host),
         generator_forwards=stream.forwards, drb_launches=launches, drb_launches_per_forward=48)
    return launches


def cpu_vs_card(gen, x) -> float:
    """Largest |card - CPU| of ``gen``'s forward on ``x`` (a card tensor),
    over the largest output magnitude (at least 1), with the same weights."""
    cpu_gen = copy.deepcopy(gen).cpu()
    with torch.no_grad():
        card = gen(x).cpu()
        cpu = cpu_gen(x.cpu())
    return (card - cpu).abs().max().item() / max(1.0, cpu.abs().max().item())


def florida_coarse(config, batch: int, rng, noise_channels: int = 0) -> torch.Tensor:
    """Random florida covariates on the card, NCHW, with the fixed latent
    appended when ``noise_channels`` > 0."""
    from downgan_tpu_torch.training.wgan import fixed_latent

    cs = config.coarse_size
    x = torch.randn(batch, config.n_covariates, cs, cs, generator=rng)
    if noise_channels:
        z = fixed_latent(config, (batch, cs, cs, noise_channels))
        x = torch.cat([x, torch.from_numpy(z).permute(0, 3, 1, 2)], dim=1)
    return x.cuda()


def phase_stochastic(config, rng, tracking_root: Path, smi: str):
    """The stochastic generator's training path: ``cli train --config
    examples/florida.json --synthetic --samples 1440 --epochs 1
    --noise-channels 4`` in-process (48 DRB launches in every generator
    forward, finite means), the card's forward against the CPU's with the
    same weights and latent at B=2, and the fp32 and bf16 forwards with the
    latent at B=150."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.state import make_generator

    k = 4
    with launches_per_generator_forward() as per_forward:
        reset_launch_counts()  # the stochastic training path's run starts here
        trainer = cli_main(["train", "--config", str(ROOT / "examples" / "florida.json"),
                            "--synthetic", "--samples", "1440", "--epochs", "1",
                            "--noise-channels", str(k), "--tracking-root", str(tracking_root)])
        torch.cuda.synchronize()
        launches = drb_forward.launches  # the stochastic training path's run ends here
    cfg, history, forwards = trainer.config, trainer.history, dict(trainer.forwards)
    n_params = sum(p.numel() for p in trainer.state.generator.parameters())
    check(cfg.noise_channels == k and n_params == 1_697_090,
          f"stochastic florida generator: noise_channels {cfg.noise_channels}, {n_params} params")
    check([r["steps"] for r in history] == [10], f"steps per epoch {history}")
    check(all(np.isfinite(v) for r in history for v in (*r["train"].values(),
                                                        *r["test"].values())),
          f"non-finite epoch means {history}")
    want_forwards = {"critic_fake": 10, "update": 2, "metric": 10, "test": 2}
    check(forwards == want_forwards, f"generator forwards {forwards}, not {want_forwards}")
    check(len(per_forward) == sum(forwards.values()) and set(per_forward) == {48}
          and launches == 48 * sum(forwards.values()),
          f"{launches} DRB launches over {len(per_forward)} generator forwards")

    gen = trainer.state.generator
    cpu_err = cpu_vs_card(gen, florida_coarse(cfg, 2, rng, k))
    check(cpu_err <= GEN_ATOL, f"stochastic generator: card vs CPU {cpu_err}")
    forward = {}
    for dtype in ("float32", "bfloat16"):
        hp = dataclasses.replace(config.hp, compute_dtype=dtype)
        model = make_generator(config.replace(hp=hp, noise_channels=k), "cuda",
                               rng=torch.Generator().manual_seed(0))
        with torch.inference_mode():
            reset_launch_counts()
            out = model(florida_coarse(config, B_MAIN, rng, k))
            torch.cuda.synchronize()
            per = (drb_forward.launches, drb_forward.launches_bf16)
            check(per == ((48, 48) if dtype == "bfloat16" else (48, 0))
                  and bool(torch.isfinite(out).all()),
                  f"{dtype} stochastic forward: {per} (all, bf16) DRB launches")
        forward[dtype] = {"drb_launches_per_forward": per[1] if dtype == "bfloat16" else per[0]}
    emit("stochastic", card=smi, command="cli train --config examples/florida.json --synthetic "
         "--samples 1440 --epochs 1 --noise-channels 4", batch=B_TRAIN, params=n_params,
         epochs=history, generator_forwards=forwards, drb_launches=launches,
         drb_launches_per_forward=48, max_err_vs_cpu_b2=cpu_err, tolerance=GEN_ATOL,
         forward_b150=forward)
    return launches, trainer


def phase_ensemble(trainer, smi: str):
    """``ensemble_metrics`` with 8 members over the 144-sample test split,
    from the stochastic run's generator, its CRPS and spread held to a
    float64 numpy computation of the same members, each member drawn twice
    bit for bit."""
    from downgan_tpu_torch.inference import ensemble_metrics, generate_ensemble
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    m = 8
    cfg = trainer.config
    weights = trainer.state.generator.state_dict()
    nhwc = lambda t: t.permute(0, 2, 3, 1).cpu().numpy()  # noqa: E731
    coarse, fine = nhwc(trainer.test_ds.coarse), nhwc(trainer.test_ds.fine)
    reset_launch_counts()  # the ensemble path's run starts here
    scores = ensemble_metrics(cfg, weights, coarse, fine, n_members=m)
    launches = drb_forward.launches  # the ensemble path's run ends here
    chunks = -(-len(coarse) // cfg.chunk_size)
    check(launches == 48 * m * chunks, f"{launches} DRB launches for {m * chunks} forwards")
    first, second = (generate_ensemble(cfg, weights, coarse, n_members=m) for _ in range(2))
    check(first.shape == (m, 144, 128, 128, 2) and np.isfinite(first).all(),
          f"members {first.shape}")
    identical = [bool(np.array_equal(a, b)) for a, b in zip(first, second)]
    check(all(identical), f"members drawn twice differ: {identical}")
    ens, truth = first.astype(np.float64), fine.astype(np.float64)
    term1 = np.abs(ens - truth[None]).mean(axis=0)
    pairs = sum(np.abs(ens[i] - ens[j]) for i in range(m) for j in range(i + 1, m))
    want = {"CRPS": float((term1 - pairs / (m * (m - 1))).mean()),
            "spread": float(ens.std(axis=0, ddof=1).mean()),
            "ens_mean_MAE": float(np.abs(ens.mean(axis=0) - truth).mean()),
            "member_MAE": float(np.abs(ens[0] - truth).mean())}
    rel = {k: abs(scores[k] - v) / abs(v) for k, v in want.items()}
    check(scores["n_members"] == m and max(rel.values()) <= ENSEMBLE_RTOL and scores["spread"] > 0,
          f"ensemble scores {scores} against float64 {want}")
    emit("ensemble", card=smi, members=m, samples=len(coarse), chunks_per_member=chunks,
         scores=scores, float64=want, rel_err=rel, rtol=ENSEMBLE_RTOL,
         members_bit_identical_when_drawn_twice=identical, drb_launches=launches)
    return launches


def phase_serving_stochastic(trainer, rng, smi: str):
    """The stochastic run's generator served over HTTP: coalesced requests
    of 3, 5 and 8 patches equal to direct calls bit for bit (each request
    gets the fixed latent in its own block layout), and a domain request
    (the whole-domain latent) equal to the direct tiler's."""
    config = trainer.config
    weights = {k: v.detach().cpu() for k, v in trainer.state.generator.state_dict().items()}
    report = serve_and_compare(config, weights, rng, n_clients=6, n_requests=3, sizes=(3, 5, 8),
                               domain_shape=(2, 56, 112))
    dispatches = report["metrics"]["dispatches"]
    check(report["drb_launches"] == 48 * dispatches,
          f"{report['drb_launches']} DRB launches for {dispatches} dispatches")
    check(dispatches < 6 * 3 + 1, f"no request was coalesced: {dispatches} dispatches")
    check(report["max_abs_err_patches"] == 0.0 and report["max_abs_err_domain"] == 0.0,
          f"served vs direct, stochastic: {report}")
    emit("serving_stochastic", card=smi, noise_channels=config.noise_channels, **report)
    return report["drb_launches"]


def phase_srresnet(config, rng, tracking_root: Path, smi: str):
    """The SRResNet family at florida width (115,414 params): ``cli train
    --generator-arch srresnet`` for one epoch (no DRB, so no hand-written
    kernel: the JAX package left it to XLA and the port to cuDNN), its
    forward against the CPU's at B=2, and the trained model served over
    HTTP."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.models.generator import SRResNetGenerator
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    reset_launch_counts()  # the SRResNet training path's run starts here
    trainer = cli_main(["train", "--config", str(ROOT / "examples" / "florida.json"),
                        "--synthetic", "--samples", "1440", "--epochs", "1",
                        "--generator-arch", "srresnet", "--tracking-root", str(tracking_root)])
    torch.cuda.synchronize()
    launches = drb_forward.launches  # ... and ends here
    gen, history = trainer.state.generator, trainer.history
    n_params = sum(p.numel() for p in gen.parameters())
    check(isinstance(gen, SRResNetGenerator) and n_params == 115_414,
          f"SRResNet: {type(gen).__name__} with {n_params} params")
    check([r["steps"] for r in history] == [10]
          and all(np.isfinite(v) for r in history for v in (*r["train"].values(),
                                                            *r["test"].values())),
          f"SRResNet epoch {history}")
    check(launches == 0, f"the SRResNet launched {launches} DRB kernels")
    cpu_err = cpu_vs_card(gen, florida_coarse(config, 2, rng))
    check(cpu_err <= GEN_ATOL, f"SRResNet: card vs CPU {cpu_err}")
    weights = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    served = serve_and_compare(trainer.config, weights, rng, n_clients=1, n_requests=1,
                               sizes=(8,), domain_shape=None)
    check(served["health"]["generator_arch"] == "srresnet"
          and served["max_abs_err_patches"] <= SERVE_ATOL and served["drb_launches"] == 0,
          f"SRResNet served: {served}")
    emit("srresnet", card=smi, command="cli train --config examples/florida.json --synthetic "
         "--samples 1440 --epochs 1 --generator-arch srresnet", params=n_params, epochs=history,
         drb_launches=launches, max_err_vs_cpu_b2=cpu_err, tolerance=GEN_ATOL, served=served)


# Every training variant at once: all of them in variants_parity, the
# flags of `cli train` in the variants phase's first run.
VARIANT_HP = dict(freq_sep=True, augment_flips=True, divergence_lambda=1.0, vorticity_lambda=1.0,
                  eof_lambda=1.0, grad_accum=2, lr_schedule="cosine", lr_warmup_steps=1,
                  lr_decay_steps=10)
VARIANT_FLAGS = ["--freq-sep", "--critic-conditional", "--augment-flips", "--eof-lambda", "1",
                 "--grad-accum", "2", "--lr-schedule", "cosine", "--lr-warmup-steps", "2",
                 "--lr-decay-steps", "10"]
PHYSICS_METRICS = ("MAE", "MSE", "MSSSIM", "Divergence", "Vorticity", "RALSD", "Wass")


def phase_variants_parity(config):
    """Three florida steps (full width, batch 4) with every training variant
    on (frequency separation, the conditional critic, flips, the divergence,
    vorticity and EOF terms at weight 1, grad_accum 2, a cosine schedule
    with one warmup update) on the card and on the CPU from the same
    weights, data, EOF basis, alphas and flip masks (drawn on the host: a
    card generator draws other numbers than a CPU one), held to
    train_parity's tolerances; 48 DRB launches in every generator forward,
    microbatch forwards included. ``critic_iterations`` is 2 here, so the
    generator updates at steps 0 and 2: the first at the warmup's lr 0, the
    second at the full rate, which moves its weights."""
    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.training.state import make_train_state
    from downgan_tpu_torch.training.trainer import training_eof_components
    from downgan_tpu_torch.training.wgan import build_train_step

    n_steps, critic_iterations = 3, 2
    cfg = config.replace(critic_conditional=True, hp=dataclasses.replace(
        config.hp, batch_size=B_PARITY, metrics_to_calculate=PHYSICS_METRICS,
        critic_iterations=critic_iterations, **VARIANT_HP))
    cpu_ds = DeviceDataset.from_numpy(*synthetic_dataset(n_samples=B_PARITY * n_steps, seed=16),
                                      "cpu")
    comps = training_eof_components(
        DeviceDataset.from_numpy(*synthetic_dataset(n_samples=96, seed=17), "cpu"), cfg.hp.ncomp)
    host = torch.Generator().manual_seed(18)
    alphas = torch.rand(n_steps, B_PARITY, 1, 1, 1, generator=host)
    flips = torch.rand(n_steps, 2, B_PARITY, generator=host) < 0.5
    states = {dev: make_train_state(cfg, dev) for dev in ("cuda", "cpu")}
    g_init = {k: v.clone() for k, v in states["cpu"].generator.state_dict().items()}
    n_critic = sum(p.numel() for p in states["cuda"].critic.parameters())
    check(n_critic == 1_113_321, f"the conditional florida critic has {n_critic} params")
    steps = {dev: build_train_step(cfg, st.generator, st.critic, eof_components=comps)
             for dev, st in states.items()}
    metrics, per_step = {"cuda": [], "cpu": []}, []
    for i in range(n_steps):
        rows = torch.arange(B_PARITY * i, B_PARITY * (i + 1))
        for dev in ("cuda", "cpu"):
            coarse, fine = (t.to(dev) for t in cpu_ds.gather(rows))
            with launches_per_generator_forward() as per_forward:
                m = steps[dev](states[dev], coarse, fine, alphas[i].to(dev),
                               flips=tuple(flips[i].to(dev)))
            metrics[dev].append({k: float(v) for k, v in m.items()})
            if dev == "cuda":
                per_step.append(list(per_forward))
    # critic fake, 2 generator microbatches at steps 0 and 2, metric fake
    want = [[48] * (2 + 2 * (i % critic_iterations == 0)) for i in range(n_steps)]
    check(per_step == want, f"DRB launches per generator forward by step {per_step}, not {want}")
    metric_err = 0.0
    for i, (mc, mp) in enumerate(zip(metrics["cuda"], metrics["cpu"])):
        check(set(mp) == {"critic_loss", "gen_loss", *PHYSICS_METRICS}, f"metrics {sorted(mp)}")
        for k in mp:
            err = abs(mc[k] - mp[k])
            metric_err = max(metric_err, err / (STEP_ATOL + STEP_RTOL * abs(mp[k])))
            check(err <= STEP_ATOL + STEP_RTOL * abs(mp[k]),
                  f"variants step {i} {k}: card {mc[k]} vs CPU {mp[k]}")
    # The generator's first update (step 0) ran at lr 0 (count 0 of the
    # warmup) and its second (step 2) at the full rate, so one update moved
    # its weights. Its gradients are also read whole from Adam's first
    # moment, (1 - beta1) * (beta1 * g0 + g2).
    moved = max((states["cpu"].generator.state_dict()[k] - v).abs().max().item()
                for k, v in g_init.items())
    check(moved >= 0.5 * cfg.hp.lr, f"the generator's weights moved at most {moved}")
    moments = [torch.cat([st.g_opt.state[p]["exp_avg"].cpu().reshape(-1)
                          for p in st.generator.parameters()]) for st in states.values()]
    g_grad_l2 = ((moments[0] - moments[1]).norm() / moments[1].norm()).item()
    check(g_grad_l2 <= GRAD_TENSOR_TOL, f"generator gradient, card vs CPU: relative L2 {g_grad_l2}")
    param_err = {}
    for net, updates in (("generator", 1), ("critic", n_steps)):  # updates at lr > 0
        card, cpu = (getattr(states[d], net).state_dict() for d in ("cuda", "cpu"))
        diff = torch.cat([(card[k].cpu() - cpu[k]).abs().reshape(-1) for k in cpu])
        atol = ADAM_ATOL_PER_UPDATE * updates
        param_err[net] = {"max": diff.max().item(), "median": diff.median().item(), "atol": atol}
        check(param_err[net]["max"] <= atol and param_err[net]["median"] <= ADAM_MEDIAN_ATOL,
              f"{net} parameters after {n_steps} variant steps, card vs CPU: {param_err[net]}")
    lrs = [st.c_opt.param_groups[0]["lr"] for st in states.values()]
    check(lrs[0] == lrs[1] and lrs[0] < cfg.hp.lr, f"critic learning rates {lrs}")
    emit("variants_parity", batch=B_PARITY, steps=n_steps, variants=VARIANT_HP,
         critic_conditional=True, critic_params=n_critic, eof_components=list(comps.shape),
         drb_launches_per_forward_by_step=per_step,
         metrics_card=metrics["cuda"], worst_metric_err_over_tolerance=metric_err,
         metric_rtol=STEP_RTOL, metric_atol=STEP_ATOL,
         generator_grad_rel_l2_from_adam_moment=g_grad_l2, param_err=param_err,
         adam_median_atol=ADAM_MEDIAN_ATOL, critic_iterations=critic_iterations,
         generator_max_move=moved, critic_lr_after=lrs[0])


def run_train_cli(argv, want_forwards):
    """``cli train argv`` in-process, with the DRB launches of each generator
    forward counted (every count set to 0 just before): finite epoch means,
    the generator forwards by kind, 48 launches in each; returns the trainer
    and what the run counted."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    with launches_per_generator_forward() as per_forward:
        reset_launch_counts()  # the path's run starts here
        trainer = cli_main(argv)
        torch.cuda.synchronize()
        launches = (drb_forward.launches, drb_forward.launches_bf16)  # ... and ends here
    forwards = dict(trainer.forwards)
    for r in trainer.history:
        values = [*r["train"].values(), *r["test"].values()]
        check(all(np.isfinite(v) for v in values), f"non-finite epoch means {r}")
    check(forwards == want_forwards, f"generator forwards {forwards}, not {want_forwards}")
    check(len(per_forward) == sum(forwards.values()) and set(per_forward) == {48},
          f"DRB launches per generator forward {sorted(set(per_forward))} over "
          f"{len(per_forward)} forwards")
    return trainer, {"epochs": trainer.history, "generator_forwards": forwards,
                     "drb_launches": launches[0], "drb_launches_bf16": launches[1],
                     "drb_launches_per_forward": 48}


def critic_update_peaks(trainer):
    """Peak memory above the starting allocation of a lone critic update at
    B=128 (the GP's double backward) with grad_accum 1 and 2, in turns."""
    from downgan_tpu_torch.training.wgan import critic_inputs, critic_update, make_condition

    state, ds = trainer.state, trainer.train_ds
    coarse, fine = ds.gather(torch.arange(B_TRAIN, device="cuda"))
    alpha = torch.rand(B_TRAIN, 1, 1, 1, device="cuda")
    with torch.no_grad():
        fake = state.generator(coarse)
    fake_c, real_c = critic_inputs(trainer.config, make_condition(trainer.config), fake, fine,
                                   coarse)
    c_params = list(state.critic.parameters())
    peaks = {1: [], 2: []}
    for k in (1, 2, 2, 1):
        cfg = trainer.config.replace(hp=dataclasses.replace(trainer.config.hp, grad_accum=k))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        critic_update(cfg, state, state.critic, c_params, fake_c, real_c, alpha)
        torch.cuda.synchronize()
        peaks[k].append(torch.cuda.max_memory_allocated() - base)
    return {"peak_above_start_bytes": {f"grad_accum_{k}": v for k, v in peaks.items()},
            "ratio_2_over_1": max(peaks[2]) / min(peaks[1])}


def phase_variants(tracking_root: Path):
    """The training variants through ``cli train`` on florida (fp32, the
    reference schedule, batch 128, 1,440 synthetic samples, one epoch):
    run A with every variant's flag (the EOF basis fit at staging), run B
    from a config file with the divergence and vorticity terms at weight 1
    and the RALSD, Divergence and Vorticity metrics; each with its epoch
    means and launches by kind; then a lone critic update's peak memory
    with grad_accum 1 and 2."""
    florida = ROOT / "examples" / "florida.json"
    common = ["--synthetic", "--samples", "1440", "--epochs", "1",
              "--tracking-root", str(tracking_root)]
    report, launches = {}, 0
    # 10 steps: critic fakes 10, updates at steps 0 and 5 of 2 microbatches
    # each, metric fakes 10, 2 test batches (128 and a tail of 16)
    trainer, run = run_train_cli(["train", "--config", str(florida), *common, *VARIANT_FLAGS],
                                 {"critic_fake": 10, "update": 4, "metric": 10, "test": 2})
    hp = trainer.config.hp
    check(trainer.config.critic_conditional and hp.freq_sep and hp.augment_flips
          and hp.grad_accum == 2 and hp.lr_schedule == "cosine" and hp.eof_lambda == 1.0,
          "run A is not the variants' configuration")
    check(trainer.eof_components.shape == (hp.ncomp, 2, 128 * 128),
          f"EOF basis {trainer.eof_components.shape}")
    run["critic_update_alone"] = critic_update_peaks(trainer)
    check(run["critic_update_alone"]["ratio_2_over_1"] < 1.0,
          f"grad_accum 2 does not lower a critic update's peak: {run['critic_update_alone']}")
    report["flags"], launches = run, launches + run["drb_launches"]
    del trainer

    from downgan_tpu_torch.config.config import Config

    cfg = Config.from_json(florida.read_text())
    cfg = cfg.replace(hp=dataclasses.replace(cfg.hp, divergence_lambda=1.0, vorticity_lambda=1.0,
                                             metrics_to_calculate=PHYSICS_METRICS))
    physics = tracking_root / "florida_physics.json"
    physics.write_text(cfg.to_json())
    trainer, run = run_train_cli(["train", "--config", str(physics), *common],
                                 {"critic_fake": 10, "update": 2, "metric": 10, "test": 2})
    for r in trainer.history:
        check({"Divergence", "Vorticity", "RALSD"} <= set(r["train"]) & set(r["test"]),
              f"physics metrics missing from {r}")
    report["physics_config"], launches = run, launches + run["drb_launches"]
    emit("variants", batch=B_TRAIN, runs=report, drb_launches=launches)
    return launches


def phase_variants_tuned(tracking_root: Path):
    """``cli train --config examples/production_tuned.json --synthetic
    --samples 1440 --epochs 1 --augment-flips --critic-conditional
    --grad-accum 2``: bf16, fused rounds, every generator forward on the
    bf16 kernel; finite means and launches by kind."""
    trainer, run = run_train_cli(
        ["train", "--config", str(ROOT / "examples" / "production_tuned.json"), "--synthetic",
         "--samples", "1440", "--epochs", "1", "--augment-flips", "--critic-conditional",
         "--grad-accum", "2", "--tracking-root", str(tracking_root)],
        # 2 rounds: 10 critic fakes, 2 updates of 2 microbatches, the
        # metric pass on the reused fake, 2 test batches
        {"critic_fake": 10, "update": 4, "metric": 0, "test": 2})
    hp = trainer.config.hp
    check((hp.compute_dtype, hp.schedule, hp.grad_accum, hp.augment_flips)
          == ("bfloat16", "fused", 2, True) and trainer.config.critic_conditional,
          "not the tuned configuration with the variants")
    check(run["drb_launches"] == run["drb_launches_bf16"] == 768,
          f"{run['drb_launches']} (all), {run['drb_launches_bf16']} (bf16) DRB launches, not 768")
    emit("variants_tuned", batch=B_TRAIN, **run)
    return run["drb_launches_bf16"]

# ---- the dp phase: data-parallel training --------------------------------------
DP_WORLD = 2  # legs (b) and (c): two gloo ranks sharing the one card
DP_STEPS = 6  # leg (b): steps 0 and 5 update the generator
DP_ROUNDS = 2  # leg (c): the first round of a process warms cuDNN's bf16 algorithms up
DP_TIMEOUT_S = 120  # a collective that waits longer raises; so does a child that runs longer


def train_cli_child(out_path: str, argv) -> int:
    """``chip_smoke.py --train-cli OUT train ...``, run alone or under
    torchrun by :func:`phase_dp`: ``cli train`` with ``argv`` in this
    process, cuDNN deterministic (so two runs are comparable bit for bit),
    the DRB launches of every generator forward counted from 0 just before
    and read just after; rank 0 writes what it counted to ``OUT`` as
    JSON."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.parallel.mesh import in_group, rank, world_size

    torch.backends.cudnn.deterministic = True
    with launches_per_generator_forward() as per_forward:
        reset_launch_counts()  # the path's run starts here
        trainer = cli_main(argv)
        torch.cuda.synchronize()
        launches = drb_forward.launches  # ... and ends here
    if rank() == 0:
        Path(out_path).write_text(json.dumps({
            "history": trainer.history, "forwards": dict(trainer.forwards),
            "drb_launches": launches, "launches_per_forward": sorted(set(per_forward)),
            "n_forwards": len(per_forward), "world": world_size(), "multihost": trainer.multihost,
            "device": str(trainer.device)}))
    if in_group():
        torch.distributed.destroy_process_group()
    return 0


def run_child(cmd, timeout_s: int) -> None:
    """Run ``cmd`` from the checkout's root in a session of its own; a child
    that fails or outlives ``timeout_s`` fails the phase (its whole process
    group is killed)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{cmd[:6]}... outlived {timeout_s} s")
    check(proc.returncode == 0, f"{' '.join(cmd)} exited {proc.returncode}:\n{out[-4000:]}")


def checkpoint_tensors(path: Path) -> dict:
    """Every tensor of a checkpoint file by name, and the step."""
    from downgan_tpu_torch.utils.checkpoint import load_params

    out = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(f"{prefix}.{i}", v)
        elif isinstance(obj, (torch.Tensor, int, float)):
            out[prefix[1:]] = torch.as_tensor(obj)

    walk("", load_params(str(path)))
    return out


def dp_cli_leg(workdir: Path, smi: str) -> int:
    """Leg (a): ``cli train --multihost`` at world size 1 over NCCL, launched
    by ``python -m torch.distributed.run --nproc-per-node 1``, against the
    plain ``cli train`` with the same flags: the epoch record and the final
    checkpoint (both networks, both Adam states, the step) bit for bit. At
    one rank a SUM all-reduce and a division by 1 are exact."""
    base = ["train", "--config", str(ROOT / "examples" / "florida.json"), "--synthetic",
            "--samples", "1440", "--epochs", "1", "--tracking-root", str(workdir / "tracking")]
    runs = {}
    for name, launcher, extra in (
            ("torchrun", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "1"], ["--multihost"]),
            ("plain", [sys.executable], [])):
        out = workdir / f"{name}.json"
        cmd = [*launcher, str(ROOT / "chip_smoke.py"), "--train-cli", str(out), *base,
               "--checkpoint-dir", str(workdir / f"ckpt_{name}"), *extra]
        run_child(cmd, 3 * DP_TIMEOUT_S)
        runs[name] = json.loads(out.read_text())
    dp, plain = runs["torchrun"], runs["plain"]
    check(dp["multihost"] and dp["world"] == 1 and not plain["multihost"],
          f"leg (a) ran multihost={dp['multihost']} world={dp['world']}")
    for run in (dp, plain):
        check(run["launches_per_forward"] == [48] and run["n_forwards"] == sum(run["forwards"].values())
              and run["drb_launches"] == 48 * run["n_forwards"],
              f"DRB launches per generator forward {run['launches_per_forward']}")
    means_unequal = [f"{sp}.{k}" for a, b in zip(dp["history"], plain["history"])
                     for sp in ("train", "test") for k in a[sp] if a[sp][k] != b[sp][k]]
    want, got = (checkpoint_tensors(workdir / f"ckpt_{n}" / "0.pt") for n in ("plain", "torchrun"))
    check(set(want) == set(got), "the two checkpoints hold different tensors")
    tensors_unequal = sorted(k for k in want if not torch.equal(want[k], got[k]))
    check(len(dp["history"]) == len(plain["history"]) == 1 and not means_unequal
          and not tensors_unequal,
          f"torchrun --multihost at world size 1 vs plain cli train: means {means_unequal}, "
          f"tensors {tensors_unequal[:5]}")
    emit("dp", leg="a_cli_world1_nccl", card=smi,
         command="python -m torch.distributed.run --standalone --nproc-per-node 1 -m "
         "downgan_tpu_torch.cli " + " ".join(base[:8]) + " --multihost --checkpoint-dir DIR "
         "(through chip_smoke.py --train-cli, which holds cuDNN deterministic and counts)",
         held="bit_identical", checkpoint_tensors=len(want), epoch=dp["history"],
         generator_forwards=dp["forwards"], drb_launches=dp["drb_launches"],
         drb_launches_per_forward=48)
    return dp["drb_launches"]


def dp_gloo_configs() -> dict:
    """Legs (b) and (c): (config, synthetic samples) at global batch 128:
    six reference-schedule steps of examples/florida.json in fp32, and two
    fused rounds of examples/production_tuned.json in bf16."""
    from downgan_tpu_torch.config.config import Config

    florida = Config.from_json((ROOT / "examples" / "florida.json").read_text())
    tuned = tuned_config(B_TRAIN, "bfloat16")
    return {"b_reference_fp32": (florida, DP_STEPS * B_TRAIN),
            "c_tuned_bf16": (tuned, DP_ROUNDS * tuned.hp.critic_iterations * B_TRAIN)}


def dp_train(config, n_samples: int, multihost: bool) -> dict:
    """One epoch of ``Trainer(config, multihost=multihost)`` on cuda:0 over
    ``n_samples`` synthetic florida samples (no test set), the DRB launches of
    every generator forward counted from 0 just before the epoch and read
    just after; returns what it counted and the final state on the CPU."""
    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.training.trainer import Trainer

    coarse, fine = synthetic_dataset(
        n_samples=n_samples, coarse_size=config.coarse_size, fine_size=config.fine_size,
        n_covariates=config.n_covariates, n_predictands=config.n_predictands, seed=config.seed)
    ds = DeviceDataset.from_numpy(coarse, fine, "cuda:0")
    with launches_per_generator_forward() as per_forward:
        trainer = Trainer(config, ds, None, device="cuda:0", multihost=multihost)
        reset_launch_counts()  # the path's run starts here
        trainer.train(1)
        torch.cuda.synchronize()
        launches = [drb_forward.launches, drb_forward.launches_bf16]  # ... and ends here
    return {"state": {k: v.cpu() for k, v in flat_state(trainer).items()},
            "history": trainer.history, "forwards": dict(trainer.forwards),
            "launches": launches, "launches_per_forward": sorted(set(per_forward)),
            "n_forwards": len(per_forward), "rows": B_TRAIN // trainer.world}


def dp_rank(rank: int, world: int, store: str, workdir: str) -> None:
    """One gloo rank of legs (b) and (c), spawned by :func:`phase_dp`: joins
    over a file store as local rank 0 of the one card (NCCL refuses two ranks
    on one device) and trains both legs; writes ``workdir/rank<rank>.pt``."""
    from downgan_tpu_torch.ops.cuda.drb import library_path, load_library
    from downgan_tpu_torch.parallel.multihost import initialize

    os.environ["LOCAL_RANK"] = "0"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"file://{store}", world, rank, backend="gloo",
               timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    torch.distributed.barrier()  # both ranks reach the build together
    found = library_path().exists()
    load_library()
    out = {"build": {"found_on_disk": found}}
    out.update({leg: dp_train(config, n, multihost=True)
                for leg, (config, n) in dp_gloo_configs().items()})
    torch.save(out, Path(workdir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def dp_weight_report(got: dict, want: dict, updates: dict, median_atol: float) -> dict:
    """Both networks' parameters of a rank against the one-rank run: the
    worst element within ADAM_ATOL_PER_UPDATE per update the network took,
    the median element within ``median_atol``."""
    report = {}
    for part, n_upd in updates.items():
        keys = [k for k in want if k.startswith(f"{part}.")]
        worst = max((got[k].double() - want[k].double()).abs().max().item() for k in keys)
        median = float(torch.cat([(got[k].double() - want[k].double()).abs().flatten()
                                  for k in keys]).median())
        report[part] = {"max_abs_diff": worst, "limit": ADAM_ATOL_PER_UPDATE * n_upd,
                        "median_abs_diff": median, "median_limit": median_atol}
        check(worst <= ADAM_ATOL_PER_UPDATE * n_upd and median <= median_atol,
              f"{part}: 2 ranks vs one rank {report[part]}")
    return report


def phase_dp(smi: str):
    """Data-parallel training at florida width: (a) the CLI at world size 1
    over NCCL against the plain CLI, bit for bit; (b) two gloo ranks sharing
    the card, six reference-schedule fp32 steps at global batch 128 (64 rows
    a rank) through ``Trainer(multihost=True)``, the ranks bit for bit and
    each against one rank on the global batch; (c) (b) on the tuned
    configuration, two bf16 fused rounds. Returns the fp32 and the bf16 DRB
    launches of the data-parallel runs."""
    import torch.multiprocessing as mp

    from downgan_tpu_torch.ops.cuda.drb import library_path
    from downgan_tpu_torch.training.wgan import g_updates_in_window

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        workdir = Path(tmp)
        fp32_launches = dp_cli_leg(workdir, smi)
        # The two ranks find no build of drb.cu and build it at once, each
        # into a temporary file of its own renamed into place; this process
        # keeps the library it has loaded.
        library_path().unlink()
        mp.spawn(dp_rank, args=(DP_WORLD, str(workdir / "store"), str(workdir)), nprocs=DP_WORLD,
                 join=True)
        ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=True) for r in range(DP_WORLD)]
    check(library_path().exists(), "no build of drb.cu after the ranks built it")
    emit("dp", leg="concurrent_build", card=smi, ranks=[r["build"] for r in ranks],
         library=str(library_path().relative_to(ROOT)))
    bf16_launches = 0
    for leg, (config, n_samples) in dp_gloo_configs().items():
        one = dp_train(config, n_samples, multihost=False)
        r0, r1 = (r[leg] for r in ranks)
        unequal = sorted(k for k in r0["state"] if not torch.equal(r0["state"][k], r1["state"][k]))
        check(not unequal and r0["history"][0]["train"] == r1["history"][0]["train"],
              f"leg {leg}: the two ranks differ: {unequal[:5]}")
        for r in (r0, r1):
            check(r["launches_per_forward"] == [48] and r["n_forwards"] == sum(r["forwards"].values())
                  and r["forwards"] == one["forwards"],
                  f"leg {leg}: DRB launches per forward {r['launches_per_forward']}, "
                  f"forwards {r['forwards']} (one rank: {one['forwards']})")
        hp = config.hp
        if hp.schedule == "fused":  # a round: n critic updates, one generator update
            updates = {"generator": DP_ROUNDS, "critic": DP_ROUNDS * hp.critic_iterations}
            median_atol = BF16_MEDIAN_ATOL
        else:
            updates = {"generator": g_updates_in_window(0, DP_STEPS, hp.critic_iterations),
                       "critic": DP_STEPS}
            median_atol = ADAM_MEDIAN_ATOL
        report = dp_weight_report(r0["state"], one["state"], updates, median_atol)
        bf16 = config.hp.compute_dtype == "bfloat16"
        launches = sum(r["launches"][1 if bf16 else 0] for r in (r0, r1))
        check(launches == 48 * (r0["n_forwards"] + r1["n_forwards"]),
              f"leg {leg}: {launches} {'bf16 ' if bf16 else ''}DRB launches")
        if bf16:
            bf16_launches += launches
        else:
            fp32_launches += launches
        # The epoch's means of every step's metrics: the field metrics score
        # the global batch on both sides, so MS-SSIM's normalization is the
        # same; the ranks' fakes differ from one rank's by cuDNN's rounding
        # at B=64 against B=128, as a card step from a CPU step (train_parity).
        rtol, atol = (BF16_STEP_RTOL, BF16_STEP_ATOL) if bf16 else (STEP_RTOL, STEP_ATOL)
        means = {k: {"two_ranks": r0["history"][0]["train"][k], "one_rank": v}
                 for k, v in one["history"][0]["train"].items()}
        far = {k: m for k, m in means.items()
               if not abs(m["two_ranks"] - m["one_rank"]) <= atol + rtol * abs(m["one_rank"])}
        check(not far, f"leg {leg}: epoch means of 2 ranks vs one rank beyond rtol {rtol} "
              f"atol {atol}: {far}")
        emit("dp", leg=leg, card=smi, world=DP_WORLD, backend="gloo (CUDA tensors through host "
             "memory)", global_batch=B_TRAIN, rows_per_rank=r0["rows"],
             schedule=hp.schedule, compute_dtype=hp.compute_dtype,
             held={"ranks": "bit_identical", "vs_one_rank": report},
             generator_forwards=r0["forwards"],
             drb_launches_per_rank=[r["launches"][1 if bf16 else 0] for r in (r0, r1)],
             drb_launches_per_forward=48, train_means=means,
             train_means_tolerance={"rtol": rtol, "atol": atol},
             step="round" if hp.schedule == "fused" else "step")
    return fp32_launches, bf16_launches


# ---- the spatial phase: halo-exchange spatial sharding ------------------------------
SP_GRID = (2, 2)  # (data, spatial): four gloo ranks sharing the one card
SP_B_FORWARD = 150  # leg (a): the serving batch
SP_B_STEP = 32  # legs (b)-(d)
SP_STEPS = 6  # leg (c): generator updates at steps 0 and 5
SP_DP_STEPS = 2  # leg (d)
SP_DEADLINE_S = 600  # the whole spawned job; a collective that waits DP_TIMEOUT_S raises
# Leg (b)'s parameter gradients, the sharded generator's of a scalar of its
# output and the sharded critic's of the GP, against the unsharded networks'
# on the card, per tensor relative to its largest entry: fp32 backwards of
# one function whose convolutions run at other shapes (cuDNN may pick other
# algorithms); the CPU test holds 1e-4 (measured 6.2e-6 and 4.2e-6). A
# factor of S or 1/S, or a halo row's lost share, is off by order 1.
SP_GRAD_REL = 1e-3


def spawn_ranks(fn, args: tuple, nprocs: int, timeout_s: float) -> None:
    """``torch.multiprocessing.spawn(fn, args, nprocs)`` with a deadline: a
    rank's exception is raised here; ranks still running after
    ``timeout_s`` are terminated and the phase fails."""
    import torch.multiprocessing as mp

    context = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.perf_counter() + timeout_s
    while not context.join(timeout=max(0.0, deadline - time.perf_counter())):
        if time.perf_counter() < deadline:
            continue
        for proc in context.processes:
            if proc.is_alive():
                proc.terminate()
        for proc in context.processes:
            proc.join(10)
        raise RuntimeError(f"spawned ranks still running after {timeout_s} s")


def spatial_inputs(config, seed: int, *lead) -> tuple:
    """Seeded (coarse, fine) NCHW batches of leading shape ``lead`` on the
    host: the same on every rank and in the main process."""
    g = torch.Generator().manual_seed(seed)
    coarse = torch.randn((*lead, config.n_covariates, config.coarse_size, config.coarse_size),
                         generator=g)
    fine = torch.randn((*lead, config.n_predictands, config.fine_size, config.fine_size),
                       generator=g)
    return coarse, fine


def spatial_critic_inputs(config) -> tuple:
    """Leg (b)'s real, fake and alpha at SP_B_STEP."""
    g = torch.Generator().manual_seed(31)
    _, real = spatial_inputs(config, 30, SP_B_STEP)
    fake = 0.9 * real + 0.1 * torch.randn(real.shape, generator=g)
    return real, fake, torch.rand((SP_B_STEP, 1, 1, 1), generator=g)


def spatial_generator_inputs(config) -> tuple:
    """Leg (b)'s coarse batch at SP_B_STEP and the cotangent of the
    generator's output whose parameter gradients are compared."""
    coarse, fine = spatial_inputs(config, 32, SP_B_STEP)
    return coarse, torch.randn(fine.shape, generator=torch.Generator().manual_seed(33))


def generator_gradients(apply, gen, coarse, cotangent, sync=None) -> dict:
    """The parameter gradients of ``sum(apply(gen, coarse) * cotangent)``,
    after ``sync.gradients`` where given, on the CPU; ``gen``'s gradients
    are cleared after."""
    (apply(gen, coarse) * cotangent).sum().backward()
    if sync is not None:
        sync.gradients(list(gen.parameters()))
    grads = {k: p.grad.cpu() for k, p in gen.named_parameters()}
    gen.zero_grad(set_to_none=True)
    return grads


def gradient_gaps(got: dict, want: dict) -> dict:
    """Per tensor, the largest difference over the largest entry of the
    reference (1 where that is all zeros)."""
    return {k: float((got[k] - g).abs().max() / (g.abs().max() if g.any() else 1.0))
            for k, g in want.items()}


def generator_stages(gen, x, conv, drb):
    """(name, output) after conv1, each RRDB, conv2 and the skip, each up
    stage and the two head convs of the RRDB ``gen`` on ``x``, with ``conv(m,
    t)`` and ``drb(block, t)`` as the network's convs and blocks: the
    unsharded ones, or the sharded ones on a rank's rows."""
    import torch.nn.functional as F

    out1 = conv(gen.conv1, x)
    yield "conv1", out1
    out = out1
    for i, rrdb in enumerate(gen.res_blocks):
        y = out
        for block in rrdb.dense_blocks:
            y = drb(block, y)
        out = y * 0.2 + out
        yield f"rrdb{i}", out
    out = out1 + conv(gen.conv2, out)
    yield "conv2", out
    for i, c in enumerate(gen.upsampling[::3]):
        out = F.pixel_shuffle(F.leaky_relu(conv(c, out), 0.01), 2)
        yield f"up{i}", out
    out = F.leaky_relu(conv(gen.conv3[0], out), 0.01)
    yield "head1", out
    yield "head2", conv(gen.conv3[2], out)


def first_differing_stage(gen, x, group) -> dict:
    """This rank's rows of every stage of the sharded forward against the
    same rows of the unsharded forward: the first stage that differs and
    its largest difference, and the largest difference of every stage."""
    from downgan_tpu_torch.parallel.spatial import ShardedGenerator, scatter_rows, sharded_drb

    sharded = ShardedGenerator(gen, group)
    index = torch.distributed.get_rank(group)
    with torch.no_grad():
        whole = generator_stages(gen, x, lambda m, t: m(t), lambda b, t: b(t))
        local = generator_stages(gen, scatter_rows(x, group), sharded.conv,
                                 lambda b, t: sharded_drb(b, t, group))
        diffs = {}
        for (name, want), (_, got) in zip(whole, local):
            h = got.shape[2]
            diffs[name] = float((got - want[:, :, index * h:(index + 1) * h]).abs().max())
    first = next((name for name, d in diffs.items() if d > 0), None)
    return {"first_differing_stage": first, "max_abs_by_stage": diffs}


def spatial_state(config):
    from downgan_tpu_torch.training.state import make_train_state

    return make_train_state(config, "cuda:0")


def spatial_steps(step, state, coarse, fine) -> dict:
    """Run ``step`` over the (steps, B, ...) batches; the metrics, the final
    weights on the CPU and the generator forwards by kind."""
    metrics = [{k: float(v) for k, v in step(state, c.cuda(), f.cuda()).items()}
               for c, f in zip(coarse, fine)]
    return {"metrics": metrics,
            "weights": {f"{part}.{k}": v.detach().cpu()
                        for part, module in (("generator", state.generator),
                                             ("critic", state.critic))
                        for k, v in module.state_dict().items()},
            "forwards": dict(step.forwards)}


def spatial_rank(rank: int, world: int, store: str, workdir: str) -> None:
    """One gloo rank of phase ``spatial``, spawned by :func:`phase_spatial`:
    joins over a file store as local rank 0 of the one card, lays the four
    ranks out as a 2 x 2 (data, spatial) grid and runs legs (a)-(d), the DRB
    launches of the whole run counted from 0; writes
    ``workdir/spatial_rank<rank>.pt``."""
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.parallel import spatial
    from downgan_tpu_torch.parallel.dp import GroupSync
    from downgan_tpu_torch.parallel.mesh import batch_rows, make_grid
    from downgan_tpu_torch.parallel.multihost import initialize
    from downgan_tpu_torch.training.wgan import build_train_step, gradient_penalty

    os.environ["LOCAL_RANK"] = "0"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize(f"file://{store}", world, rank, backend="gloo",
               timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    data_group, spatial_group = make_grid(*SP_GRID)
    config = Config.from_json((ROOT / "examples" / "florida.json").read_text())
    state = spatial_state(config)
    dist = torch.distributed
    out = {"forward": {}}
    with launches_per_generator_forward() as per_forward:
        reset_launch_counts()  # the path's run starts here
        # (a) the sharded generator forward at B=150, 2 shards (each spatial
        # group of the grid) and 4 (the whole job)
        coarse, _ = spatial_inputs(config, 20, SP_B_FORWARD)
        coarse = coarse.cuda()
        for shards, group in ((2, spatial_group), (4, None)):
            apply = spatial.sharded_generator_apply(config, group)
            with torch.no_grad():
                before = drb_forward.launches
                fine = apply(state.generator, coarse)
                torch.cuda.synchronize()
            out["forward"][shards] = {"launches": drb_forward.launches - before}
            if rank == 0:
                out["forward"][shards]["fine"] = fine.cpu()
            del fine
        # (b) the sharded generator's parameter gradients of a scalar of its
        # output, and the sharded critic and the GP, at B=32 over 2 shards
        coarse, cotangent = (t.cuda() for t in spatial_generator_inputs(config))
        out["generator_grads"] = generator_gradients(
            spatial.sharded_generator_apply(config, spatial_group), state.generator, coarse,
            cotangent, spatial.SpatialSync(spatial_group))
        real, fake, alpha = (t.cuda() for t in spatial_critic_inputs(config))
        sharded = spatial.ShardedCritic(state.critic, spatial_group)
        with torch.no_grad():
            scores = sharded(real)
        gp = gradient_penalty(sharded, real, fake, alpha)
        gp.backward()
        params = list(state.critic.parameters())
        spatial.SpatialSync(spatial_group, sharded.replicated_parameters()).gradients(params)
        out["critic"] = {"scores": scores.cpu(), "gp": gp.item(),
                         "grads": {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                                   for k, p in state.critic.named_parameters()}}
        state.critic.zero_grad(set_to_none=True)
        dist.barrier()
        # (c) the spatial train step, 6 steps at B=32 over 2 ranks (the first
        # spatial group; the others wait, so the two ranks share the card alone)
        coarse, fine = spatial_inputs(config, 21, SP_STEPS, SP_B_STEP)
        if rank in (0, 1):
            step_state = spatial_state(config)
            step = spatial.build_spatial_train_step(config, step_state.generator,
                                                    step_state.critic, spatial_group)
            out["step"] = spatial_steps(step, step_state, coarse, fine)
            del step_state, step
        dist.barrier()
        # (d) DP x spatial on the 2 x 2 grid against 2-rank DP on the data groups
        coarse, fine = spatial_inputs(config, 22, SP_DP_STEPS, SP_B_STEP)
        d_rank = dist.get_rank(data_group)
        rows = [batch_rows(t, d_rank, SP_GRID[0], axis=1) for t in (coarse, fine)]
        for name, build in (
                ("dp_spatial", lambda st: spatial.build_dp_spatial_train_step(
                    config, st.generator, st.critic, spatial_group, data_group)),
                ("dp", lambda st: build_train_step(config, st.generator, st.critic,
                                                   sync=GroupSync(data_group)))):
            leg_state = spatial_state(config)
            # DP's rows are whole 16x16 samples: the bands' backward route for it too
            with drb_backward_on_recompute() if name == "dp" else contextlib.nullcontext():
                out[name] = spatial_steps(build(leg_state), leg_state, *rows)
            del leg_state
        torch.cuda.synchronize()
        out["launches"] = drb_forward.launches  # ... and ends here
    out["launches_per_forward"] = sorted(set(per_forward))
    out["n_forwards"] = len(per_forward)
    # Outside the counted run: this rank's rows of every stage of leg (a)'s
    # forward against the unsharded forward's, to name the first that differs.
    coarse, _ = spatial_inputs(config, 20, SP_B_FORWARD)
    out["stages"] = {shards: first_differing_stage(state.generator, coarse.cuda(), group)
                     for shards, group in ((2, spatial_group), (4, None))}
    torch.save(out, Path(workdir) / f"spatial_rank{rank}.pt")
    dist.destroy_process_group()


def spatial_weight_check(got: dict, want: dict, updates: dict, what: str) -> dict:
    """:func:`dp_weight_report` with the leg named in its failure."""
    try:
        return dp_weight_report(got, want, updates, ADAM_MEDIAN_ATOL)
    except RuntimeError as e:
        raise RuntimeError(f"spatial leg {what}: {e}") from None


def close_metrics(got: list, want: list, what: str) -> float:
    """The largest relative gap of every step's metrics; each within the
    card step tolerances (STEP_RTOL, STEP_ATOL)."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        for k, v in w.items():
            gap = abs(g[k] - v)
            check(gap <= STEP_ATOL + STEP_RTOL * abs(v), f"spatial leg {what}: {k} {g[k]} vs {v}")
            worst = max(worst, gap / max(abs(v), 1e-30))
    return worst


def phase_spatial(smi: str) -> int:
    """Halo-exchange spatial sharding at florida width and depth, four gloo
    ranks sharing the card as a 2 x 2 (data, spatial) grid
    (:func:`spatial_rank`), held against one process on the card: (a) the
    sharded generator forward at B=150 over 2 and 4 shards, 48 DRB launches
    a forward a rank on halo-extended bands, against the unsharded forward
    (bit for bit expected, else within KERNEL_ATOL with the first stage
    that differs named); (b) the sharded generator's parameter gradients of
    a scalar of its output, the sharded critic's scores, the GP and its
    parameter gradients at B=32 over 2 shards; (c) six steps of
    ``build_spatial_train_step`` at B=32 over 2 ranks, the ranks bit for
    bit and each within the Adam tolerances of one process's
    ``build_train_step``; (d) two steps of ``build_dp_spatial_train_step``
    on the grid against 2-rank data parallelism. Returns the DRB launches of
    the ranks' runs."""
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.parallel.spatial import DRB_HALO, band_rows
    from downgan_tpu_torch.training.wgan import (build_train_step, g_updates_in_window,
                                                 gradient_penalty)

    config = Config.from_json((ROOT / "examples" / "florida.json").read_text())
    world = SP_GRID[0] * SP_GRID[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        spawn_ranks(spatial_rank, (world, str(Path(tmp) / "store"), tmp), world, SP_DEADLINE_S)
        ranks = [torch.load(Path(tmp) / f"spatial_rank{r}.pt", weights_only=True)
                 for r in range(world)]
    for r, run in enumerate(ranks):
        check(run["launches_per_forward"] == [48] and run["launches"] == 48 * run["n_forwards"],
              f"spatial rank {r}: DRB launches per sharded forward {run['launches_per_forward']}, "
              f"{run['launches']} over {run['n_forwards']} forwards")
    launches = sum(run["launches"] for run in ranks)
    state = spatial_state(config)

    # (a) the generator forward
    coarse, _ = spatial_inputs(config, 20, SP_B_FORWARD)
    with torch.no_grad():
        want = state.generator(coarse.cuda()).cpu()
    forward = {}
    for shards in (2, 4):
        got = ranks[0]["forward"][shards]["fine"]
        stages = [run["stages"][shards] for run in ranks]
        gap = float((got - want).abs().max())
        bit = torch.equal(got, want)
        check(bit or gap <= KERNEL_ATOL,
              f"spatial leg a: {shards} shards {gap} off the unsharded forward; first stage "
              f"that differs, by rank: {[s['first_differing_stage'] for s in stages]}")
        per_forward = [run["forward"][shards]["launches"] for run in ranks]
        check(per_forward == [48] * world, f"spatial leg a: launches a forward {per_forward}")
        forward[shards] = {
            "bit_for_bit": bit, "max_abs_diff": gap, "tolerance": KERNEL_ATOL,
            "first_differing_stage_by_rank": [s["first_differing_stage"] for s in stages],
            "stage_max_abs_by_rank": [s["max_abs_by_stage"] for s in stages],
            "drb_launches_per_forward_per_rank": per_forward,
            "coarse_rows_per_rank": config.coarse_size // shards,
            "drb_band_rows": [hi - lo for lo, hi in (
                band_rows(shards, i, config.coarse_size // shards, DRB_HALO)
                for i in range(shards))]}
    emit("spatial", leg="a_generator_forward", card=smi, batch=SP_B_FORWARD,
         backend="gloo, 4 ranks sharing the card (CUDA tensors through host memory)",
         by_shards=forward)

    # (b) the generator's parameter gradients, the critic and the GP over 2 shards
    coarse, cotangent = (t.cuda() for t in spatial_generator_inputs(config))
    with drb_backward_on_recompute():  # the bands' backward route
        gen_grads = generator_gradients(lambda gen, x: gen(x), state.generator, coarse, cotangent)
    # For information: against the backward kernel's gradients (the forward's
    # sides), the few pre-activations within rounding of zero on the other
    # side move a DRB weight's gradient by a share of itself.
    kernel_route = generator_gradients(lambda gen, x: gen(x), state.generator, coarse, cotangent)
    gen_grad_gaps, kernel_route_gaps = [], []
    for r, run in enumerate(ranks):
        worst = gradient_gaps(run["generator_grads"], gen_grads)
        gen_grad_gaps.append(max(worst.values()))
        kernel_route_gaps.append(max(gradient_gaps(run["generator_grads"], kernel_route).values()))
        check(gen_grad_gaps[-1] <= SP_GRAD_REL,
              f"spatial leg b: rank {r} generator parameter gradients {worst}")
    real, fake, alpha = (t.cuda() for t in spatial_critic_inputs(config))
    with torch.no_grad():
        scores = state.critic(real).cpu()
    gp = gradient_penalty(state.critic, real, fake, alpha)
    gp.backward()
    gp = gp.item()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for k, p in state.critic.named_parameters()}
    score_gaps, gp_gaps, grad_gaps = [], [], []
    for r, run in enumerate(ranks):
        crit = run["critic"]
        score_gaps.append(float((crit["scores"] - scores).abs().max()))
        check(torch.allclose(crit["scores"], scores, atol=3e-4, rtol=1e-4),
              f"spatial leg b: rank {r} scores {score_gaps[-1]} off")
        gp_gaps.append(abs(crit["gp"] - gp) / abs(gp))
        check(gp_gaps[-1] <= 1e-3, f"spatial leg b: rank {r} GP {crit['gp']} vs {gp}")
        worst = gradient_gaps(crit["grads"], grads)
        grad_gaps.append(max(worst.values()))
        check(grad_gaps[-1] <= SP_GRAD_REL,
              f"spatial leg b: rank {r} GP parameter gradients {worst}")
    emit("spatial", leg="b_gradients_critic_gp", card=smi, batch=SP_B_STEP, shards=2,
         generator_param_grad_rel_diff_by_rank=gen_grad_gaps,
         generator_param_grad_tolerance_rel=SP_GRAD_REL,
         generator_param_grad_rel_diff_by_rank_vs_backward_kernel_information=kernel_route_gaps,
         score_max_abs_diff_by_rank=score_gaps, score_tolerance={"atol": 3e-4, "rtol": 1e-4},
         gp=gp, gp_rel_diff_by_rank=gp_gaps, gp_tolerance_rel=1e-3,
         gp_param_grad_rel_diff_by_rank=grad_gaps, gp_param_grad_tolerance_rel=SP_GRAD_REL)
    del state

    # (c) the spatial train step against one process
    n_critic = config.hp.critic_iterations
    coarse, fine = spatial_inputs(config, 21, SP_STEPS, SP_B_STEP)
    one_state = spatial_state(config)
    with drb_backward_on_recompute():  # the bands' backward route
        one = spatial_steps(build_train_step(config, one_state.generator, one_state.critic),
                            one_state, coarse, fine)
    del one_state
    r0, r1 = ranks[0]["step"], ranks[1]["step"]
    unequal = sorted(k for k in r0["weights"] if not torch.equal(r0["weights"][k], r1["weights"][k]))
    check(not unequal and r0["metrics"] == r1["metrics"],
          f"spatial leg c: the two ranks differ: {unequal[:5]}")
    check(r0["forwards"] == one["forwards"], f"spatial leg c: forwards {r0['forwards']}")
    updates = {"generator": g_updates_in_window(0, SP_STEPS, n_critic), "critic": SP_STEPS}
    report = spatial_weight_check(r0["weights"], one["weights"], updates, "c")
    metric_gap = close_metrics(r0["metrics"], one["metrics"], "c")
    emit("spatial", leg="c_spatial_train_step", card=smi, batch=SP_B_STEP, shards=2,
         steps=SP_STEPS, held={"ranks": "bit_identical", "vs_one_process": report,
                               "metrics_max_rel_diff": metric_gap},
         generator_forwards=r0["forwards"])

    # (d) DP x spatial on the 2 x 2 grid against DP alone. The grid's four
    # ranks share every update; the DP baseline is two jobs of two ranks
    # (the data groups), each its own computation (cuDNN's weight-gradient
    # algorithms need not give two jobs the same bits).
    for name, coupled in (("dp_spatial", [(0, 1, 2, 3)]), ("dp", [(0, 2), (1, 3)])):
        unequal = sorted(k for group in coupled for r in group[1:]
                         for k, v in ranks[r][name]["weights"].items()
                         if not torch.equal(v, ranks[group[0]][name]["weights"][k]))
        check(not unequal, f"spatial leg d: the ranks of {name} differ: {unequal[:5]}")
    updates = {"generator": g_updates_in_window(0, SP_DP_STEPS, n_critic), "critic": SP_DP_STEPS}
    report = spatial_weight_check(ranks[0]["dp_spatial"]["weights"], ranks[0]["dp"]["weights"],
                                  updates, "d")
    metric_gap = close_metrics(ranks[0]["dp_spatial"]["metrics"], ranks[0]["dp"]["metrics"], "d")
    emit("spatial", leg="d_dp_x_spatial", card=smi, grid=list(SP_GRID), global_batch=SP_B_STEP,
         steps=SP_DP_STEPS, held={"ranks": "bit_identical (the grid's four; each DP job's two)",
                                  "vs_dp_2_ranks": report,
                                  "metrics_max_rel_diff": metric_gap},
         drb_launches_by_rank=[run["launches"] for run in ranks])
    return launches


GEN_SAMPLES = 1440  # the generate and evaluate phases' series: 9 chunks of 150 and a 90 tail
GEN_TILE_DOMAIN = (8, 56, 112)  # a series of taller domains for --tile-rows 16 (4 bands each)
GEN_MEMBERS = 4
SPLIT_DOMAIN = (8, 32, 112)  # tiles_split: 2 bands a sample, 16 tiles, 2 dispatches of 8


def restore_like_generate(checkpoint: str):
    """``(config, weights)`` of ``checkpoint`` through ``cli generate``'s own
    source resolution."""
    from downgan_tpu_torch.cli.__main__ import _resolve_source, build_parser

    parser = build_parser()
    return _resolve_source(parser.parse_args(["generate", "--checkpoint", checkpoint]), parser)


def synthetic_coarse(config, n: int) -> np.ndarray:
    from downgan_tpu_torch.data.dataset import synthetic_dataset

    return synthetic_dataset(n_samples=n, coarse_size=config.coarse_size,
                             fine_size=config.fine_size, n_covariates=config.n_covariates,
                             n_predictands=config.n_predictands, seed=config.seed)[0]


def generate_leg(config, weights, coarse, dtype_label: str):
    """The generate loop over ``coarse`` with the DRB launches counted from 0:
    ``generate_fields_iter``, held bit for bit to ``generate_fields``."""
    from downgan_tpu_torch.inference import generate_fields, generate_fields_iter
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    chunk = config.chunk_size
    n_chunks = -(-len(coarse) // chunk)
    reset_launch_counts()  # the generate path's run starts here
    blocks = list(generate_fields_iter(config, weights, coarse))  # each ends in its copy back
    launches = (drb_forward.launches, drb_forward.launches_bf16)  # ... and ends here
    want = (48 * n_chunks, 48 * n_chunks if dtype_label == "bfloat16" else 0)
    check(launches == want, f"generate ({dtype_label}): {launches} (all, bf16) DRB launches, "
          f"not {want} for {n_chunks} chunks")
    check([s for s, _ in blocks] == list(range(0, len(coarse), chunk))
          and blocks[-1][1].shape[0] == len(coarse) - chunk * (n_chunks - 1),
          f"generate ({dtype_label}): blocks {[(s, b.shape[0]) for s, b in blocks]}")
    fields = np.concatenate([b for _, b in blocks])
    check(fields.shape == (len(coarse), config.fine_size, config.fine_size, config.n_predictands)
          and np.isfinite(fields).all(), f"generate ({dtype_label}): fields {fields.shape}")
    check(np.array_equal(fields, generate_fields(config, weights, coarse)),
          f"generate ({dtype_label}): the iterator's blocks differ from generate_fields")
    return fields, launches[1] if dtype_label == "bfloat16" else launches[0], {
        "chunks": n_chunks, "chunk": chunk, "tail": len(coarse) - chunk * (n_chunks - 1),
        "fields_bytes_to_host": fields.nbytes}


def phase_generate(training_ckpt: str, tuned_ckpt: str, stochastic, smi: str):
    """Batch generation at florida width (``cli generate``'s loop): the
    ``training`` phase's checkpoint restored as ``cli generate`` restores
    it, 1,440 synthetic samples through ``generate_fields_iter`` (10
    dispatches, a 90-row tail) held to ``generate_fields`` bit for bit;
    the streamed writer's block source (``generated_blocks``) held to the
    in-memory result bit for bit: plain, tiled with ``--tile-rows 16`` and a
    4-member ensemble of the ``stochastic`` phase's generator; 4 samples
    against the CPU; the same in bf16 from the ``training_tuned`` run.
    Returns the fp32 and the bf16 DRB launches."""
    from downgan_tpu_torch.inference import generate_ensemble, generate_fields, generated_blocks
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.parallel.spatial import tiled_sr_inference

    config, weights = restore_like_generate(training_ckpt)
    check(config.filters == 16 and config.num_res_blocks == 16 and config.chunk_size == B_MAIN
          and sum(v.numel() for v in weights.values()) == 1_696_514,
          "the training phase's checkpoint is not the florida generator")
    coarse = synthetic_coarse(config, GEN_SAMPLES)
    fields, fp32_launches, loop = generate_leg(config, weights, coarse, "float32")
    cpu = generate_fields(config, weights, coarse[:4], device="cpu")
    cpu_err = float(np.abs(fields[:4] - cpu).max())
    check(np.allclose(fields[:4], cpu, atol=GEN_ATOL, rtol=GEN_RTOL),
          f"generate: card vs CPU on 4 samples {cpu_err}")

    modes = {}
    reset_launch_counts()  # the streamed block source's runs start here
    streamed = np.concatenate([b for _, _, b in generated_blocks(config, weights, coarse)])
    modes["plain"] = bool(np.array_equal(streamed, fields))
    tiles_in = np.random.default_rng(5).standard_normal((*GEN_TILE_DOMAIN, 7)).astype(np.float32)
    tiling = dict(tile_rows=16, overlap=8)
    streamed = list(generated_blocks(config, weights, tiles_in, chunk_size=3, **tiling))
    whole = tiled_sr_inference(config, weights, tiles_in, **tiling)
    modes["tiled"] = bool(np.array_equal(np.concatenate([b for _, _, b in streamed]), whole))
    sto_cfg = stochastic.config
    sto_weights = {k: v.detach().cpu() for k, v in stochastic.state.generator.state_dict().items()}
    members_in = coarse[:2 * B_MAIN]
    by_member = {}
    for m, s, b in generated_blocks(sto_cfg, sto_weights, members_in, n_members=GEN_MEMBERS):
        by_member.setdefault(m, []).append(b)
    ensemble = generate_ensemble(sto_cfg, sto_weights, members_in, GEN_MEMBERS)
    modes["ensemble"] = bool(np.array_equal(
        np.stack([np.concatenate(by_member[m]) for m in range(GEN_MEMBERS)]), ensemble))
    torch.cuda.synchronize()
    stream_launches = drb_forward.launches  # ... and end here (the in-memory references included)
    check(all(modes.values()), f"streamed blocks vs in memory, bit for bit: {modes}")
    check({m for m, _, _ in streamed} == {None} and not np.array_equal(ensemble[0], ensemble[1]),
          "tiled blocks carry a member, or the ensemble's members are equal")

    bf16_config, bf16_weights = restore_like_generate(tuned_ckpt)
    check(bf16_config.hp.compute_dtype == "bfloat16", "the tuned run's logged config is not bf16")
    bf16_fields, bf16_launches, bf16_loop = generate_leg(bf16_config, bf16_weights, coarse,
                                                         "bfloat16")
    bf16_cpu = generate_fields(bf16_config, bf16_weights, coarse[:4], device="cpu")
    bf16_err = float(np.abs(bf16_fields[:4] - bf16_cpu).max() / np.abs(bf16_cpu).max())
    check(bf16_err <= GEN_BF16_REL, f"generate bf16: card vs CPU on 4 samples {bf16_err} of "
          "the largest magnitude")
    emit("generate", card=smi, source="generate --checkpoint <the training phase's checkpoints>",
         samples=GEN_SAMPLES, fp32=loop,
         drb_launches=fp32_launches, drb_launches_per_forward=48,
         max_abs_err_vs_cpu_4=cpu_err, atol=GEN_ATOL, rtol=GEN_RTOL,
         streamed_bit_for_bit=modes, streamed_modes={
             "plain": f"{GEN_SAMPLES} samples", "tiled": f"{list(GEN_TILE_DOMAIN)} coarse, "
             "--tile-rows 16 --overlap 8, chunks of 3",
             "ensemble": f"{GEN_MEMBERS} members of the stochastic phase's generator over "
             f"{len(members_in)} samples"},
         streamed_and_reference_drb_launches=stream_launches,
         bf16={"source": "generate --checkpoint <the training_tuned run's checkpoints>",
               **bf16_loop, "drb_launches_bf16": bf16_launches,
               "max_err_vs_cpu_4_of_largest": bf16_err, "tolerance": GEN_BF16_REL})
    return fp32_launches + stream_launches, bf16_launches


def run_evaluate(argv, want_forwards: int):
    """``cli evaluate argv`` in-process with the DRB launches counted from 0
    (48 in each of ``want_forwards`` generator forwards); returns its JSON
    line's dict, what it printed on stderr and the launches."""
    import io

    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    err = io.StringIO()
    with launches_per_generator_forward() as per_forward, contextlib.redirect_stderr(err):
        reset_launch_counts()  # the evaluate path's run starts here
        result = cli_main(["evaluate", *argv])
        torch.cuda.synchronize()
        launches = drb_forward.launches  # ... and ends here
    check(len(per_forward) == want_forwards and set(per_forward) == {48}
          and launches == 48 * want_forwards,
          f"evaluate {argv}: {launches} DRB launches over {len(per_forward)} forwards, "
          f"not 48 in each of {want_forwards}")
    check(all(np.isfinite(v) for v in result.values() if isinstance(v, float)),
          f"evaluate {argv}: {result}")
    return result, err.getvalue(), launches


def phase_evaluate(training_ckpt: str, ema_run, stochastic_ckpt: str, workdir: Path, smi: str):
    """``cli evaluate`` at florida width, in-process: the ``training``
    phase's checkpoint over 1,440 synthetic samples (12 batches of 128, a
    32-row tail, Wass from the checkpoint's critic); then at 144 samples the
    same checkpoint, held to the same command on the CPU, the ``resume``
    phase's EMA run with ``--ema``, the exported bundle (no Wass, the
    warning on stderr) and a 4-member ensemble of the ``stochastic`` run.
    Returns the DRB launches."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main

    batches = -(-GEN_SAMPLES // B_TRAIN)
    runs, launches = {}, 0
    out = workdir / "evaluate.json"
    result, _, n = run_evaluate(["--checkpoint", training_ckpt, "--out", str(out),
                                 "--synthetic", "--samples", str(GEN_SAMPLES)], batches)
    check(json.loads(out.read_text()) == result and result["n_samples"] == GEN_SAMPLES
          and {"MAE", "MSE", "MSSSIM", "Wass"} <= result.keys(), f"evaluate: {result}")
    runs["checkpoint"], launches = result, launches + n
    # The other runs at 144 samples (2 batches, a 16-row tail): each command
    # makes its synthetic set anew on the host.
    small = ["--synthetic", "--samples", "144"]
    small_batches = -(-144 // B_TRAIN)
    card, _, n = run_evaluate(["--checkpoint", training_ckpt, *small], small_batches)
    runs["checkpoint_144"], launches = card, launches + n
    ema_ckpt, ema_config = ema_run
    result, _, n = run_evaluate(["--checkpoint", ema_ckpt, "--config", str(ema_config),
                                 "--ema", *small], small_batches)
    runs["ema"], launches = result, launches + n
    bundle = cli_main(["export", "--checkpoint", training_ckpt, "--out", str(workdir / "bundle")])
    result, stderr, n = run_evaluate(["--checkpoint", bundle, "--weights-only", *small],
                                     small_batches)
    check("Wass" not in result and "dropping the Wass metric" in stderr
          and result["MAE"] == card["MAE"],
          f"evaluate --weights-only: {result}, stderr {stderr!r}")
    runs["weights_only"], launches = {**result, "stderr": stderr.strip()}, launches + n
    ens_forwards = small_batches + GEN_MEMBERS * -(-144 // B_MAIN)
    result, _, n = run_evaluate(["--checkpoint", stochastic_ckpt, "--ensemble",
                                 str(GEN_MEMBERS), *small], ens_forwards)
    check(result["n_members"] == GEN_MEMBERS and result["spread"] > 0, f"ensemble: {result}")
    runs["ensemble"], launches = result, launches + n
    cpu = cli_main(["evaluate", "--checkpoint", training_ckpt, *small, "--device", "cpu"])
    far = {k: (card[k], v) for k, v in cpu.items() if isinstance(v, float)
           and not abs(card[k] - v) <= STEP_ATOL + STEP_RTOL * abs(v)}
    check(not far, f"evaluate at 144 samples, card vs CPU beyond rtol {STEP_RTOL} atol "
          f"{STEP_ATOL}: {far}")
    emit("evaluate", card=smi, samples=GEN_SAMPLES, batch=B_TRAIN, batches=batches, runs=runs,
         vs_cpu_144={"card": card, "cpu": cpu, "rtol": STEP_RTOL, "atol": STEP_ATOL},
         drb_launches=launches, drb_launches_per_forward=48)
    return launches


def phase_tiles_split(training_ckpt: str, stochastic, smi: str):
    """Tiles split over replicas: ``tiled_sr_inference(devices=["cuda:0",
    "cuda:0"])`` against ``devices=["cuda:0"]`` on 8 samples of 32x112,
    deterministic (the training run) and stochastic, bit for bit (the
    replicas run cuDNN's convolutions at half the batch, with the
    algorithms cuDNN picks), and a ``BatchingSRModel(devices=[...] * 2)``
    domain request against the one-device model. Returns the DRB launches
    of the split runs."""
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.parallel.spatial import effective_fold, tiled_sr_inference
    from downgan_tpu_torch.serving import BatchingSRModel, SRModel

    config, weights = restore_like_generate(training_ckpt)
    nets = {"deterministic": (config, weights),
            "stochastic": (stochastic.config, {k: v.detach().cpu() for k, v in
                                               stochastic.state.generator.state_dict().items()})}
    x = np.random.default_rng(7).standard_normal((*SPLIT_DOMAIN, 7)).astype(np.float32)
    kw = dict(tile_rows=16, overlap=8, tiles_per_dispatch=8)
    dispatches = -(-SPLIT_DOMAIN[0] * 2 // effective_fold(8, 2))
    report, launches = {}, 0
    for name, (cfg, sd) in nets.items():
        one = tiled_sr_inference(cfg, sd, x, devices=["cuda:0"], **kw)
        reset_launch_counts()  # the split path's run starts here
        two = tiled_sr_inference(cfg, sd, x, devices=["cuda:0"] * 2, **kw)
        torch.cuda.synchronize()
        n = drb_forward.launches  # ... and ends here
        check(n == 48 * 2 * dispatches, f"tiles_split {name}: {n} DRB launches")
        launches += n
        report[name] = {"bit_for_bit": bool(np.array_equal(one, two)),
                        "max_abs_diff": float(np.abs(one - two).max())}
        check(report[name]["bit_for_bit"], f"tiles_split {name}: two replicas differ from one "
              f"by {report[name]['max_abs_diff']}")
    cfg, sd = nets["deterministic"]
    direct = SRModel(cfg, sd, batch_size=B_MAIN)
    served = BatchingSRModel(cfg, sd, batch_size=B_MAIN, devices=["cuda:0"] * 2)
    try:
        got = served.generate_domain(x, **kw)
        served_dispatches = served.stats()["dispatches"]
    finally:
        served.close()
    want = direct.generate_domain(x, **kw)
    check(np.array_equal(got, want) and served_dispatches == dispatches,
          f"BatchingSRModel over 2 replicas: {float(np.abs(got - want).max())}, "
          f"{served_dispatches} dispatches")
    emit("tiles_split", card=smi, domain=list(SPLIT_DOMAIN), tiling=kw,
         replicas=["cuda:0", "cuda:0"], dispatches=dispatches, nets=report,
         batching_model_bit_for_bit=True, drb_launches=launches)
    return launches

# The JAX package's FLOP census of florida at B=128 on the reference
# schedule (utils/flops.py over 5 steps from step 0; XLA's cost analysis of
# the lowered pieces, JAX on a CPU host), for comparison with the port's:
# XLA counts only the taps of a SAME conv inside the image (8.2 % of a 3x3
# conv's taps are padding at 16x16) and one FLOP an element for
# elementwise ops; the port's census counts every tap and no elementwise op.
JAX_CENSUS_FLORIDA = {"fake_gen": 1.2395e11, "critic_vag_microbatch": 2.4477e11,
                      "gen_vag_microbatch": 4.2102e11, "metrics": 5.0387e10,
                      "flops_per_step": 6.2726e11}
# Grid rows on the card against the same rows on the CPU (the generator
# phase measured 4.3e-7 between the card's and the CPU's florida forward).
GRID_ATOL = GRID_RTOL = 1e-5
GRID_SAMPLES = 144  # the grid's pool: the synthetic set's test split at 1,440


def profile_leg(argv, out: Path, kernel: str, bf16: bool) -> dict:
    """``cli profile argv --out out`` in-process with the DRB launches counted
    from 0: 48 in each generator forward it reports, the trace naming
    ``kernel``; returns what its JSON line and the trace count (the trace is
    deleted after the check)."""
    import shutil

    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.ops.cuda.drb import drb_forward

    reset_launch_counts()  # the profile path's run starts here
    result = cli_main(["profile", *argv, "--out", str(out)])
    torch.cuda.synchronize()
    launches, launches_bf16 = drb_forward.launches, drb_forward.launches_bf16  # ... and ends here
    traces = sorted(out.glob("*.pt.trace.json"))
    check(len(traces) == 1, f"profile {argv}: traces {traces}")
    text = traces[0].read_text()
    names = sorted(set(re.findall(r'"name": "[^"]*(drb_kernel\w*)', text)))
    trace_bytes = traces[0].stat().st_size
    shutil.rmtree(out)
    check(launches == 48 * result["generator_forwards"] == result["drb_launches"]
          and launches_bf16 == (launches if bf16 else 0),
          f"profile {argv}: {launches} DRB launches ({launches_bf16} bf16) for "
          f"{result['generator_forwards']} generator forwards")
    check(kernel in names, f"profile {argv}: the trace names {names}, not {kernel}")
    check(result["steps_per_s"] > 0 and result["hbm"].get("peak_bytes_in_use", 0) > 0,
          f"profile {argv}: {result}")
    return {**{k: result[k] for k in ("mode", "steps", "batch", "schedule", "patches_per_step",
                                      "generator_forwards", "drb_launches", "device")},
            "trace_bytes": trace_bytes, "trace_kernel_names": names, "launches": launches}


def phase_tooling(training_ckpt: str, tracking_root: Path, smi: str):
    """The rest of the CLI on the card, in-process through ``cli main``, at
    florida width: (a) ``profile`` (the generator forward at B=150 fp32; 3
    reference steps at B=128 fp32; 2 fused bf16 rounds of
    examples/production_tuned.json): its JSON line, a Chrome trace naming the
    DRB kernel, 48 launches a generator forward; (b) the FLOP census of
    florida at B=128, reference and tuned, on ``meta`` equal to the CPU's at
    batch 1 scaled, beside the JAX package's figures; (c) ``tune`` over 2
    fp32 reference candidates (B=64 and 128) in their own processes, the
    recommended config through ``show-config``; (d) ``import-torch`` of a seeded florida
    generator and critic in the reference layout: the bundle's tensors and
    its forward at B=150 bit for bit the weights loaded straight; the
    ``training`` phase's checkpoint through ``export-torch`` and
    ``import-torch`` again, bit for bit; (e) grid rows (the trainer's plot
    forward) on the card against the CPU, the trainer's note that the
    figures are skipped without matplotlib, ``export-mlflow`` of the
    ``training`` run and ``serve-tracking`` over its tracking root. Returns
    the fp32 and the bf16 DRB launches."""
    from downgan_tpu_torch.cli.__main__ import main as cli_main
    from downgan_tpu_torch.config.config import Config
    from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset
    from downgan_tpu_torch.inference import load_bundle
    from downgan_tpu_torch.ops.cuda.drb import drb_forward
    from downgan_tpu_torch.tracking import TrackingStore
    from downgan_tpu_torch.training.state import load_generator, make_critic, make_generator
    from downgan_tpu_torch.training.trainer import Trainer, grid_rows
    from downgan_tpu_torch.utils.flops import train_flop_census
    from downgan_tpu_torch.utils.plots import have_matplotlib

    florida = ROOT / "examples" / "florida.json"
    tuned_json = ROOT / "examples" / "production_tuned.json"
    config = Config.from_json(florida.read_text())
    tuned = Config.from_json(tuned_json.read_text())
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tooling_"))
    launches = launches_bf16 = 0

    # (a) profile
    profiles = {
        "infer_b150_fp32": profile_leg(["--config", str(florida), "--mode", "infer", "--steps",
                                        "5", "--batch-size", str(B_MAIN)],
                                       work / "p_infer", "drb_kernel", False),
        "train_b128_fp32_reference": profile_leg(["--config", str(florida), "--mode", "train",
                                                  "--steps", "3"], work / "p_train",
                                                 "drb_kernel", False),
        "train_b128_bf16_fused": profile_leg(["--config", str(tuned_json), "--mode", "train",
                                              "--steps", "2"], work / "p_tuned",
                                             "drb_kernel_bf16", True)}
    check(profiles["train_b128_bf16_fused"]["patches_per_step"] == 5 * B_TRAIN
          and profiles["train_b128_bf16_fused"]["schedule"] == "fused",
          "profile: a fused round is not critic_iterations x B patches")
    launches += sum(p["launches"] for k, p in profiles.items() if "bf16" not in k)
    launches_bf16 += profiles["train_b128_bf16_fused"]["launches"]

    # (b) the census: meta here against the CPU at batch 1, scaled
    census = {}
    for name, cfg, steps, start in (("reference", config, 5, 0), ("tuned", tuned, 1, 0)):
        meta = train_flop_census(cfg, steps, start_step=start)
        cpu = train_flop_census(cfg, steps, start_step=start, device="cpu")
        check(meta == cpu, f"census {name}: meta {meta} != cpu {cpu}")
        census[name] = meta
    ref = census["reference"]
    census["reference"]["vs_jax"] = {k: ref["pieces"].get(k, ref.get(k)) / v
                                     for k, v in JAX_CENSUS_FLORIDA.items()}

    # (c) tune: two candidates, each in its own process
    tuned_out, sweep_out = work / "tuned.json", work / "sweep.json"
    report = cli_main(["tune", "--config", str(florida), "--batches", "64,128", "--dtypes",
                       "float32", "--schedules", "reference", "--no-fast-paths",
                       "--scan-steps", "3", "--reps", "1", "--out", str(tuned_out),
                       "--sweep-out", str(sweep_out)])
    sweep = json.loads(sweep_out.read_text())["sweep"]
    check(len(report["candidates"]) == 2 and len(sweep) == 2
          and all(r["device"] == torch.cuda.get_device_name(0) and r["value"] > 0
                  and r["drb_launches"] == 48 * r["generator_forwards"] > 0 for r in sweep),
          f"tune: {report}")
    shown = Config.from_json(cli_main(["show-config", "--config", str(tuned_out)]))
    check(shown.hp.batch_size == report["best"]["batch"] and shown.filters == config.filters,
          f"tune's config through show-config: {shown.hp}")
    tune_launches = sum(r["drb_launches"] for r in sweep)
    launches += tune_launches

    # (d) import-torch and export-torch
    g_sd = make_generator(config, "cpu", rng=torch.Generator().manual_seed(21)).state_dict()
    c_sd = make_critic(config, "cpu", rng=torch.Generator().manual_seed(22)).state_dict()
    torch.save(g_sd, work / "reference_generator.pt")
    torch.save(c_sd, work / "reference_critic.pt")
    reset_launch_counts()  # the import path's run starts here
    bundle = cli_main(["import-torch", "--weights", str(work / "reference_generator.pt"),
                       "--critic-weights", str(work / "reference_critic.pt"), "--config",
                       str(florida), "--out", str(work / "imported")])
    b_config, b_g, b_c = load_bundle(bundle)
    x = torch.randn(B_MAIN, config.n_covariates, config.coarse_size, config.coarse_size,
                    generator=torch.Generator().manual_seed(23)).cuda()
    with torch.no_grad():
        served = load_generator(b_config, b_g, "cuda")(x)
        torch.cuda.synchronize()
        import_launches = drb_forward.launches  # ... and ends here (check forward, bundle forward)
        direct = load_generator(config, g_sd, "cuda")(x)
    check(all(torch.equal(b_g[k], g_sd[k]) for k in g_sd) and b_g.keys() == g_sd.keys()
          and all(torch.equal(b_c[k], c_sd[k]) for k in c_sd),
          "import-torch: the bundle's tensors are not the reference file's")
    check(torch.equal(served, direct), "import-torch: the bundle's forward is not the direct "
          f"load's, {(served - direct).abs().max().item()}")
    check(import_launches == 2 * 48, f"import-torch: {import_launches} DRB launches for the "
          "check forward and the bundle's forward")
    exported = cli_main(["export-torch", "--checkpoint", training_ckpt, "--out",
                         str(work / "exported.pt")])
    reset_launch_counts()
    again = cli_main(["import-torch", "--weights", exported, "--config", str(florida), "--out",
                      str(work / "reimported")])
    import_launches += drb_forward.launches
    from downgan_tpu_torch.utils.checkpoint import CheckpointManager

    trained = CheckpointManager(training_ckpt).restore()["generator"]
    _, again_g, _ = load_bundle(again)
    check(again_g.keys() == trained.keys()
          and all(torch.equal(again_g[k], trained[k].cpu()) for k in trained),
          "export-torch then import-torch: not the training checkpoint's tensors")
    launches += import_launches

    # (e) grid rows, the figures' note, export-mlflow, serve-tracking
    coarse, fine = synthetic_dataset(n_samples=GRID_SAMPLES, coarse_size=config.coarse_size,
                                     fine_size=config.fine_size, n_covariates=config.n_covariates,
                                     n_predictands=config.n_predictands, seed=config.seed)
    gen = load_generator(config, trained, "cuda").train()
    reset_launch_counts()
    rows = grid_rows(config, gen, DeviceDataset.from_numpy(coarse, fine, "cuda"))
    torch.cuda.synchronize()
    grid_launches = drb_forward.launches
    cpu_rows = grid_rows(config, load_generator(config, trained, "cpu"),
                         DeviceDataset.from_numpy(coarse, fine, "cpu"))
    grid_err = float(np.abs(rows[1] - cpu_rows[1]).max())
    check(rows[1].shape == (20, config.fine_size, config.fine_size, config.n_predictands) and np.array_equal(rows[0], cpu_rows[0])
          and np.array_equal(rows[2], cpu_rows[2])
          and np.allclose(rows[1], cpu_rows[1], atol=GRID_ATOL, rtol=GRID_RTOL),
          f"grid rows: card vs CPU fake {grid_err}")
    check(grid_launches == 48, f"grid rows: {grid_launches} DRB launches")
    launches += grid_launches
    import io

    err = io.StringIO()
    store = TrackingStore(str(work / "notes"))
    note_run = store.create_run(store.create_experiment("note")).start()
    small = DeviceDataset.from_numpy(coarse[:B_TRAIN], fine[:B_TRAIN], "cuda")
    with contextlib.redirect_stderr(err):
        note_trainer = Trainer(config, small, device="cuda", run=note_run)
    note = [ln for ln in err.getvalue().splitlines() if "grid figures skipped" in ln]
    check(len(note) == (0 if have_matplotlib() else 1) and note_trainer._plots == have_matplotlib(),
          f"the figures' note: {err.getvalue()!r}")
    del note_trainer

    run_id = Path(training_ckpt).parent.parent.name
    mlruns = work / "mlruns"
    written = cli_main(["export-mlflow", "--run", run_id, "--tracking-root", str(tracking_root),
                        "--out", str(mlruns)])
    run_dir = Path(written[0])
    run_files = sorted(p.name for p in run_dir.iterdir())
    lines = (run_dir / "metrics" / "MAE_train").read_text().splitlines()
    check((run_dir / "meta.yaml").exists() and (run_dir.parent / "meta.yaml").exists()
          and [int(ln.split()[2]) for ln in lines] == [0, 1]
          and (run_dir / "artifacts" / "config.json").exists()
          and not (run_dir / "artifacts" / "checkpoints").exists(),
          f"export-mlflow: {run_files}, MAE_train {lines}")
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "downgan_tpu_torch.cli", "serve-tracking",
                             "--root", str(tracking_root), "--host", "127.0.0.1", "-p", str(port)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "PYTHONPATH": str(ROOT)})
    pages = {}
    try:
        deadline = time.perf_counter() + 90
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as r:
                    pages["/"] = r.status
                break
            except OSError:
                check(proc.poll() is None and time.perf_counter() < deadline,
                      f"serve-tracking did not answer: {proc.poll()}")
                time.sleep(0.5)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/run/{run_id}", timeout=5) as r:
            pages[f"/run/{run_id}"] = r.status
            body = r.read().decode()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    check(set(pages.values()) == {200} and "MAE_train" in body, f"serve-tracking: {pages}")
    import shutil

    shutil.rmtree(work)
    emit("tooling", card=smi, profiles=profiles, census=census, census_jax=JAX_CENSUS_FLORIDA,
         tune={"candidates": [r["metric"] for r in report["candidates"]],
               "best": {k: report["best"][k]
                        for k in ("batch", "dtype", "schedule", "grad_accum")},
               "drb_launches": tune_launches},
         import_torch={"bundle_bit_for_bit": True, "roundtrip_bit_for_bit": True,
                       "drb_launches": import_launches},
         grid={"max_abs_err_fake_vs_cpu": grid_err, "atol": GRID_ATOL, "rtol": GRID_RTOL,
               "drb_launches": grid_launches, "figures_note": note},
         export_mlflow={"run_dir_files": run_files,
                        "MAE_train_lines": len(lines)},
         serve_tracking=pages,
         packages=package_versions(("matplotlib", "tensorboardX", "mlflow", "yaml")),
         drb_launches=launches, drb_launches_bf16=launches_bf16)
    return launches, launches_bf16


def emit_kernels(smi: str, fp32_paths: dict, bf16_paths: dict, wide_launches: int,
                 backward_launches: int, wide_backward_launches: int) -> None:
    """The ``{"kernels": [...]}`` line: each hand-written kernel's launches
    on the main paths (each path's counters zeroed just before its run and
    read at its end) and, where the benchmark has one, its bound at the
    main path's shapes from the benchmark's own function. The kernels'
    times are ``tools/time_kernels.py``'s."""
    from portbench import flops
    from portbench.reference import esrgan

    common = {"source": "downgan_tpu_torch/ops/cuda/drb.cu", "times": "tools/time_kernels.py",
              "card": smi}
    florida = "downgan_tpu/ops/pallas/drb.py:120"
    print(json.dumps({"kernels": [{
        "name": "drb_kernel", "dtype": "float32", "replaces": florida, **common,
        "launches": sum(fp32_paths.values()), "launches_by_path": fp32_paths,
        "bound": "portbench.flops.drb_bound_seconds",
        "bound_ms": {"B150": 1e3 * flops.drb_bound_seconds(B_MAIN, 16, 16, 16, "float32"),
                     "B128": 1e3 * flops.drb_bound_seconds(B_TRAIN, 16, 16, 16, "float32")}}, {
        "name": "drb_kernel_bf16", "dtype": "bfloat16", "replaces": florida, **common,
        "launches": sum(bf16_paths.values()), "launches_by_path": bf16_paths,
        "bound": "portbench.flops.drb_bound_seconds",
        "bound_ms": {"B150": 1e3 * flops.drb_bound_seconds(B_MAIN, 16, 16, 16, "bfloat16"),
                     "B128": 1e3 * flops.drb_bound_seconds(B_TRAIN, 16, 16, 16, "bfloat16")}}, {
        "name": "drb_kernel_wide", "dtype": "float32",
        "replaces": "none: ESRGAN's block (nf 64, gc 32) has no TPU kernel", **common,
        "launches": wide_launches, "launches_by_path": {"esrgan": wide_launches},
        "bound": "portbench.reference.esrgan.drb_bound_seconds",
        "bound_ms": {"B128": 1e3 * esrgan.drb_bound_seconds(B_TRAIN, 64, 32, 16, 16)}}, {
        "name": "drb_backward_kernel+drb_grad_reduce", "dtype": "float32",
        "replaces": "none: the JAX package differentiates its DRB with XLA convolutions",
        **common, "launches": backward_launches, "launches_by_path": {"training": backward_launches},
        "bound": "none in the benchmark (tools/time_kernels.py::backward_bound_seconds)"}, {
        "name": "drb_backward_kernel_wide+drb_grad_reduce_wide", "dtype": "float32",
        "replaces": "none: ESRGAN's block (nf 64, gc 32) has no TPU kernel", **common,
        "launches": wide_backward_launches,
        "launches_by_path": {"esrgan": wide_backward_launches},
        "bound": "none in the benchmark (tools/time_kernels.py::backward_bound_seconds)"}]}),
        flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--train-cli":
        return train_cli_child(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    from downgan_tpu_torch.config.config import Config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi, name = phase_device()
    phase_build()
    phase_kernels()
    rng = torch.Generator().manual_seed(1234)
    config = Config.from_json((ROOT / "examples" / "florida.json").read_text())
    gen = phase_generator(config, rng)
    phase_generator_bf16(config, rng)
    serving_launches = phase_serving(config, gen, rng)
    check(serving_launches > 0, "the serving path launched no DRB kernel")
    esrgan_launches, esrgan_backward_launches = phase_esrgan(rng)
    phase_train_parity(config)
    phase_fused_parity()
    phase_variants_parity(config)
    # The training runs stay on disk for the generate and evaluate phases.
    training_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_training_")
    tracking_root = Path(training_dir.name)
    training_launches, backward_launches, training_ckpt = phase_training(tracking_root)
    check(training_launches > 0, "the training path launched no DRB kernel")
    tuned_launches, tuned, trained = phase_training_tuned(tracking_root)
    bf16_serving_launches = phase_serving_bf16(tuned, trained, rng)
    tuned_ckpt = tuned.ckpt.directory
    del tuned, trained
    check(tuned_launches > 0 and bf16_serving_launches > 0,
          "the tuned training or bf16 serving path launched no bf16 DRB kernel")
    resume_launches, bundle_launches, device_run, (resume_dir, *ema_run) = phase_resume(
        config, rng, smi)
    check(resume_launches > 0 and bundle_launches > 0,
          "the resume or bundle-serving path launched no DRB kernel")
    host_feed_launches = phase_host_feed(device_run, smi)
    del device_run
    stream_launches = phase_stream(config, smi)
    check(host_feed_launches > 0 and stream_launches > 0,
          "the host-fed or streaming path launched no DRB kernel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stochastic_") as tracking_root:
        stochastic_launches, stochastic = phase_stochastic(config, rng, Path(tracking_root), smi)
        ensemble_launches = phase_ensemble(stochastic, smi)
        serving_stochastic_launches = phase_serving_stochastic(stochastic, rng, smi)
        generate_launches, generate_bf16_launches = phase_generate(training_ckpt, tuned_ckpt,
                                                                   stochastic, smi)
        evaluate_launches = phase_evaluate(training_ckpt, ema_run, stochastic.ckpt.directory,
                                           Path(tracking_root), smi)
        split_launches = phase_tiles_split(training_ckpt, stochastic, smi)
        del stochastic
        resume_dir.cleanup()
        phase_srresnet(config, rng, Path(tracking_root), smi)
    check(stochastic_launches > 0 and ensemble_launches > 0 and serving_stochastic_launches > 0,
          "a stochastic path launched no DRB kernel")
    check(generate_launches > 0 and generate_bf16_launches > 0 and evaluate_launches > 0
          and split_launches > 0, "a batch inference path launched no DRB kernel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_") as tracking_root:
        variants_launches = phase_variants(Path(tracking_root))
        variants_tuned_launches = phase_variants_tuned(Path(tracking_root))
    check(variants_launches > 0 and variants_tuned_launches > 0,
          "a training-variant path launched no DRB kernel")
    dp_launches, dp_bf16_launches = phase_dp(smi)
    check(dp_launches > 0 and dp_bf16_launches > 0, "a data-parallel path launched no DRB kernel")
    spatial_launches = phase_spatial(smi)
    check(spatial_launches > 0, "the spatially sharded path launched no DRB kernel")
    tooling_launches, tooling_bf16_launches = phase_tooling(training_ckpt,
                                                            Path(training_dir.name), smi)
    training_dir.cleanup()
    check(tooling_launches > 0 and tooling_bf16_launches > 0,
          "the tooling paths launched no DRB kernel")
    fp32_paths = {"serving": serving_launches, "training": training_launches,
                  "resume": resume_launches, "bundle_serving": bundle_launches,
                  "host_feed": host_feed_launches, "stream": stream_launches,
                  "stochastic": stochastic_launches, "ensemble": ensemble_launches,
                  "serving_stochastic": serving_stochastic_launches,
                  "generate": generate_launches, "evaluate": evaluate_launches,
                  "tiles_split": split_launches, "variants": variants_launches,
                  "dp": dp_launches, "spatial": spatial_launches, "tooling": tooling_launches}
    bf16_paths = {"training_tuned": tuned_launches, "serving_bf16": bf16_serving_launches,
                  "generate_bf16": generate_bf16_launches,
                  "variants_tuned": variants_tuned_launches, "dp_tuned": dp_bf16_launches,
                  "tooling": tooling_bf16_launches}
    emit_kernels(smi, fp32_paths, bf16_paths, esrgan_launches, backward_launches,
                 esrgan_backward_launches)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
