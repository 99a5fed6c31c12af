"""Fused DenseResidualBlock forward: the CUDA kernel's wrapper, its weight
packing, its build on first use, and its plain PyTorch twin, in fp32 and
in bf16, and ESRGAN's wide block in fp32.

Counterpart of ``downgan_tpu/ops/pallas/drb.py`` (the Pallas TPU kernel
``drb_forward``). The kernels themselves are ``drb.cu`` beside this file;
its header says what they compute, what bounds them on Hopper and how they
are laid out (tensor-core implicit GEMMs over (sample, 16x16 tile) units:
3xTF32 ``mma.sync`` for fp32; for bf16, ``wgmma`` with fp32 accumulators on
a channel-last shared-memory frame, its weights and input brought in by
bulk copies). A block computes in its input's dtype; its parameters (fp32
in the models) are rounded to that dtype.

A block is (filters, growth, slope): stage s reads filters + growth (s - 1)
channels and writes growth (stage 5: filters), LeakyReLU of ``slope`` on
stages 1-4. DoWnGAN's block has growth = filters and slope 0.01
(:data:`SLOPE`), ESRGAN's growth 32 and slope 0.2. The growth is read off
the weights' shapes; the slope is an argument. The kernels take DoWnGAN's
block at filters 8 and 16 (fp32, bf16) and ESRGAN's at (64, 32) and 16x16
(fp32, ``drb_kernel_wide``). Here:

* :func:`pack_drb_weights` lays a block's five OIHW conv weights out once
  per weight set in the order the kernel reads them, followed by the
  biases: for fp32, split into TF32 hi and lo parts (:func:`tf32_split`) in
  the MMA's fragment order; for bf16, rounded to bf16 in ``wgmma``'s
  canonical B layout;
* :func:`drb_forward` is the wrapper. On a CPU tensor it runs the plain
  twin; on a CUDA tensor it launches the kernel of the input's dtype or
  raises — nothing falls back to the twin on the card;
* :func:`drb_forward_reference` is the plain twin: the same function as
  the kernel (nine shifted channel products per stage, summed in fp32; in
  bf16 rounded at the kernel's three points) in PyTorch. CPU runs use it,
  and the ``cuda``-marked tests hold the kernel against it;
* :class:`DRBFunction` is the DRB under autograd on the card: its forward
  is the kernel. Its backward is :func:`drb_backward_kernel` (one
  ``drb_backward_kernel`` launch and a fixed-order reduction) for DoWnGAN's
  block in fp32 at 16x16, :func:`drb_backward_kernel_wide` (the same for
  ESRGAN's block, ``drb_backward_kernel_wide``) for that block in fp32 at
  16x16, and :func:`drb_backward` for every other input:
  it recomputes the block from the saved input with :func:`cudnn_chain`
  (five ``F.conv2d`` in the input's dtype, cuDNN on the card) and
  differentiates that. It is first order only. The JAX package's DRB has no
  backward kernel: its gradients are XLA convolutions;
* :func:`drb_backward_reference` is the backward kernels' plain twin: the
  recompute, then per stage the mask, the weight and bias sums and the
  shifted-product input gradient, in PyTorch;
* :func:`drb` is what the generator's blocks call: ``DRBFunction`` when
  autograd needs a gradient through a CUDA tensor, ``drb_forward``
  otherwise;
* :func:`load_library` compiles ``drb.cu`` with ``nvcc`` for ``sm_90a``
  into ``build/torch_ext/`` at the repository root (once per source
  content) and loads it with ctypes. A failed build raises;
* :func:`bf16_occupancy` reports the bf16 kernel's shared memory per CTA
  and resident CTAs per SM for a shape.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from downgan_tpu_torch.utils.profiling import annotate

SLOPE = 0.01  # torch nn.LeakyReLU() default, as in the generator
RES_SCALE = 0.2
SUPPORTED_FILTERS = (8, 16)
#: ESRGAN's block, the wide kernel's only one: (filters, growth, slope), fp32, 16x16.
WIDE_BLOCK = (64, 32, 0.2)
WIDE_SIDE = 16
#: The backward kernel's only spatial size (florida's trunk, whole samples).
BACKWARD_SIDE = 16
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

SOURCE = Path(__file__).with_name("drb.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()
_lib = None
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the build of the current ``drb.cu`` lives: the file name
    carries a hash of the source and the flags, so an edit rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdrb_{digest}.so"


def load_library() -> ctypes.CDLL:
    """Build ``drb.cu`` if this source has no build yet, then load it.

    The compiler's report (registers, shared memory, spills from
    ``-Xptxas -v``) is kept beside the library as ``<name>.log``.
    """
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            so.with_suffix(".log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {SOURCE}:\n"
                    f"{res.stderr[-4000:]}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        lib = ctypes.CDLL(str(so))
        lib.drb_forward_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.drb_forward_f32.restype = ctypes.c_int
        lib.drb_forward_bf16.argtypes = lib.drb_forward_f32.argtypes
        lib.drb_forward_bf16.restype = ctypes.c_int
        lib.drb_forward_f32_wide.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                             + [ctypes.c_void_p])
        lib.drb_forward_f32_wide.restype = ctypes.c_int
        lib.drb_backward_f32.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_void_p * 10]
                                         + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.drb_backward_f32.restype = ctypes.c_int
        lib.drb_backward_f32_wide.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                              + [ctypes.c_void_p])
        lib.drb_backward_f32_wide.restype = ctypes.c_int
        lib.drb_error_string.argtypes = [ctypes.c_int]
        lib.drb_error_string.restype = ctypes.c_char_p
        lib.drb_bf16_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
        lib.drb_bf16_occupancy.restype = ctypes.c_int
        _lib = lib
        return lib


def bf16_occupancy(f: int, h: int, w: int) -> tuple[int, int]:
    """(dynamic shared memory bytes per CTA, resident CTAs per SM) of the
    bf16 kernel for a (B, f, h, w) input on the current card, from the
    CUDA occupancy API."""
    lib = load_library()
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    err = lib.drb_bf16_occupancy(f, h, w, ctypes.byref(smem), ctypes.byref(ctas))
    if err:
        raise RuntimeError(f"occupancy query failed: {lib.drb_error_string(err).decode()}")
    return smem.value, ctas.value


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero, as
    ``cvt.rna.tf32.f32``), kept as fp32 with its low 13 mantissa bits zero."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32-exact, with hi + lo = t to within 2**-22 |t|:
    the 3xTF32 split the kernel applies to both operands."""
    hi = tf32_round(t)
    return hi, tf32_round(t.to(torch.float32) - hi)


def bf16_chunks(f: int, s: int) -> int:
    """k16 chunks of stage ``s``'s concat (s*f channels, padded to a
    multiple of 16 at F = 8 and odd s): the bf16 kernel takes one k-step
    per chunk and kernel row."""
    return -(-s * f // 16)


def stage_widths(f: int, growth: int | None = None) -> list[tuple[int, int]]:
    """(inputs, outputs) of the five stages of a block of ``f`` filters
    growing by ``growth`` (default ``f``) channels a stage."""
    g = f if growth is None else growth
    return [(f + g * (s - 1), g if s < 5 else f) for s in range(1, 6)]


def packed_size(f: int, dtype: torch.dtype = torch.float32, growth: int | None = None) -> int:
    """Elements of :func:`pack_drb_weights`'s output for ``f`` filters (and
    ``growth``, default ``f``; fp32 only otherwise): fp32 values for fp32,
    32-bit words (two bf16 weights, or one fp32 bias) for bf16."""
    if dtype == torch.bfloat16:
        return 9 * f * 8 * sum(bf16_chunks(f, s) for s in range(1, 6)) + 5 * f
    if growth is None or growth == f:
        return 2 * 9 * f * f * 15 + 5 * f
    return sum(2 * 9 * cin * cout + cout for cin, cout in stage_widths(f, growth))


def pack_drb_weights(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Five stages' OIHW weights (F, s*F, 3, 3) and biases (F,) -> one flat
    tensor of :func:`packed_size` elements for the kernel of ``dtype``
    (bf16, or the fp32 kernel's layout for any other dtype). Call once per
    weight set. The fp32 layout takes any stage widths that are multiples
    of 8 (ESRGAN's (64 + 32(s - 1), 32) and (192, 64) for the wide kernel).

    fp32 (a float32 tensor): stage s (in order) holds its m16n8k8 TF32 B
    fragments, hi and lo: with ci = 8*chunk + 4*half + tq, co = 8*nt + gq,
    tap = 3*dy + dx and NT = the stage's outputs / 8, ``w[co, ci, dy, dx]``'s
    part p (0 = hi, 1 = lo) lands at ``((((chunk*9 + tap)*NT + nt)*32 + 4*gq + tq)*4 + 2*p
    + half`` within the stage: each lane reads one float4 (hi b0, hi b1, lo
    b0, lo b1) per k-step and n-tile. The five biases follow the stages.

    bf16 (an int32 tensor of bf16x2 words): the weights rounded to bf16 in
    ``wgmma``'s canonical K-major B layout without swizzle, with the three
    dx taps of a kernel row side by side in N (N = 3F: column n = dx*F +
    co). Stage s has :func:`bf16_chunks` k16 chunks c of its concat (input
    channels 16c .. 16c + 15, zero past s*F) and takes one k-step per
    (c, dy), in that order; a k-step is 3F x 16 bf16 (1,536 B at F = 16,
    768 B at F = 8) of 8x8 core matrices, 16 B per column. With n = 8*nb +
    r and ci = 16*c + 8*kb + e, ``w[co, ci, dy, dx]`` is bf16 element
    ``(c*3 + dy)*48*F + nb*128 + kb*64 + r*8 + e`` of the stage: core
    matrices one K step (kb) 128 B apart (the descriptor's LBO), one N step
    (nb) 256 B apart (its SBO). Every stage is a multiple of 16 B, so each
    is one bulk copy. The five biases follow as fp32 words holding their
    bf16 values."""
    with torch.no_grad():
        parts = []
        if dtype == torch.bfloat16:
            for w in weights:
                f, cin = w.shape[:2]
                nch = -(-cin // 16)
                wp = F.pad(w, (0, 0, 0, 0, 0, 16 * nch - cin))
                # (co, c, k, dy, dx) -> (c, dy, n = dx*f + co, k) -> (c, dy, nb, kb, r, e)
                wn = wp.reshape(f, nch, 16, 3, 3).permute(1, 3, 4, 0, 2).reshape(nch, 3, 3 * f, 16)
                w6 = wn.reshape(nch, 3, 3 * f // 8, 8, 2, 8).permute(0, 1, 2, 4, 3, 5)
                parts.append(w6.to(torch.bfloat16).contiguous().reshape(-1).view(torch.int32))
            parts += [b.reshape(-1).to(torch.bfloat16).to(torch.float32).view(torch.int32)
                      for b in biases]
            return torch.cat(parts).contiguous()
        for w in weights:
            f, cin = w.shape[:2]
            nt = f // 8
            # (nt, gq, chunk, half, tq, dy, dx) -> (chunk, dy, dx, nt, gq, tq, half)
            w7 = w.to(torch.float32).reshape(nt, 8, cin // 8, 2, 4, 3, 3)
            w7 = w7.permute(2, 5, 6, 0, 1, 4, 3)
            hi, lo = tf32_split(w7)
            parts.append(torch.stack([hi, lo], dim=-2).reshape(-1))
        parts += [b.reshape(-1).to(torch.float32) for b in biases]
        return torch.cat(parts).contiguous()


def drb_forward_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor],
                          sum_dtype: torch.dtype = torch.float32,
                          slope: float = SLOPE) -> torch.Tensor:
    """Plain PyTorch DRB forward on (B, F, H, W) in x's dtype: per stage,
    nine shifted (outputs, inputs) x (inputs, pixels) products over the
    zero-padded concat (summed in fp32 for bf16 x, in x's dtype otherwise),
    LeakyReLU of ``slope`` on stages 1-4 — the kernel's function, not a call
    to a convolution library. The stage widths are the weights' (any growth).

    bf16: x and the parameters rounded to bf16 and upcast (exact), the same
    fp32 sums, and ``.to(torch.bfloat16)`` at the kernel's three rounding
    points: each stage's output (bias included), its LeakyReLU (taken in
    fp32 of the rounded value), and the block output out_5 * 0.2 + x (taken
    in fp32 of the rounded out_5 and x). ``sum_dtype=torch.float64`` sums
    in float64 instead: the yardstick the kernel's and the twin's summation
    errors are measured against."""
    bf16 = x.dtype == torch.bfloat16

    def rnd(t):
        return t.to(torch.bfloat16).to(sum_dtype) if bf16 else t

    b, _, h, w = x.shape
    xf = x.to(sum_dtype) if bf16 else x
    weights, biases = [rnd(t) for t in weights], [rnd(t) for t in biases]
    acts = xf
    for s in range(5):
        padded = F.pad(acts, (1, 1, 1, 1))
        cout = weights[s].shape[0]
        acc = biases[s].reshape(1, cout, 1, 1).expand(b, cout, h, w)
        for t in range(9):
            dy, dx = divmod(t, 3)
            window = padded[:, :, dy:dy + h, dx:dx + w]
            acc = acc + torch.einsum("oc,bchw->bohw", weights[s][:, :, dy, dx], window)
        if s < 4:
            acts = torch.cat([acts, rnd(F.leaky_relu(rnd(acc), slope))], dim=1)
        else:
            return (rnd(acc) * RES_SCALE + xf).to(x.dtype)


def cudnn_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor], slope: float = SLOPE) -> torch.Tensor:
    """The same DRB as five convolutions and concats in x's dtype
    (``F.conv2d`` with the parameters cast to it: cuDNN on the card; in
    bf16 the residual is taken in fp32 and rounded once, as the kernel's). :func:`drb_backward` differentiates
    it, and ``tools/time_kernels.py`` times it as the library yardstick: no
    single PyTorch call computes a DRB."""
    dt = x.dtype
    acts = x
    for s in range(5):
        y = F.conv2d(acts, weights[s].to(dt), biases[s].to(dt), padding=1)
        if s < 4:
            acts = torch.cat([acts, F.leaky_relu(y, slope)], 1)
    if dt == torch.bfloat16:
        return (y.float() * RES_SCALE + x.float()).to(dt)
    return y * RES_SCALE + x


def drb_backward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor], grad_out: torch.Tensor,
                 needs: Sequence[bool] | None = None, slope: float = SLOPE) -> list:
    """Gradients of a DRB's output, weighted by ``grad_out``, with respect
    to x, the five weights and the five biases (in that order; ``None``
    where ``needs`` says no): the block is recomputed from x with
    :func:`cudnn_chain` and differentiated by autograd. Counted in
    ``drb_backward.recomputes``; ``drb_backward.launches`` counts the calls
    of :func:`drb_backward_kernel` and :func:`drb_backward_kernel_wide`,
    ``drb_backward.launches_wide`` those of the second. All are
    process-wide and never reset, as ``drb_forward.launches``."""
    inputs = [x, *weights, *biases]
    needs = [True] * len(inputs) if needs is None else list(needs)
    with _count_lock:
        drb_backward.recomputes += 1
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = cudnn_chain(leaves[0], leaves[1:6], leaves[6:], slope)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if n else None for n in needs]


drb_backward.launches = 0
drb_backward.launches_wide = 0
drb_backward.recomputes = 0


def drb_backward_reference(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           biases: Sequence[torch.Tensor], grad_out: torch.Tensor,
                           slope: float = SLOPE, sides: Sequence[torch.Tensor] | None = None
                           ) -> list:
    """Plain PyTorch twin of :func:`drb_backward_kernel`'s arithmetic, in
    x's dtype: [dx, dW_1 .. dW_5, db_1 .. db_5] of sum(grad_out * DRB(x)).

    The stage activations c_1 .. c_4 are recomputed as
    :func:`drb_forward_reference` computes them. Then, from dy_5 = 0.2
    grad_out, stage by stage from 5 to 1: the stage's output gradient is its
    activation's, masked by LeakyReLU's slope where c_s is not above zero
    (``sides[s - 1]``, a boolean tensor of c_s's shape, replaces c_s > 0
    where given); its weight gradient is, per tap, the product of dy_s with
    the shifted concat summed over samples and pixels; its bias gradient
    dy_s summed likewise; and the concat's gradient gains, per tap, W_s's
    transpose times dy_s shifted the other way. dx is grad_out plus the
    concat's gradient at x. Any growth (the stage widths are the
    weights')."""
    b, f, h, w = x.shape
    acts = x
    for s in range(4):
        padded = F.pad(acts, (1, 1, 1, 1))
        y = biases[s].reshape(1, -1, 1, 1).expand(b, -1, h, w)
        for t in range(9):
            ky, kx = divmod(t, 3)
            y = y + torch.einsum("oc,bchw->bohw", weights[s][:, :, ky, kx],
                                 padded[:, :, ky:ky + h, kx:kx + w])
        acts = torch.cat([acts, F.leaky_relu(y, slope)], dim=1)
    starts = [wt.shape[1] for wt in weights]  # stage s + 1's output is concat channels starts[s]..
    dcat = torch.zeros_like(acts)
    dy = grad_out * RES_SCALE
    dws, dbs = [None] * 5, [None] * 5
    for s in range(4, -1, -1):
        cin = weights[s].shape[1]
        if s < 4:
            dc = dcat[:, starts[s]:starts[s + 1]]
            up = acts[:, starts[s]:starts[s + 1]] > 0 if sides is None else sides[s]
            dy = torch.where(up, dc, dc * slope)
        padded = F.pad(acts[:, :cin], (1, 1, 1, 1))
        dpad = F.pad(dy, (1, 1, 1, 1))
        dw = torch.empty_like(weights[s])
        for t in range(9):
            ky, kx = divmod(t, 3)
            dw[:, :, ky, kx] = torch.einsum("bohw,bchw->oc", dy,
                                            padded[:, :, ky:ky + h, kx:kx + w])
            dcat[:, :cin] += torch.einsum("oc,bohw->bchw", weights[s][:, :, ky, kx],
                                          dpad[:, :, 2 - ky:2 - ky + h, 2 - kx:2 - kx + w])
        dws[s], dbs[s] = dw, dy.sum(dim=(0, 2, 3))
    return [grad_out + dcat[:, :f], *dws, *dbs]


def backward_on_kernel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor], slope: float = SLOPE) -> bool:
    """Whether :class:`DRBFunction` differentiates this block with
    :func:`drb_backward_kernel` (True) or the cuDNN recompute: a CUDA fp32
    (B, F, 16, 16) input, F in :data:`SUPPORTED_FILTERS`, growth F, slope
    :data:`SLOPE` and fp32 parameters. Read off the input alone."""
    return (x.device.type == "cuda" and x.dtype == torch.float32 and x.dim() == 4
            and tuple(x.shape[2:]) == (BACKWARD_SIDE, BACKWARD_SIDE)
            and x.shape[1] in SUPPORTED_FILTERS and weights[0].shape[0] == x.shape[1]
            and slope == SLOPE
            and all(t.dtype == torch.float32 for t in (*weights, *biases)))


def drb_backward_kernel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor], grad_out: torch.Tensor,
                        needs: Sequence[bool] | None = None,
                        acts: torch.Tensor | None = None) -> list:
    """:func:`drb_backward` for DoWnGAN's block in fp32 at 16x16 on the
    card, by ``drb_backward_kernel`` (the block recomputed and walked back
    in one launch a block, 3xTF32) and ``drb_grad_reduce`` (the weight and
    bias gradients summed over samples in sample order): two identical
    calls agree bit for bit. Returns [dx, dW_1 .. dW_5, db_1 .. db_5],
    ``None`` where ``needs`` says no; the parameter gradients are views of
    one buffer, computed when any of them is wanted. ``acts``, a contiguous
    fp32 (B, 4F, 16, 16) tensor, receives the recomputed c_1 .. c_4 (for
    tests). Counted in ``drb_backward.launches``."""
    params = [*weights, *biases]
    needs = [True] * 11 if needs is None else list(needs)
    if not backward_on_kernel(x, weights, biases):
        raise ValueError(
            f"the DRB backward kernel takes CUDA float32 (B, F, {BACKWARD_SIDE}, "
            f"{BACKWARD_SIDE}) with F in {SUPPORTED_FILTERS}, growth F and float32 parameters, "
            f"got {tuple(x.shape)} {x.dtype}")
    b, f, h, w = x.shape
    x, grad_out = x.contiguous(), grad_out.contiguous()
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype or grad_out.device != x.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} {grad_out.dtype} on "
                         f"{grad_out.device} does not match x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    for s, (wt, bt) in enumerate(zip(weights, biases), start=1):
        if (tuple(wt.shape) != (f, s * f, 3, 3) or tuple(bt.shape) != (f,)
                or wt.device != x.device or bt.device != x.device
                or not wt.is_contiguous() or not bt.is_contiguous()):
            raise ValueError(f"stage {s}: weight {tuple(wt.shape)}, bias {tuple(bt.shape)} are "
                             f"not a contiguous ({f}, {s * f}, 3, 3) and ({f},) on {x.device}")
    if acts is not None and (acts.shape != (b, 4 * f, h, w) or acts.dtype != torch.float32
                             or acts.device != x.device or not acts.is_contiguous()):
        raise ValueError(f"acts must be a contiguous float32 ({b}, {4 * f}, {h}, {w}) tensor")
    size = 135 * f * f + 5 * f  # a sample's weight and bias partials
    dx = torch.empty_like(x) if needs[0] else None
    if any(needs[1:]):
        partial = torch.empty(b * size, device=x.device, dtype=torch.float32)
        flat = torch.empty(size, device=x.device, dtype=torch.float32)
    else:
        partial = flat = None
    lib = load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.drb_backward_f32(x.data_ptr(), grad_out.data_ptr(),
                                   (ctypes.c_void_p * 10)(*(t.data_ptr() for t in params)),
                                   ptr(dx), ptr(partial), ptr(flat), ptr(acts), b, f, h, w, stream)
    if err:
        raise RuntimeError(f"DRB backward kernel launch failed: "
                           f"{lib.drb_error_string(err).decode()} (input {tuple(x.shape)})")
    with _count_lock:
        drb_backward.launches += 1
    grads = [dx]
    off = 0
    for s in range(1, 6):
        n = 9 * f * s * f
        grads.append(None if flat is None else flat[off:off + n].view(f, s * f, 3, 3))
        off += n
    for _ in range(5):
        grads.append(None if flat is None else flat[off:off + f])
        off += f
    return [g if n else None for g, n in zip(grads, needs)]


def _wide_backward_block(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], slope: float) -> bool:
    """Whether this is the wide backward kernel's block, whatever its
    device: fp32 (B, 64, 16, 16) x, growth 32, slope 0.2 and fp32
    parameters (:data:`WIDE_BLOCK`)."""
    f, growth, wide_slope = WIDE_BLOCK
    return (x.dtype == torch.float32 and x.dim() == 4
            and tuple(x.shape[1:]) == (f, WIDE_SIDE, WIDE_SIDE)
            and weights[0].shape[0] == growth and slope == wide_slope
            and all(t.dtype == torch.float32 for t in (*weights, *biases)))


def backward_on_wide_kernel(x: torch.Tensor, weights: Sequence[torch.Tensor],
                            biases: Sequence[torch.Tensor], slope: float) -> bool:
    """Whether :class:`DRBFunction` differentiates this block with
    :func:`drb_backward_kernel_wide` (True): ESRGAN's block (64 filters,
    growth 32, slope 0.2) on a CUDA fp32 (B, 64, 16, 16) input with fp32
    parameters. Read off the input alone; no logic shared with
    :func:`backward_on_kernel`."""
    return x.device.type == "cuda" and _wide_backward_block(x, weights, biases, slope)


#: Floats of a CTA's weight and bias partials in the wide backward: the
#: five stages' (cin x cout x 9) and the 4 x 32 + 64 biases.
WIDE_PARTIAL = sum(9 * cin * cout + cout for cin, cout in stage_widths(64, 32))
#: Most two-CTA clusters a wide backward launch runs (``drb.cu``'s
#: ``kWbClusters``): cluster c takes samples c, c + 64, .., and each CTA
#: keeps one slot of partials.
WIDE_CLUSTERS = 64


def drb_backward_kernel_wide(x: torch.Tensor, weights: Sequence[torch.Tensor],
                             biases: Sequence[torch.Tensor], grad_out: torch.Tensor,
                             packed: torch.Tensor | None = None,
                             needs: Sequence[bool] | None = None,
                             acts: torch.Tensor | None = None) -> list:
    """:func:`drb_backward` for ESRGAN's block in fp32 at 16x16 on the
    card, by ``drb_backward_kernel_wide`` (the block recomputed from
    ``packed``, the forward's :func:`pack_drb_weights` of these parameters,
    packed here when omitted, and walked back in one launch a block, two
    CTAs a sample, 3xTF32; ``drb_dgrad_frags_wide`` transposes ``packed``
    for it first) and ``drb_grad_reduce_wide`` (the weight and bias
    gradients summed over the CTAs' slots in order): two identical calls
    agree bit for bit. Returns [dx, dW_1 .. dW_5, db_1 .. db_5], ``None`` where
    ``needs`` says no; the parameter gradients are views of one buffer,
    computed when any of them is wanted, from 2 min(B, 64) slots of
    partials (122.8 MB at B >= 64). ``acts``, a contiguous fp32 (B, 128,
    16, 16) tensor, receives the recomputed c_1 .. c_4 (for tests).
    Counted in ``drb_backward.launches`` and ``.launches_wide``."""
    f, growth, slope = WIDE_BLOCK
    needs = [True] * 11 if needs is None else list(needs)
    if not backward_on_wide_kernel(x, weights, biases, slope):
        raise ValueError(
            f"the wide DRB backward kernel takes CUDA float32 (B, {f}, {WIDE_SIDE}, "
            f"{WIDE_SIDE}) with growth {growth}, slope {slope} and float32 parameters, got "
            f"{tuple(x.shape)} {x.dtype}")
    b = x.shape[0]
    x, grad_out = x.contiguous(), grad_out.contiguous()
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype or grad_out.device != x.device:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} {grad_out.dtype} on "
                         f"{grad_out.device} does not match x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    for s, ((cin, cout), wt, bt) in enumerate(zip(stage_widths(f, growth), weights, biases),
                                              start=1):
        if (tuple(wt.shape) != (cout, cin, 3, 3) or tuple(bt.shape) != (cout,)
                or wt.device != x.device or bt.device != x.device):
            raise ValueError(f"stage {s}: weight {tuple(wt.shape)}, bias {tuple(bt.shape)} are "
                             f"not ({cout}, {cin}, 3, 3) and ({cout},) on {x.device}")
    if packed is None:
        packed = pack_drb_weights(weights, biases)
    if (packed.device != x.device or packed.dtype != torch.float32
            or packed.numel() != packed_size(f, growth=growth)
            or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError("packed weights do not match this block; repack with pack_drb_weights")
    if acts is not None and (acts.shape != (b, 4 * growth, WIDE_SIDE, WIDE_SIDE)
                             or acts.dtype != torch.float32 or acts.device != x.device
                             or not acts.is_contiguous()):
        raise ValueError(f"acts must be a contiguous float32 ({b}, {4 * growth}, {WIDE_SIDE}, "
                         f"{WIDE_SIDE}) tensor")
    dx = torch.empty_like(x) if needs[0] else None
    tfrag = torch.empty(packed.numel() - sum(bt.numel() for bt in biases), device=x.device,
                        dtype=torch.float32)  # the dgrad's transposed fragments
    if any(needs[1:]):
        slots = 2 * min(b, WIDE_CLUSTERS)
        partial = torch.empty(slots * WIDE_PARTIAL, device=x.device, dtype=torch.float32)
        flat = torch.empty(WIDE_PARTIAL, device=x.device, dtype=torch.float32)
    else:
        partial = flat = None
    lib = load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.drb_backward_f32_wide(x.data_ptr(), grad_out.data_ptr(), packed.data_ptr(),
                                        tfrag.data_ptr(), ptr(dx), ptr(partial), ptr(flat),
                                        ptr(acts), b, f, growth, WIDE_SIDE, WIDE_SIDE, stream)
    if err:
        raise RuntimeError(f"wide DRB backward kernel launch failed: "
                           f"{lib.drb_error_string(err).decode()} (input {tuple(x.shape)})")
    with _count_lock:
        drb_backward.launches += 1
        drb_backward.launches_wide += 1
    grads, off = [dx], 0
    widths = stage_widths(f, growth)
    for cin, cout in widths:
        grads.append(None if flat is None else flat[off:off + 9 * cin * cout].view(cout, cin, 3, 3))
        off += 9 * cin * cout
    for _, cout in widths:
        grads.append(None if flat is None else flat[off:off + cout])
        off += cout
    return [g if n else None for g, n in zip(grads, needs)]


def _needs_grad(x, weights, biases) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in (*weights, *biases)))


def drb(x: torch.Tensor, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
        packed: torch.Tensor, slope: float = SLOPE) -> torch.Tensor:
    """A DRB on (B, F, H, W) wherever it runs: :class:`DRBFunction` when
    autograd needs a gradient through a CUDA tensor, :func:`drb_forward`
    otherwise (the kernel, or the plain twin on a CPU tensor, where autograd
    differentiates the twin itself)."""
    if x.device.type == "cuda" and _needs_grad(x, weights, biases):
        return DRBFunction.apply(x, packed, *weights, *biases, slope)
    return drb_forward(x, weights, biases, packed, slope)


class DRBFunction(torch.autograd.Function):
    """The DRB under autograd on the card: ``apply(x, packed, w1..w5,
    b1..b5, slope)``, in x's dtype (``packed`` for it); any other count of
    arguments raises. The forward launches the kernel (counted in
    ``drb_forward.launches``) and saves only x, ``packed`` and the ten
    parameters. The backward is :func:`drb_backward_kernel` where
    :func:`backward_on_kernel` says so (fp32, DoWnGAN's block, 16x16),
    :func:`drb_backward_kernel_wide` where :func:`backward_on_wide_kernel`
    does (fp32, ESRGAN's block, 16x16; it recomputes from ``packed``), and
    otherwise :func:`drb_backward`, a cuDNN recompute in the same dtype:
    with bf16 x and fp32 parameters it gives a bf16 gradient of x and fp32
    gradients of the parameters, as autograd through their casts would.
    First order only: the gradient penalty differentiates the critic alone
    and the critic's fake is made without a graph, so no double backward
    of the DRB is ever taken, and one raises."""

    @staticmethod
    def forward(ctx, x, packed, *params):
        if len(params) != 11:
            raise TypeError(f"DRBFunction takes w1..w5, b1..b5 and the slope after x and "
                            f"packed: got {len(params)} arguments after them")
        *params, ctx.slope = params
        ctx.save_for_backward(x, packed, *params)
        return drb_forward(x, params[:5], params[5:], packed, ctx.slope)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        with annotate("drb.backward"):  # on autograd's device thread
            x, packed, *params = ctx.saved_tensors
            needs = [ctx.needs_input_grad[0], *ctx.needs_input_grad[2:12]]
            if backward_on_kernel(x, params[:5], params[5:], ctx.slope):
                grads = drb_backward_kernel(x, params[:5], params[5:], grad_out, needs)
            elif backward_on_wide_kernel(x, params[:5], params[5:], ctx.slope):
                grads = drb_backward_kernel_wide(x, params[:5], params[5:], grad_out, packed,
                                                 needs)
            else:
                grads = drb_backward(x, params[:5], params[5:], grad_out, needs, ctx.slope)
        return (grads[0], None, *grads[1:], None)


def _wide_block(x: torch.Tensor, weights: Sequence[torch.Tensor], slope: float) -> bool:
    """Whether ``drb_kernel_wide`` (True) or ``drb_kernel``/``drb_kernel_bf16``
    (False) computes this block; raises for a block no kernel takes."""
    b, f, h, w = x.shape
    growth = weights[0].shape[0]
    if growth == f and slope == SLOPE and f in SUPPORTED_FILTERS:
        return False
    if (f, growth, slope) == WIDE_BLOCK:
        if x.dtype != torch.float32 or (h, w) != (WIDE_SIDE, WIDE_SIDE):
            raise ValueError(
                f"the wide DRB kernel takes float32 (B, {f}, {WIDE_SIDE}, {WIDE_SIDE}), got "
                f"{tuple(x.shape)} {x.dtype}")
        return True
    raise ValueError(
        f"the DRB kernel takes F in {SUPPORTED_FILTERS} with growth F and slope {SLOPE}, "
        f"or (F, growth, slope) = {WIDE_BLOCK} in float32 at {WIDE_SIDE}x{WIDE_SIDE}; "
        f"got F={f}, growth {growth}, slope {slope}")


def drb_forward(x: torch.Tensor, weights: Sequence[torch.Tensor],
                biases: Sequence[torch.Tensor],
                packed: torch.Tensor | None = None, slope: float = SLOPE) -> torch.Tensor:
    """DRB forward on (B, F, H, W) fp32 or bf16, computed in x's dtype.

    CPU tensor: the plain twin. CUDA tensor: the ``drb.cu`` kernel of x's
    dtype and block (:func:`_wide_block`), with ``packed`` from
    :func:`pack_drb_weights` for that dtype (packed here when omitted);
    ``drb_forward.launches`` counts its launches of any kernel,
    ``drb_forward.launches_bf16`` those of the bf16 one and
    ``drb_forward.launches_wide`` those of the wide one. A call that
    autograd would have to differentiate raises: the route to a gradient
    on the card is :class:`DRBFunction`.
    """
    if x.device.type == "cpu":
        return drb_forward_reference(x, weights, biases, slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"drb_forward runs on cpu or cuda tensors, not {x.device}")
    if _needs_grad(x, weights, biases):
        raise RuntimeError(
            "drb_forward is forward only: call it under torch.inference_mode() or "
            "torch.no_grad(), or take gradients through DRBFunction")
    if x.dim() != 4 or x.dtype not in KERNEL_DTYPES or not x.is_contiguous():
        raise ValueError(
            f"drb_forward takes contiguous (B, F, H, W) float32 or bfloat16, got "
            f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
    b, f, h, w = x.shape
    wide = _wide_block(x, weights, slope)
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if packed is None:
        packed = pack_drb_weights(weights, biases, x.dtype)
    growth = weights[0].shape[0]
    if (packed.device != x.device or packed.dtype != (torch.int32 if bf16 else torch.float32)
            or packed.numel() != packed_size(f, x.dtype, growth)
            or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError("packed weights do not match this input; "
                         "repack with pack_drb_weights for its dtype")
    lib = load_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wide:
            err = lib.drb_forward_f32_wide(x.data_ptr(), packed.data_ptr(), out.data_ptr(),
                                           b, f, growth, h, w, stream)
        else:
            kernel = lib.drb_forward_bf16 if bf16 else lib.drb_forward_f32
            err = kernel(x.data_ptr(), packed.data_ptr(), out.data_ptr(), b, f, h, w, stream)
    if err:
        raise RuntimeError(
            f"DRB kernel launch failed: {lib.drb_error_string(err).decode()} "
            f"(input {tuple(x.shape)} {x.dtype})")
    with _count_lock:
        drb_forward.launches += 1
        drb_forward.launches_bf16 += bf16
        drb_forward.launches_wide += wide
    return out


drb_forward.launches = 0
drb_forward.launches_bf16 = 0
drb_forward.launches_wide = 0
