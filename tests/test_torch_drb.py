"""The port's DenseResidualBlock: its plain twin against the JAX package's
DRB (the XLA reference formulation, the Pallas kernel in interpret mode, and
the flax module) on the same weights and inputs; its weight packing; its
gradients (``DRBFunction``'s recompute backward, the backward kernel's
plain twin against autograd, the packed-weight cache after an Adam step);
and, on a CUDA card only, the CUDA kernels (forward and backward) and
``DRBFunction`` against the twin.

The JAX side is imported inside a fixture, so the CUDA legs also run where
JAX is absent: ``python -m pytest tests/test_torch_drb.py -m cuda --noconftest``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from downgan_tpu_torch.config.config import Config  # noqa: E402
from downgan_tpu_torch.models.generator import DenseResidualBlock  # noqa: E402
from downgan_tpu_torch.ops.cuda.drb import (  # noqa: E402
    SLOPE,
    RES_SCALE,
    DRBFunction,
    WIDE_BLOCK,
    backward_on_kernel,
    backward_on_wide_kernel,
    cudnn_chain,
    drb_backward,
    drb_backward_kernel,
    drb_backward_reference,
    drb_forward,
    drb_forward_reference,
    pack_drb_weights,
    packed_size,
    stage_widths,
    tf32_split,
)
from downgan_tpu_torch.training.state import make_optimizer  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

ATOL = 1e-5  # fp32 on both sides; sums of at most 720 products in another order
CASES = [(f, b, h, w) for f in (8, 16) for b in (1, 3, 4) for (h, w) in ((16, 16), (12, 20))]
# Interpret-mode Pallas compiles each shape for seconds: every F, B and
# spatial size once, rather than every combination.
INTERPRET_CASES = [(f, b, h, w) for f in (8, 16) for b, (h, w) in
                   ((1, (16, 16)), (3, (12, 20)), (4, (16, 16)))]


def case_id(case):
    return "F{}-B{}-{}x{}".format(*case)


@pytest.fixture(scope="module")
def jax_drb():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from downgan_tpu.models.generator import DenseResidualBlock
    from downgan_tpu.ops.pallas import drb as pallas_drb
    from downgan_tpu_torch.utils.port_weights import conv_from_flax

    def make(f, b, h, w, seed=0):
        """Input and flax DRB params (torch-default init bounds) from numpy,
        and the same weights carried into the port's OIHW layout."""
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((b, h, w, f)).astype(np.float32)
        tree, ws, bs = {}, [], []
        for k in range(1, 6):
            bound = 1.0 / np.sqrt(9 * k * f)
            leaf = {"kernel": rng.uniform(-bound, bound, (3, 3, k * f, f)).astype(np.float32),
                    "bias": rng.uniform(-bound, bound, (f,)).astype(np.float32)}
            tree[f"b{k}"] = {"Conv_0": leaf}
            sd = conv_from_flax(leaf, "c")
            ws.append(sd["c.weight"])
            bs.append(sd["c.bias"])
        return x, {"params": tree}, ws, bs

    def to_cs(x_nhwc):
        return jnp.asarray(x_nhwc).transpose(3, 0, 1, 2).reshape(x_nhwc.shape[-1], -1)

    return types.SimpleNamespace(
        jnp=jnp, pallas=pallas_drb, make=make, to_cs=to_cs,
        apply=jax.jit(lambda params, x: DenseResidualBlock(x.shape[-1]).apply(params, x)),
        reference=jax.jit(pallas_drb.drb_forward_reference, static_argnums=(3, 4, 5)))


def port_twin(x_nhwc, ws, bs):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()
    return drb_forward_reference(x, ws, bs).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_twin_matches_flax_block(jax_drb, case):
    f, b, h, w = case
    x, params, ws, bs = jax_drb.make(f, b, h, w)
    want = np.asarray(jax_drb.apply(params, jax_drb.jnp.asarray(x)))
    np.testing.assert_allclose(port_twin(x, ws, bs), want, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_twin_matches_jax_reference_formulation(jax_drb, case):
    f, b, h, w = case
    x, params, ws, bs = jax_drb.make(f, b, h, w, seed=1)
    jws, jbs = jax_drb.pallas.pack_drb_weights(params["params"], f)
    cs = jax_drb.reference(jax_drb.to_cs(x), jws, jbs, f, h, w)
    want = np.asarray(jax_drb.pallas.cs_to_nhwc(cs, b, h, w))
    np.testing.assert_allclose(port_twin(x, ws, bs), want, atol=ATOL)


@pytest.mark.parametrize("case", INTERPRET_CASES, ids=case_id)
def test_twin_matches_pallas_kernel_interpret(jax_drb, case):
    f, b, h, w = case
    x, params, ws, bs = jax_drb.make(f, b, h, w, seed=2)
    jws, jbs = jax_drb.pallas.pack_drb_weights(params["params"], f)
    cs = jax_drb.pallas.drb_forward(jax_drb.to_cs(x), jws, jbs, f, h, w, interpret=True)
    want = np.asarray(jax_drb.pallas.cs_to_nhwc(cs, b, h, w))
    np.testing.assert_allclose(port_twin(x, ws, bs), want, atol=ATOL)


def random_block(f, seed=0):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.rand(f, s * f, 3, 3, generator=g) - 0.5 for s in range(1, 6)]
    bs = [torch.rand(f, generator=g) - 0.5 for _ in range(5)]
    return ws, bs


def test_wrapper_on_cpu_is_the_twin_and_launches_nothing():
    ws, bs = random_block(8)
    x = torch.randn(2, 8, 6, 10, generator=torch.Generator().manual_seed(3))
    before = drb_forward.launches
    torch.testing.assert_close(drb_forward(x, ws, bs), drb_forward_reference(x, ws, bs),
                               rtol=0, atol=0)
    assert drb_forward.launches == before


def test_wrapper_refuses_other_devices():
    ws, bs = random_block(8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        drb_forward(torch.empty(1, 8, 4, 4, device="meta"), ws, bs)


def test_pack_layout():
    """Stage s holds its B fragments, hi then lo: w[co, ci, dy, dx] with
    ci = 8*chunk + 4*half + tq and co = 8*nt + gq lands at
    ((((chunk*9 + tap)*NT + nt)*32 + 4*gq + tq)*4 + 2*part + half); then the
    biases. hi is TF32-exact and hi + lo reproduces w to 2**-22 |w|."""
    for f in (8, 16):
        nt_count = f // 8
        ws, bs = random_block(f, seed=4)
        packed = pack_drb_weights(ws, bs)
        assert packed.dtype == torch.float32 and packed.numel() == packed_size(f)
        off = 0
        for s, wt in enumerate(ws, start=1):
            n = 2 * 9 * f * s * f
            stage = packed[off:off + n]
            idx = torch.empty(f, s * f, 3, 3, 2, dtype=torch.long)
            for co in range(f):
                nt, gq = divmod(co, 8)
                for ci in range(s * f):
                    chunk, rest = divmod(ci, 8)
                    half, tq = divmod(rest, 4)
                    for tap in range(9):
                        lane4 = (((chunk * 9 + tap) * nt_count + nt) * 32 + 4 * gq + tq) * 4
                        idx[co, ci, tap // 3, tap % 3, 0] = lane4 + half
                        idx[co, ci, tap // 3, tap % 3, 1] = lane4 + 2 + half
            assert sorted(idx.reshape(-1).tolist()) == list(range(n))  # a permutation
            hi, lo = stage[idx[..., 0]], stage[idx[..., 1]]
            assert not (hi.view(torch.int32) & 0x1FFF).any()
            assert not (lo.view(torch.int32) & 0x1FFF).any()
            err = (hi.double() + lo.double() - wt.double()).abs()
            assert (err <= 2.0 ** -22 * wt.double().abs()).all()
            off += n
        torch.testing.assert_close(packed[off:], torch.cat(bs), rtol=0, atol=0)


def tf32_trunc(t):
    """What the tensor core reads of an fp32 operand: its top 19 bits."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate_3xtf32(x, weights, biases, passes=3):
    """The kernel's arithmetic on the CPU: each stage's nine tap products
    with both operands split into TF32 parts (weights as packed: hi and lo
    rounded; activations: hi rounded, lo = a - hi truncated by the MMA),
    summing a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in fp32 (lo*lo dropped);
    passes=1 is plain TF32 (a_hi*b_hi alone)."""
    b, f, h, w = x.shape
    acts = x
    for s in range(5):
        padded = torch.nn.functional.pad(acts, (1, 1, 1, 1))
        a_hi = tf32_split(padded)[0]
        a_lo = tf32_trunc(padded - a_hi)
        w_hi, w_lo = tf32_split(weights[s])
        acc = biases[s].reshape(1, f, 1, 1).expand(b, f, h, w)
        for t in range(9):
            dy, dx = divmod(t, 3)
            ah = a_hi[:, :, dy:dy + h, dx:dx + w]
            al = a_lo[:, :, dy:dy + h, dx:dx + w]
            wh, wl = w_hi[:, :, dy, dx], w_lo[:, :, dy, dx]
            if passes == 3:
                acc = acc + torch.einsum("oc,bchw->bohw", wh, al)
                acc = acc + torch.einsum("oc,bchw->bohw", wl, ah)
            acc = acc + torch.einsum("oc,bchw->bohw", wh, ah)
        if s < 4:
            acts = torch.cat([acts, torch.nn.functional.leaky_relu(acc, SLOPE)], dim=1)
        else:
            return acc * RES_SCALE + x


def test_3xtf32_emulation_holds_the_kernel_tolerance():
    """At the florida DRB shape (F=16, 16x16, B=4) the 3xTF32 arithmetic
    stays within the kernel's 1e-5 of the fp32 twin; plain TF32 does not."""
    f = 16
    ws, bs = random_block(f, seed=6)
    ws = [t / (9 * t.shape[1]) ** 0.5 for t in ws]  # the generator's init scale
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, f, 16, 16)).astype(np.float32))
    want = drb_forward_reference(x, ws, bs)
    torch.testing.assert_close(emulate_3xtf32(x, ws, bs), want, atol=ATOL, rtol=ATOL)
    assert not torch.allclose(emulate_3xtf32(x, ws, bs, passes=1), want, atol=ATOL, rtol=ATOL)


def test_3xtf32_emulation_holds_at_f8_and_a_width_of_two_tiles():
    """The same at F=8 and a 12x20 image (two 16-wide tiles on the card)."""
    f = 8
    ws, bs = random_block(f, seed=8)
    ws = [t / (9 * t.shape[1]) ** 0.5 for t in ws]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, f, 12, 20)).astype(np.float32))
    torch.testing.assert_close(emulate_3xtf32(x, ws, bs), drb_forward_reference(x, ws, bs),
                               atol=ATOL, rtol=ATOL)


def test_tf32_round_ties_away_from_zero():
    """tf32_round is cvt.rna.tf32.f32: nearest TF32 value, ties away from
    zero; tf32_split's parts are TF32-exact and sum to t within 2**-22 |t|."""
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    t = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp,
                      3.0e-30, -7.5e20, 0.0])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0e-30, -7.5e20, 0.0])
    got = tf32_split(t)[0]
    assert not (got.view(torch.int32) & 0x1FFF).any()
    torch.testing.assert_close(got[:4], want[:4], rtol=0, atol=0)
    torch.testing.assert_close(got[4:], want[4:], rtol=2.0 ** -11, atol=0)
    u = torch.from_numpy(np.random.default_rng(10).standard_normal(4096).astype(np.float32)) * 1e3
    hi, lo = tf32_split(u)
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi.double() + lo.double() - u.double()).abs() <= 2.0 ** -22 * u.double().abs()).all()


def init_scale_block(f, seed, device="cpu", requires_grad=True):
    """Random DRB weights at the generator's init scale."""
    ws, bs = random_block(f, seed=seed)
    ws = [(t / (9 * t.shape[1]) ** 0.5).to(device).requires_grad_(requires_grad) for t in ws]
    bs = [t.to(device).requires_grad_(requires_grad) for t in bs]
    return ws, bs


def twin_grads(x, ws, bs, weight, slope=SLOPE):
    """Gradients of sum(weight * DRB(x)) by autograd through the twin."""
    leaves = [t.detach().requires_grad_() for t in (x, *ws, *bs)]
    out = drb_forward_reference(leaves[0], leaves[1:6], leaves[6:], slope=slope)
    return torch.autograd.grad((out * weight).sum(), leaves)


def test_module_gradients_on_cpu_are_autograd_through_the_twin():
    block = DenseResidualBlock(8)
    ws, bs = block.stage_params()
    rng = torch.Generator().manual_seed(11)
    x = torch.randn(2, 8, 12, 20, generator=rng, requires_grad=True)
    weight = torch.randn(2, 8, 12, 20, generator=rng)
    got = torch.autograd.grad((block(x) * weight).sum(), [x, *ws, *bs])
    for g, w in zip(got, twin_grads(x, ws, bs, weight)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("f", [8, 16])
def test_drb_function_recompute_backward_on_cpu_matches_the_twin(f):
    """DRBFunction on CPU tensors: the forward is the twin, the backward the
    F.conv2d recompute it runs on the card. Same gradients, fp32 sums in
    another order (1e-5, as the forward)."""
    ws, bs = init_scale_block(f, seed=12)
    rng = torch.Generator().manual_seed(13)
    x = torch.randn(3, f, 16, 16, generator=rng, requires_grad=True)
    weight = torch.randn(3, f, 16, 16, generator=rng)
    before = drb_forward.launches
    out = DRBFunction.apply(x, pack_drb_weights(ws, bs), *ws, *bs, SLOPE)
    torch.testing.assert_close(out, drb_forward_reference(x, ws, bs), rtol=0, atol=0)
    got = torch.autograd.grad((out * weight).sum(), [x, *ws, *bs])
    assert drb_forward.launches == before
    for g, w in zip(got, twin_grads(x, ws, bs, weight)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=ATOL)


def test_drb_backward_computes_only_what_is_needed():
    ws, bs = init_scale_block(8, seed=14, requires_grad=False)
    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(15))
    grads = drb_backward(x, ws, bs, torch.ones_like(x), needs=[False] + [True] * 5 + [False] * 5)
    assert grads[0] is None and all(g is None for g in grads[6:])
    want = twin_grads(x, ws, bs, torch.ones_like(x))
    for g, w in zip(grads[1:6], want[1:6]):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("f", [8, 16, 64])
def test_backward_twin_matches_autograd_through_the_twin_in_float64(f):
    """``drb_backward_reference`` (the backward kernels' arithmetic written
    out: recompute, mask, wgrad, bias sums, shifted-product dgrad) against
    autograd through ``drb_forward_reference``, both in float64. F = 8, 16:
    DoWnGAN's block (growth F, slope 0.01); F = 64: ESRGAN's (growth 32,
    slope 0.2), the wide backward kernel's."""
    if f == WIDE_BLOCK[0]:
        _, growth, slope = WIDE_BLOCK
        gen = torch.Generator().manual_seed(30 + f)
        ws = [(torch.rand(cout, cin, 3, 3, generator=gen) * 2 - 1) / (9 * cin) ** 0.5
              for cin, cout in stage_widths(f, growth)]
        bs = [(torch.rand(t.shape[0], generator=gen) * 2 - 1) / (9 * t.shape[1]) ** 0.5
              for t in ws]
    else:
        slope = SLOPE
        ws, bs = init_scale_block(f, seed=30 + f, requires_grad=False)
    ws, bs = [t.double() for t in ws], [t.double() for t in bs]
    rng = torch.Generator().manual_seed(31)
    x = torch.randn(3, f, 16, 16, generator=rng, dtype=torch.float64)
    weight = torch.randn(3, f, 16, 16, generator=rng, dtype=torch.float64)
    got = drb_backward_reference(x, ws, bs, weight, slope=slope)
    for g, w in zip(got, twin_grads(x, ws, bs, weight, slope)):
        assert g.shape == w.shape
        assert (g - w).abs().max() <= 1e-12 * w.abs().max()


def test_backward_twin_takes_the_given_sides():
    """``sides`` replaces c_s > 0 in the masks: the twin's own sides give
    its result bit for bit, and flipping one element's side changes only
    what that element's gradient reaches."""
    ws, bs = init_scale_block(8, seed=32, requires_grad=False)
    rng = torch.Generator().manual_seed(33)
    x = torch.randn(2, 8, 16, 16, generator=rng, dtype=torch.float64)
    weight = torch.randn(2, 8, 16, 16, generator=rng, dtype=torch.float64)
    ws, bs = [t.double() for t in ws], [t.double() for t in bs]
    acts = x
    sides = []
    for s in range(4):
        y = F.conv2d(acts, ws[s], bs[s], padding=1)
        sides.append(y > 0)
        acts = torch.cat([acts, F.leaky_relu(y, SLOPE)], 1)
    plain = drb_backward_reference(x, ws, bs, weight)
    for g, w in zip(drb_backward_reference(x, ws, bs, weight, sides=sides), plain):
        assert torch.equal(g, w)
    flipped = [t.clone() for t in sides]
    flipped[3][1, 5, 7, 9] = ~flipped[3][1, 5, 7, 9]
    got = drb_backward_reference(x, ws, bs, weight, sides=flipped)
    assert not torch.equal(got[4], plain[4]) and torch.equal(got[5], plain[5])
    assert torch.equal(got[10], plain[10])  # stage 5 lies above the flip


def test_drb_function_on_cpu_counts_a_recompute():
    """On CPU tensors ``DRBFunction``'s backward is the recompute: one
    ``drb_backward.recomputes``, no ``drb_backward.launches``."""
    ws, bs = init_scale_block(8, seed=34)
    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(35), requires_grad=True)
    before = (drb_backward.launches, drb_backward.recomputes)
    assert not backward_on_kernel(x, ws, bs)
    DRBFunction.apply(x, pack_drb_weights(ws, bs), *ws, *bs, SLOPE).square().sum().backward()
    assert (drb_backward.launches, drb_backward.recomputes) == (before[0], before[1] + 1)


def test_drb_function_refuses_a_double_backward():
    ws, bs = init_scale_block(8, seed=16)
    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(17), requires_grad=True)
    out = DRBFunction.apply(x, pack_drb_weights(ws, bs), *ws, *bs, SLOPE)
    (gx,) = torch.autograd.grad(out.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


@pytest.mark.parametrize("impl", [dict(foreach=False), dict(foreach=True), None],
                         ids=["single_tensor", "foreach", "make_optimizer"])
def test_packed_weights_refresh_after_adam_step(impl):
    """Adam updates in place. The single-tensor and foreach implementations
    bump the parameters' versions, so the next forward repacks the new
    weights; ``make_optimizer`` takes foreach and never the fused one,
    which writes without bumping them."""
    block = DenseResidualBlock(8)
    ws, bs = block.stage_params()
    old = block._packed_weights(ws, bs).clone()
    old_key = block._packed_key
    if impl is None:
        opt = make_optimizer(Config(), block)
        assert opt.defaults["foreach"] and not opt.defaults["fused"]
    else:
        opt = torch.optim.Adam(block.parameters(), lr=2.5e-4, betas=(0.9, 0.99), eps=1e-8,
                               **impl)
    x = torch.randn(2, 8, 16, 16, generator=torch.Generator().manual_seed(18))
    block(x).square().sum().backward()
    opt.step()
    new = block._packed_weights(ws, bs)
    assert block._packed_key != old_key
    assert not torch.equal(new, old)
    torch.testing.assert_close(new, pack_drb_weights(ws, bs), rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DRB kernel runs only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Whole-sample tiles (B=150 serving, B=128 training, B=64 a microbatch under
# grad_accum 2), then bands and images of several 16x16 tiles: halo'd on all
# four sides (56x112), ragged (37x53), the domain band (32x112), F=8; and the
# halo-extended bands that spatial sharding gives the kernel over florida's 16
# coarse rows: 13 rows over 2 shards, 9 and 13 over 4, at the serving batch
# and at the sharded step's 32 samples (16 a data replica on a 2 x 2 grid).
CUDA_CASES = [(1, 16, 16, 16), (3, 16, 16, 16), (150, 16, 16, 16), (128, 16, 16, 16),
              (64, 16, 16, 16), (8, 16, 32, 56), (3, 8, 16, 16), (2, 8, 12, 20),
              (1, 16, 5, 7), (2, 16, 56, 112), (1, 16, 37, 53), (8, 16, 32, 112),
              (1, 8, 40, 24), (150, 16, 13, 16), (150, 16, 9, 16), (32, 16, 13, 16),
              (16, 16, 13, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_CASES, ids=lambda s: "B{}-F{}-{}x{}".format(*s))
def test_cuda_kernel_matches_twin(cuda_device, shape):
    b, f, h, w = shape
    ws, bs = random_block(f, seed=b + h)
    ws = [t.to(cuda_device) / (9 * t.shape[1]) ** 0.5 for t in ws]
    bs = [t.to(cuda_device) for t in bs]
    x = torch.randn(b, f, h, w, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    before = drb_forward.launches
    with torch.inference_mode():
        got = drb_forward(x, ws, bs)
        want = drb_forward_reference(x, ws, bs)
    torch.cuda.synchronize()
    assert drb_forward.launches == before + 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(150, 16, 16, 16), (2, 16, 64, 40), (3, 8, 16, 24)],
                         ids=lambda s: "B{}-F{}-{}x{}".format(*s))
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_kernel_on_a_halo_band_cropped_is_the_whole_field(cuda_device, shape, shards):
    """The spatially sharded DRB (``parallel/spatial.py::sharded_drb``): the
    kernel over a shard's rows plus a 5-row halo, clipped at the domain's
    edges, then cropped back to the shard's rows, equals the kernel over
    the whole field bit for bit. Each pixel is summed from the same inputs
    in the same order wherever its tile starts, and the false edges of a
    band reach only rows that are cropped away. Florida's 16 rows over 4
    shards are bands of 9 and 13 rows, ragged in the kernel's 16x16 tiles."""
    from downgan_tpu_torch.parallel.spatial import DRB_HALO, band_rows

    b, f, h, w = shape
    ws, bs = init_scale_block(f, seed=h + shards, device=cuda_device, requires_grad=False)
    packed = pack_drb_weights(ws, bs)
    x = torch.randn(b, f, h, w, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    rows = h // shards
    before = drb_forward.launches
    with torch.inference_mode():
        whole = drb_forward(x, ws, bs, packed)
        for index in range(shards):
            lo, hi = band_rows(shards, index, rows, DRB_HALO)
            top = index * rows - lo
            got = drb_forward(x[:, :, lo:hi].contiguous(), ws, bs, packed)[:, :, top:top + rows]
            assert torch.equal(got, whole[:, :, index * rows:(index + 1) * rows]), (index, lo, hi)
    torch.cuda.synchronize()
    assert drb_forward.launches == before + 1 + shards


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    ws, bs = random_block(12)
    ws = [t.to(cuda_device) for t in ws]
    bs = [t.to(cuda_device) for t in bs]
    with torch.inference_mode(), pytest.raises(ValueError, match="F in"):
        drb_forward(torch.zeros(1, 12, 4, 4, device=cuda_device), ws, bs)
    ws, bs = random_block(8)
    ws = [t.to(cuda_device).requires_grad_() for t in ws]
    bs = [t.to(cuda_device) for t in bs]
    with pytest.raises(RuntimeError, match="forward only.*DRBFunction"):
        drb_forward(torch.zeros(1, 8, 4, 4, device=cuda_device), ws, bs)
    with torch.inference_mode(), pytest.raises(ValueError, match="contiguous"):
        drb_forward(torch.zeros(1, 4, 4, 8, device=cuda_device).permute(0, 3, 1, 2), ws, bs)


@pytest.mark.cuda
def test_cuda_drb_function_gradients_match_the_twin_at_b128(cuda_device):
    """Forward from the kernel, backward from the backward kernel (fp32,
    16x16), against autograd through the twin. The backward never reads the
    kernel's output; weight gradients sum 32,768 pixel terms, about
    sqrt(32768/720) ~ 7x the forward's longest sum, so 1e-4 of each
    gradient's largest entry."""
    ws, bs = init_scale_block(16, seed=19, device=cuda_device)
    rng = torch.Generator().manual_seed(20)
    x = torch.randn(128, 16, 16, 16, generator=rng).to(cuda_device).requires_grad_()
    weight = torch.randn(128, 16, 16, 16, generator=rng).to(cuda_device)
    before = drb_forward.launches
    out = DRBFunction.apply(x, pack_drb_weights(ws, bs), *ws, *bs, SLOPE)
    got = torch.autograd.grad((out * weight).sum(), [x, *ws, *bs])
    torch.cuda.synchronize()
    assert drb_forward.launches == before + 1
    for g, w in zip(got, twin_grads(x, ws, bs, weight)):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def kernel_backward_case(f, b, seed, device):
    """A block at the generator's init scale, x and an output weighting."""
    ws, bs = init_scale_block(f, seed=seed, device=device, requires_grad=False)
    rng = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(b, f, 16, 16, generator=rng).to(device)
    weight = torch.randn(b, f, 16, 16, generator=rng).to(device)
    return x, ws, bs, weight


def stage_preactivations(x, ws, bs):
    """y_1 .. y_4 of the block, by convolutions in x's dtype."""
    acts, ys = x, []
    for s in range(4):
        ys.append(F.conv2d(acts, ws[s], bs[s], padding=1))
        acts = torch.cat([acts, F.leaky_relu(ys[-1], SLOPE)], 1)
    return ys


# The backward kernel against float64: the plain twin of its arithmetic in
# float64, masked on the kernel's own LeakyReLU sides (its recomputed c_s,
# bit for bit the forward kernel's). A pre-activation within fp32 rounding
# of zero may lie on the other side in float64 (2 of 2.1 M at B=128, F=16 on
# the card); there the float64 twin differentiates another piecewise-linear
# function, off by up to ~5e-3 of a weight gradient's largest entry. Each
# such element must be within 1e-5 of zero; where there is none, the
# kernel is held to float64 autograd through the twin directly. 1e-4 of each
# gradient's largest entry, as test_cuda_drb_function_gradients_match_the_twin_at_b128.
BACKWARD_KERNEL_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 16])
@pytest.mark.parametrize("b", [1, 3, 128])
def test_cuda_backward_kernel_matches_float64(cuda_device, f, b):
    x, ws, bs, weight = kernel_backward_case(f, b, seed=40 + f + b, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    before = (drb_backward.launches, drb_backward.recomputes)
    out = DRBFunction.apply(leaves[0], pack_drb_weights(ws, bs), *leaves[1:], SLOPE)
    got = torch.autograd.grad((out * weight).sum(), leaves)
    torch.cuda.synchronize()
    assert (drb_backward.launches, drb_backward.recomputes) == (before[0] + 1, before[1])
    acts = torch.empty(b, 4 * f, 16, 16, device=cuda_device)
    direct = drb_backward_kernel(x, ws, bs, weight, acts=acts)
    assert all(torch.equal(g, d) for g, d in zip(got, direct))
    x64, ws64, bs64 = x.double(), [t.double() for t in ws], [t.double() for t in bs]
    ys = stage_preactivations(x64, ws64, bs64)
    c64 = torch.cat([F.leaky_relu(y, SLOPE) for y in ys], 1)
    torch.testing.assert_close(acts.double(), c64, atol=ATOL, rtol=ATOL)
    sides = [acts[:, s * f:(s + 1) * f] > 0 for s in range(4)]
    flipped = torch.cat([(side != (y > 0)) for side, y in zip(sides, ys)], 1)
    assert (torch.cat(ys, 1)[flipped].abs() <= 1e-5).all()
    want = drb_backward_reference(x64, ws64, bs64, weight.double(), sides=sides)
    if not flipped.any():
        for w, v in zip(want, twin_grads(x64, ws64, bs64, weight.double())):
            assert (w - v).abs().max() <= 1e-12 * v.abs().max()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g.double() - w).abs().max() <= BACKWARD_KERNEL_TOL * w.abs().max()


@pytest.mark.cuda
def test_cuda_backward_kernel_is_bit_for_bit_and_computes_only_what_is_needed(cuda_device):
    """Two identical calls agree bit for bit (the weight gradients are
    summed over samples in sample order, with no atomics); ``needs`` drops
    dx and the biases, and the rest equals the full call's."""
    x, ws, bs, weight = kernel_backward_case(16, 128, seed=50, device=cuda_device)
    first = drb_backward_kernel(x, ws, bs, weight)
    second = drb_backward_kernel(x, ws, bs, weight)
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    needs = [False] + [True] * 5 + [False] * 5
    part = drb_backward_kernel(x, ws, bs, weight, needs)
    assert part[0] is None and all(g is None for g in part[6:])
    assert all(torch.equal(p, q) for p, q in zip(part[1:6], first[1:6]))
    no_params = drb_backward_kernel(x, ws, bs, weight, [True] + [False] * 10)
    assert torch.equal(no_params[0], first[0]) and all(g is None for g in no_params[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fp32-16x16", "bf16", "wide", "fp32-12x20"])
def test_cuda_drb_function_backward_route_is_counted(cuda_device, route):
    """fp32 DoWnGAN blocks at 16x16 take the backward kernel, the fp32
    wide ESRGAN block at 16x16 the wide backward kernel; bf16 and other
    shapes the cuDNN recompute."""
    f, h, w, dtype, slope = 16, 16, 16, torch.float32, SLOPE
    if route == "wide":
        f, growth, slope = WIDE_BLOCK
        gen = torch.Generator().manual_seed(60)
        ws = [(torch.rand(growth if s < 4 else f, f + growth * s, 3, 3, generator=gen) - 0.5)
              / (9 * (f + growth * s)) ** 0.5 for s in range(5)]
        bs = [torch.zeros(t.shape[0]) for t in ws]
        ws, bs = [t.to(cuda_device) for t in ws], [t.to(cuda_device) for t in bs]
    else:
        ws, bs = init_scale_block(f, seed=61, device=cuda_device, requires_grad=False)
        if route == "bf16":
            dtype = torch.bfloat16
        elif route == "fp32-12x20":
            h, w = 12, 20
    x = torch.randn(4, f, h, w, generator=torch.Generator().manual_seed(62)).to(cuda_device, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    before = (drb_backward.launches, drb_backward.launches_wide, drb_backward.recomputes)
    out = DRBFunction.apply(leaves[0], pack_drb_weights(ws, bs, dtype), *leaves[1:], slope)
    torch.autograd.grad(out.float().square().sum(), leaves)
    torch.cuda.synchronize()
    wide = route == "wide"
    kernel = route == "fp32-16x16" or wide
    assert backward_on_kernel(x, ws, bs, slope) == (route == "fp32-16x16")
    assert backward_on_wide_kernel(x, ws, bs, slope) == wide
    assert (drb_backward.launches - before[0], drb_backward.launches_wide - before[1],
            drb_backward.recomputes - before[2]) == ((1, int(wide), 0) if kernel else (0, 0, 1))


@pytest.mark.cuda
def test_cuda_block_runs_new_weights_after_adam_step(cuda_device):
    """The trap of an in-place update: after Adam's step on the card the
    kernel path must run the new weights, as the twin does."""
    block = DenseResidualBlock(16).to(cuda_device)
    opt = torch.optim.Adam(block.parameters(), lr=2.5e-4, betas=(0.9, 0.99), eps=1e-8)
    x = torch.randn(4, 16, 16, 16, generator=torch.Generator().manual_seed(21)).to(cuda_device)
    before = drb_forward.launches
    block(x.requires_grad_()).square().sum().backward()
    opt.step()
    with torch.no_grad():
        got = block(x)
        want = drb_forward_reference(x, *block.stage_params())
    torch.cuda.synchronize()
    assert drb_forward.launches == before + 2
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------------------
# bf16


def bf16_ulp(magnitude):
    """The spacing of bf16 values at ``magnitude`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(magnitude)) - 7)


# The bf16 kernel against the bf16 twin (drb.cu's criterion): both are held
# to a float64 evaluation of the same function (same bf16 inputs, same three
# rounding points, sums in float64).
# The kernel's largest error against it may be at most 1.25x the twin's, or
# one bf16 ulp of the output's largest magnitude if that is larger: the twin
# can round every element as the float64 evaluation does, and an element
# whose fp32 sum lands next to a rounding boundary flips by its own ulp.
# Kernel and twin differ only by fp32 summation order: at most 2 bf16 ulps
# of the output's largest magnitude apart (one flip, carried into a later
# stage's rounding at most once more).
BF16_VS_FP64_TWIN_FACTOR, BF16_KERNEL_VS_TWIN_ULPS = 1.25, 2
BF16_CUDA_CASES = [(150, 16, 16, 16), (128, 16, 16, 16), (8, 16, 32, 112), (1, 16, 37, 53),
                   (3, 8, 16, 16), (2, 8, 12, 20), (2, 16, 56, 112), (132, 16, 16, 16),
                   (300, 16, 16, 16), (64, 16, 16, 16)]


def bf16_block_case(shape, seed, device="cpu"):
    b, f, h, w = shape
    ws, bs = init_scale_block(f, seed=seed, requires_grad=False)
    x = torch.randn(b, f, h, w, generator=torch.Generator().manual_seed(seed + 1))
    return x.to(torch.bfloat16).to(device), [t.to(device) for t in ws], [t.to(device) for t in bs]


def bf16_errors(got, x, ws, bs):
    """(kernel's max error vs float64, twin's max error vs float64, max
    |kernel - twin|, one bf16 ulp of the output's largest magnitude)."""
    want64 = drb_forward_reference(x, ws, bs, sum_dtype=torch.float64).double()
    twin = drb_forward_reference(x, ws, bs).double()
    got = got.double()
    return ((got - want64).abs().max().item(), (twin - want64).abs().max().item(),
            (got - twin).abs().max().item(), bf16_ulp(want64.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_CUDA_CASES, ids=lambda s: "B{}-F{}-{}x{}".format(*s))
def test_cuda_bf16_kernel_matches_twin(cuda_device, shape):
    x, ws, bs = bf16_block_case(shape, seed=shape[0] + shape[2], device=cuda_device)
    before, before_bf16 = drb_forward.launches, drb_forward.launches_bf16
    with torch.inference_mode():
        got = drb_forward(x, ws, bs)
        kernel_err, twin_err, vs_twin, ulp = bf16_errors(got, x, ws, bs)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert (drb_forward.launches, drb_forward.launches_bf16) == (before + 1, before_bf16 + 1)
    assert kernel_err <= max(BF16_VS_FP64_TWIN_FACTOR * twin_err, ulp), (kernel_err, twin_err, ulp)
    assert vs_twin <= BF16_KERNEL_VS_TWIN_ULPS * ulp, (vs_twin, ulp)


def bf16_grad_case(seed=22, b=128, f=16, h=16, w=16, init_scale=False):
    """The bf16 gradient test's inputs, made by numpy so that the card and
    the CPU (the JAX package's side) start from the same values: x and the
    output weighting (both rounded to bf16 where they are used), and fp32
    DRB parameters at ``init_scale_block``'s scale, or with ``init_scale``
    at the generator's init, U(+-1/sqrt(fan_in)) for weights and biases
    alike. NCHW, OIHW."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, f, h, w)).astype(np.float32)
    weight = rng.standard_normal((b, f, h, w)).astype(np.float32)
    if init_scale:
        bounds = [1 / np.sqrt(9 * s * f) for s in range(1, 6)]
        ws = [rng.uniform(-c, c, (f, s * f, 3, 3)).astype(np.float32)
              for s, c in zip(range(1, 6), bounds)]
        bs = [rng.uniform(-c, c, (f,)).astype(np.float32) for c in bounds]
        return x, weight, ws, bs
    ws = [(rng.uniform(-0.5, 0.5, (f, s * f, 3, 3)) / np.sqrt(9 * s * f)).astype(np.float32)
          for s in range(1, 6)]
    bs = [rng.uniform(-0.5, 0.5, (f,)).astype(np.float32) for _ in range(5)]
    return x, weight, ws, bs


def float64_grads(x, weight, ws, bs):
    """Gradients of sum(weight * DRB(x)) with respect to x, the five weights
    and the five biases, in float64 from the bf16-rounded inputs and
    parameters, with no rounding inside (the bf16 block's exact value)."""
    leaves = [t.detach().to(torch.bfloat16).double().requires_grad_() for t in (x, *ws, *bs)]
    out = cudnn_chain(leaves[0], leaves[1:6], leaves[6:])
    return torch.autograd.grad((out * weight.to(torch.bfloat16).double()).sum(), leaves)


def grad_errors_by_kind(got, want):
    """Each gradient's max |got - want| relative to its largest entry; the
    worst tensor of each kind (x, the kernels, the biases)."""
    errs = [((g.double() - w.double()).abs().max() / w.double().abs().max()).item()
            for g, w in zip(got, want)]
    return {"x": errs[0], "kernels": max(errs[1:6]), "biases": max(errs[6:])}


# DRBFunction in bf16 (the bf16 kernel forward, the bf16 cuDNN recompute
# backward) against float64_grads, at bf16_grad_case(). A bf16 backward
# rounds every conv's output gradient and sums the gradients of a tensor
# that several stages use in bf16; the JAX package's bf16 DRB does the same
# (XLA adds bf16 cotangents in bf16). So the limits are the JAX package's
# own error at these inputs (the flax DenseResidualBlock with dtype bf16 and
# fp32 parameters, on the CPU: x 3.66e-3, kernels 3.48e-2, biases 1.95e-1),
# times 1.25, rounded down; test_bf16_grad_limits_are_the_reference_error
# recomputes them.
BF16_GRAD_LIMITS = {"x": 4.5e-3, "kernels": 4.3e-2, "biases": 2.4e-1}
BF16_GRAD_REFERENCE_FACTOR = 1.25
# At the generator's init scale the biases are small (|b| <= 1/sqrt(9 F s)
# against 0.5 above), and every gradient, the biases' included, is held
# within 6e-2 of its largest entry.
BF16_GRAD_CASES = {"reference-inputs": ({}, BF16_GRAD_LIMITS),
                   "init-scale": ({"seed": 23, "init_scale": True},
                                  dict.fromkeys(BF16_GRAD_LIMITS, 6e-2))}


def test_bf16_grad_limits_are_the_reference_error():
    """The card test's limits against the JAX package's bf16 DRB at the
    same inputs: no limit above 1.25x the reference's error, none below
    the reference's error itself."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from downgan_tpu.models.generator import DenseResidualBlock as FlaxDRB

    x, weight, ws, bs = bf16_grad_case()
    want = float64_grads(*(torch.from_numpy(a) for a in (x, weight)),
                         [torch.from_numpy(a) for a in ws], [torch.from_numpy(a) for a in bs])
    params = {"params": {f"b{s + 1}": {"Conv_0": {"kernel": jnp.asarray(ws[s].transpose(2, 3, 1, 0)),
                                                  "bias": jnp.asarray(bs[s])}} for s in range(5)}}
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)
    weight_nhwc = jnp.asarray(weight.transpose(0, 2, 3, 1)).astype(jnp.bfloat16).astype(jnp.float32)

    def loss(x_nhwc, params):
        out = FlaxDRB(x.shape[1], dtype=jnp.bfloat16).apply(params, x_nhwc)
        return jnp.sum(out.astype(jnp.float32) * weight_nhwc)

    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x_nhwc, params)
    convs = [gp["params"][f"b{s + 1}"]["Conv_0"] for s in range(5)]
    got = ([torch.from_numpy(np.array(gx.astype(jnp.float32)).transpose(0, 3, 1, 2))]
           + [torch.from_numpy(np.array(c["kernel"]).transpose(3, 2, 0, 1)) for c in convs]
           + [torch.from_numpy(np.array(c["bias"])) for c in convs])
    reference = grad_errors_by_kind(got, want)
    for kind, limit in BF16_GRAD_LIMITS.items():
        assert reference[kind] <= limit <= BF16_GRAD_REFERENCE_FACTOR * reference[kind], (
            kind, limit, reference)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_GRAD_CASES)
def test_cuda_bf16_drb_function_gradients_match_float64(cuda_device, case):
    kwargs, limits = BF16_GRAD_CASES[case]
    x, weight, ws, bs = bf16_grad_case(**kwargs)
    ws = [torch.from_numpy(t).to(cuda_device).requires_grad_() for t in ws]
    bs = [torch.from_numpy(t).to(cuda_device).requires_grad_() for t in bs]
    x = torch.from_numpy(x).to(cuda_device, torch.bfloat16).requires_grad_()
    weight = torch.from_numpy(weight).to(cuda_device, torch.bfloat16)
    before = drb_forward.launches_bf16
    out = DRBFunction.apply(x, pack_drb_weights(ws, bs, torch.bfloat16), *ws, *bs, SLOPE)
    got = torch.autograd.grad((out.float() * weight.float()).sum(), [x, *ws, *bs])
    torch.cuda.synchronize()
    assert drb_forward.launches_bf16 == before + 1 and out.dtype == torch.bfloat16
    for g, leaf in zip(got, (x, *ws, *bs)):
        assert g.dtype == leaf.dtype  # bf16 for x, fp32 for the fp32 parameters
    errors = grad_errors_by_kind(got, float64_grads(x, weight, ws, bs))
    assert all(errors[k] <= limit for k, limit in limits.items()), (errors, limits)
