"""The port's ``generator_arch: "esrgan"``: ESRGAN's generator (dense blocks
growing by 32 channels, LeakyReLU 0.2) held to the plain fp32 reference in
``tests/_esrgan_reference.py`` on the CPU at a small size (filters 8, 1-2
RRDBs, coarse 8 -> fine 64, seeded random weights): the dense block's twin,
the generator forward, one reference-schedule train step (critic with GP,
then generator) by losses, gradients and parameter deltas. Also the
published-width parameter counts, a checkpoint round trip, the paths that
refuse it, the wide kernel's frame arithmetic and the wide backward's
route. On a CUDA card only: the wide DRB kernel against its twin at B=1, 3
and 128 and from an input 4 bytes off alignment, 69 wide launches a
generator forward at the published widths, the wide backward kernel
against the float64 twin on its own sides at B=1, 3 and 128 and bit for bit
over calls, 69 wide backward kernels a generator backward, and
``DRBFunction``'s backward against autograd through the twin:

    python -m pytest tests/test_torch_esrgan.py -m cuda --noconftest -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

import _esrgan_reference as ref  # noqa: E402
from downgan_tpu_torch.config.config import Config  # noqa: E402
from downgan_tpu_torch.models.generator import (  # noqa: E402
    ESRGAN_GROWTH,
    ESRGAN_SLOPE,
    DenseResidualBlock,
    ESRGANGenerator,
)
from downgan_tpu_torch.ops.cuda.drb import (  # noqa: E402
    WIDE_BLOCK,
    DRBFunction,
    _wide_backward_block,
    backward_on_kernel,
    backward_on_wide_kernel,
    cudnn_chain,
    drb_backward,
    drb_backward_kernel_wide,
    drb_backward_reference,
    drb_forward,
    drb_forward_reference,
    pack_drb_weights,
    packed_size,
    stage_widths,
    tf32_split,
)
from downgan_tpu_torch.training.state import (  # noqa: E402
    make_critic,
    make_generator,
    make_train_state,
)

from _torch_parity import one_thread  # noqa: E402,F401

SMALL = dict(generator_arch="esrgan", filters=8, num_res_blocks=2, coarse_size=8,
             fine_size=64)
# MS-SSIM's five levels need fields over 96 pixels a side: the 64x64 test
# fields are scored without it.
SMALL_HP = dict(batch_size=4, metrics_to_calculate=("MAE", "MSE", "Wass"))
# Twin vs reference, both fp32 on the CPU: nine shifted products summed in
# another order than F.conv2d's, over at most 9 x 136 terms a stage at
# filters 8 (9 x 192 at 64); the DRB kernel's own tolerance against the twin.
BLOCK_ATOL = BLOCK_RTOL = 1e-5


def small_config(**kw) -> Config:
    cfg = Config(**{**SMALL, **kw})
    return cfg.replace(hp=dataclasses.replace(cfg.hp, **SMALL_HP))


def numpy_params(spec, seed):
    """U(+-1/sqrt(fan_in)) for every tensor of ``spec``, drawn by numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in spec:
        wshape = dict(spec)[key.rsplit(".", 1)[0] + ".weight"]
        bound = 1.0 / np.sqrt(np.prod(wshape[1:]))
        out[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return out


def block_params(f, seed, growth=ESRGAN_GROWTH, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    ws, bs = [], []
    for cin, cout in stage_widths(f, growth):
        bound = 1.0 / (9 * cin) ** 0.5
        ws.append(((torch.rand(cout, cin, 3, 3, generator=g) * 2 - 1) * bound).to(device))
        bs.append(((torch.rand(cout, generator=g) * 2 - 1) * bound).to(device))
    return ws, bs


def layer_count(nf, nb, cin, cout, num_upsample, gc=ESRGAN_GROWTH):
    """Parameters of the ESRGAN generator from its layer list."""
    def conv(o, i):
        return o * i * 9 + o

    block = sum(conv(co, ci) for ci, co in ((nf + gc * (k - 1), gc if k < 5 else nf)
                                            for k in range(1, 6)))
    return (conv(nf, cin) + 3 * nb * block + conv(nf, nf) + num_upsample * conv(4 * nf, nf)
            + conv(nf, nf) + conv(cout, nf))


def critic_count(base, cin, fine):
    widths = [1, 1, 2, 2, 4, 4, 8, 8]
    n, c = 0, cin
    for i, m in enumerate(widths):
        n += m * base * c * 9 + (m * base if i == 0 else 0)
        c = m * base
    flat = 8 * base * (fine // 16) ** 2
    return n + 100 * flat + 100 + 100 + 1


# ---- the block and the generator against the reference ---------------------

@pytest.mark.parametrize("f", [8, 64])
def test_dense_block_twin_matches_the_reference(f):
    """Stage s of ESRGAN's block convolves f + 32(s-1) channels to 32 (the
    fifth to f); the twin and the module on the CPU equal the reference's
    five F.conv2d with LeakyReLU 0.2."""
    ws, bs = block_params(f, seed=f)
    x = torch.from_numpy(np.random.default_rng(f).standard_normal((2, f, 8, 8)).astype(np.float32))
    p = {f"blk.b{k}.0.{n}": t for k in range(1, 6)
         for n, t in (("weight", ws[k - 1]), ("bias", bs[k - 1]))}
    want = ref.dense_block(x, p, "blk")
    got = drb_forward_reference(x, ws, bs, slope=ESRGAN_SLOPE)
    torch.testing.assert_close(got, want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    module = DenseResidualBlock(f, ESRGAN_GROWTH, ESRGAN_SLOPE)
    module.load_state_dict({k.removeprefix("blk."): v for k, v in p.items()})
    with torch.no_grad():
        torch.testing.assert_close(module(x), want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    # the florida slope gives another block: the slope is not left at its default
    assert not torch.allclose(drb_forward_reference(x, ws, bs), want, atol=1e-3)


def test_generator_forward_matches_the_reference():
    """The port's generator (make_generator, generator_arch "esrgan") with
    the reference's weights against the reference forward: 2 RRDBs (6 dense
    blocks), three x2 upsamplings. Tolerance: the block's 1e-5, relative
    to the output's largest value, carried through 6 blocks, 3 upsampling
    convs and the head (measured 4e-7 here)."""
    cfg = small_config()
    gen = make_generator(cfg, "cpu")
    assert isinstance(gen, ESRGANGenerator)
    spec = ref.generator_spec(8, 2, 7, 2, cfg.num_upsample)
    assert [(k, tuple(v.shape)) for k, v in gen.state_dict().items()] == spec
    p = numpy_params(spec, seed=1)
    gen.load_state_dict(p)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 7, 8, 8)).astype(np.float32))
    with torch.no_grad(), ref.fp32():
        got, want = gen(x), ref.generator(p, x, 2, cfg.num_upsample)
    assert got.shape == (3, 2, 64, 64)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_one_train_step_matches_the_reference():
    """Step 0 of the reference schedule through the port's build_train_step
    (a critic update with its GP, then a generator update against the
    updated critic), from the reference's weights and the same alpha:
    * losses to 1e-5 relative (fp32 sums of the same terms in another order;
      the GP term is ~100 at init; measured equal);
    * gradients, read as Adam's first moment / (1 - beta1), to 1e-4 of each
      network's largest: the port's critic takes the GP's weight terms as
      wgrads (models/layers.py::CriticConv2d), the reference as stock
      autograd, sums over 4 x 64 x 64 pixels in other orders (measured at
      most 6.3e-6 over three seeds);
    * every parameter's delta to 1e-2 lr: Adam's first step is
      lr g / (|g| + 1e-8), so a gradient off by a share e moves it by at
      most lr e / 4, most where |g| is near 1e-8, as in the generator's
      trunk at init (measured at most 1.7e-3 lr over three seeds)."""
    cfg = small_config()
    state = make_train_state(cfg, "cpu")
    g_spec = ref.generator_spec(8, 2, 7, 2, cfg.num_upsample)
    c_spec = ref.critic_spec(8, 2, 64)
    g_p, c_p = numpy_params(g_spec, seed=3), numpy_params(c_spec, seed=4)
    state.generator.load_state_dict(g_p)
    state.critic.load_state_dict(c_p)
    rng = np.random.default_rng(5)
    coarse = torch.from_numpy(rng.standard_normal((4, 7, 8, 8)).astype(np.float32))
    fine = torch.from_numpy(rng.standard_normal((4, 2, 64, 64)).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(size=(4, 1, 1, 1)).astype(np.float32))
    from downgan_tpu_torch.training.wgan import build_train_step

    step = build_train_step(cfg, state.generator, state.critic)
    metrics = step(state, coarse, fine, alpha=alpha)
    hp = dict(gp_lambda=cfg.hp.gp_lambda, double_gp_lambda=cfg.hp.double_gp_lambda,
              lr=cfg.hp.lr, beta1=cfg.hp.beta1, beta2=cfg.hp.beta2, gamma=cfg.hp.gamma,
              content_lambda=cfg.hp.content_lambda)
    want = ref.reference_step(g_p, c_p, coarse, fine, alpha, hp, 2, cfg.num_upsample)
    for key in ("critic_loss", "gen_loss"):
        assert abs(float(metrics[key]) - want[key]) <= 1e-5 * abs(want[key]), key
    for net, module, opt, grads, new in (
            ("critic", state.critic, state.c_opt, want["c_grads"], want["c_new"]),
            ("generator", state.generator, state.g_opt, want["g_grads"], want["g_new"])):
        named = dict(module.named_parameters())
        scale = max(float(g.abs().max()) for g in grads.values())
        for k, p in named.items():
            got_g = opt.state[p]["exp_avg"] / (1 - cfg.hp.beta1)
            assert float((got_g - grads[k]).abs().max()) <= 1e-4 * scale, (net, k)
            start = (g_p if net == "generator" else c_p)[k]
            off = (p.detach() - start) - (new[k] - start)
            assert float(off.abs().max()) <= 1e-2 * cfg.hp.lr, (net, k)


# ---- sizes, checkpoints, refusals -------------------------------------------

def test_published_width_parameter_counts():
    """filters 64, 23 RRDBs, growth 32 on the florida shapes: 17,068,994
    generator and 7,959,945 critic parameters, as the layer arithmetic
    gives; DoWnGAN's florida generator still counts 1,696,514."""
    cfg = Config(generator_arch="esrgan", filters=64, num_res_blocks=23)
    gen = make_generator(cfg, "cpu")
    n_gen = sum(p.numel() for p in gen.parameters())
    n_critic = sum(p.numel() for p in make_critic(cfg, "cpu").parameters())
    assert n_gen == layer_count(64, 23, 7, 2, 3) == 17_068_994
    assert n_critic == critic_count(64, 2, 128) == 7_959_945
    blocks = [m for m in gen.modules() if isinstance(m, DenseResidualBlock)]
    assert len(blocks) == 69 and {m.slope for m in blocks} == {ESRGAN_SLOPE}
    assert [tuple(w.shape[:2]) for w in blocks[0].stage_params()[0]] == \
        [(32, 64), (32, 96), (32, 128), (32, 160), (64, 192)]
    florida = make_generator(Config(), "cpu")
    assert sum(p.numel() for p in florida.parameters()) == 1_696_514
    assert {m.slope for m in florida.modules() if isinstance(m, DenseResidualBlock)} == {0.01}


def test_checkpoint_round_trip(tmp_path):
    """A trained step's full state through CheckpointManager into a state
    built from another seed, and the generator through a bundle: the same
    tensors, the same forward, and the same fields from the batch
    generation loop (generate_fields, chunks of 3 with a ragged tail)."""
    from downgan_tpu_torch.inference import generate_fields, load_bundle, write_generator_bundle
    from downgan_tpu_torch.training.state import load_generator
    from downgan_tpu_torch.training.wgan import build_train_step
    from downgan_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = small_config(num_res_blocks=1)
    state = make_train_state(cfg, "cpu")
    rng = np.random.default_rng(6)
    coarse = torch.from_numpy(rng.standard_normal((4, 7, 8, 8)).astype(np.float32))
    fine = torch.from_numpy(rng.standard_normal((4, 2, 64, 64)).astype(np.float32))
    build_train_step(cfg, state.generator, state.critic)(state, coarse, fine)
    CheckpointManager(str(tmp_path / "ckpt")).save(1, state)
    other = make_train_state(cfg.replace(seed=cfg.seed + 7), "cpu")
    other.load_state_dict(CheckpointManager(str(tmp_path / "ckpt")).restore())
    for a, b in zip(state.state_dict()["generator"].values(),
                    other.state_dict()["generator"].values()):
        assert torch.equal(a, b)
    assert other.step == state.step == 1
    write_generator_bundle(str(tmp_path / "bundle"), cfg, state.generator.state_dict())
    bcfg, weights, _ = load_bundle(str(tmp_path / "bundle"))
    assert bcfg.generator_arch == "esrgan"
    served = load_generator(bcfg, weights, "cpu")
    with torch.no_grad():
        want = state.generator.eval()(coarse)
        assert torch.equal(served(coarse), want)
    fields = generate_fields(bcfg, weights, coarse.permute(0, 2, 3, 1).numpy(), chunk_size=3,
                             device="cpu")
    # chunks of 3 (the tail padded) against one batch of 4: CPU convolutions may
    # sum in another order at another batch size
    np.testing.assert_allclose(fields, want.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-6)


def test_bf16_sharding_and_torch_layout_refuse_esrgan(tmp_path, capsys):
    """bf16 compute, spatial sharding and export-torch/import-torch raise a
    ValueError at build time that names what they take."""
    from downgan_tpu_torch.cli.__main__ import main
    from downgan_tpu_torch.inference import write_generator_bundle
    from downgan_tpu_torch.parallel.spatial import ShardedGenerator, sharded_generator_apply
    from downgan_tpu_torch.utils.port_weights import check_reference_layout

    cfg = small_config()
    bf16 = cfg.replace(hp=dataclasses.replace(cfg.hp, compute_dtype="bfloat16"))
    with pytest.raises(ValueError, match="float32 only.*'rrdb'"):
        make_generator(bf16, "cpu")
    with pytest.raises(ValueError, match="RRDB generator only"):
        sharded_generator_apply(cfg)
    gen = make_generator(cfg, "cpu")
    with pytest.raises(ValueError, match="RRDB generator only.*ESRGANGenerator"):
        ShardedGenerator(gen)
    with pytest.raises(ValueError, match="export-torch maps the reference RRDB layout only"):
        check_reference_layout("export-torch", "esrgan")
    sd = gen.state_dict()
    with pytest.raises(ValueError, match="import-torch .* grow by 32 channels at filters=8"):
        check_reference_layout("import-torch", sd=sd)
    check_reference_layout("import-torch", sd=make_generator(Config(**{
        **SMALL, "generator_arch": "rrdb"}), "cpu").state_dict())  # the RRDB layout passes
    # and the commands exit 2 with those messages
    write_generator_bundle(str(tmp_path / "b"), cfg, sd)
    with pytest.raises(SystemExit) as exc:
        main(["export-torch", "--checkpoint", str(tmp_path / "b"), "--out", str(tmp_path / "g.pt")])
    assert exc.value.code == 2 and "generator_arch='esrgan'" in capsys.readouterr().err
    torch.save(sd, tmp_path / "g.pt")
    with pytest.raises(SystemExit) as exc:
        main(["import-torch", "--weights", str(tmp_path / "g.pt"), "--out", str(tmp_path / "o")])
    assert exc.value.code == 2 and "grow by 32" in capsys.readouterr().err


# ---- the wide kernel's arithmetic and frame, on the CPU ----------------------

def test_wide_pack_and_3xtf32_hold_the_kernel_tolerance():
    """The wide kernel reads pack_drb_weights' fp32 layout at ESRGAN's stage
    widths (packed_size with growth 32); its 3xTF32 arithmetic (both
    operands split, lo x lo dropped) stays within 1e-5 of the fp32 twin at
    (64, 32), and plain TF32 does not."""
    f, growth, slope = WIDE_BLOCK
    ws, bs = block_params(f, seed=9)
    packed = pack_drb_weights(ws, bs)
    assert packed.numel() == packed_size(f, growth=growth) == 2 * 9 * 26_624 + 192
    torch.testing.assert_close(packed[-192:], torch.cat(bs), rtol=0, atol=0)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, f, 16, 16))
                         .astype(np.float32))
    want = drb_forward_reference(x, ws, bs, slope=slope)

    def trunc(t):
        return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)

    def emulate(passes):
        acts = x
        for s in range(5):
            padded = F.pad(acts, (1, 1, 1, 1))
            a_hi = tf32_split(padded)[0]
            a_lo = trunc(padded - a_hi)
            w_hi, w_lo = tf32_split(ws[s])
            acc = bs[s].reshape(1, -1, 1, 1).expand(2, ws[s].shape[0], 16, 16)
            for t in range(9):
                dy, dx = divmod(t, 3)
                ah, al = a_hi[..., dy:dy + 16, dx:dx + 16], a_lo[..., dy:dy + 16, dx:dx + 16]
                if passes == 3:
                    acc = acc + torch.einsum("oc,bchw->bohw", w_hi[:, :, dy, dx], al)
                    acc = acc + torch.einsum("oc,bchw->bohw", w_lo[:, :, dy, dx], ah)
                acc = acc + torch.einsum("oc,bchw->bohw", w_hi[:, :, dy, dx], ah)
            if s < 4:
                acts = torch.cat([acts, F.leaky_relu(acc, slope)], dim=1)
        return acc * 0.2 + x

    torch.testing.assert_close(emulate(3), want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    assert not torch.allclose(emulate(1), want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_wide_frame_reads_the_zero_padded_window():
    """drb_kernel_wide's frame: a plane of 296 floats holds a zero row, the
    16 image rows at pitch 16 and a zero row; pixel (y, x) at (y+1)*16 + x,
    tap (dy, dx) at offset (dy-1)*16 + (dx-1), the operand zeroed for
    dx = 0 at x = 0 and dx = 2 at x = 15, and 32 guard floats before plane
    0. Gathering by those formulas gives the zero-padded 3x3 window of
    every pixel, and no read leaves the guard and the 192 planes."""
    plane, guard, side = 296, 32, 16
    img = torch.arange(1, 1 + 2 * 256, dtype=torch.float32).reshape(2, 16, 16)
    smem = torch.zeros(guard + 2 * plane)
    for c in range(2):
        smem[guard + c * plane + side:guard + c * plane + side + 256] = img[c].reshape(-1)
    padded = F.pad(img, (1, 1, 1, 1))
    lowest, highest = 10 ** 9, -1
    for c in range(2):
        for y in range(16):
            for x in range(16):
                for dy in range(3):
                    for dx in range(3):
                        at = guard + c * plane + (y + 1) * side + x + (dy - 1) * side + dx - 1
                        lowest, highest = min(lowest, at), max(highest, at)
                        masked = (dx == 0 and x == 0) or (dx == 2 and x == 15)
                        got = 0.0 if masked else float(smem[at])
                        assert got == float(padded[c, y + dy, x + dx]), (c, y, x, dy, dx)
    assert lowest >= guard - 1 and highest < guard + 2 * plane
    assert plane % 32 == 8 and (guard + 192 * plane) * 4 <= 232_448


def test_wide_backward_reads_the_transpose_from_the_packed_fragments():
    """drb_backward_kernel_wide's dgrad takes its B fragments from the
    forward's packed weights, transposed by drb_dgrad_frags_wide: lane (gq,
    tq) of the fragment for stage t's output chunk k and input chunk n at
    tap takes the float4s of forward lanes (tq, gq & 3) and (tq + 4, gq & 3),
    component gq >> 2 (hi) and 2 + (gq >> 2) (lo): W_t[8k + tq][8n + gq] and
    W_t[8k + tq + 4][8n + gq], hi and lo as tf32_split gives them. Its
    frame: 256 planes of 10 x 18
    floats at a stride of 184 with a 4-float skew for channels 4-7 of each
    8, inside the 232,448 B a block may have, and both operand patterns
    (channel by thread and pixel by lane group, and the transpose) hit 32
    distinct banks."""
    f, growth, _ = WIDE_BLOCK
    ws, bs = block_params(f, seed=25)
    frag = pack_drb_weights(ws, bs)[:-192].view(-1, 4)
    lane = torch.arange(32)
    gq, tq = lane // 4, lane % 4
    upper = (gq >= 4).long()
    start = 0
    for (cin, cout), w in zip(stage_widths(f, growth), ws):
        ntf = cout // 8
        hi, lo = tf32_split(w)
        for n in range(cin // 8):
            for tap in range(9):
                for k in range(ntf):
                    at = start + ((n * 9 + tap) * ntf + k) * 32 + 4 * tq + (gq % 4)
                    v0, v1 = frag[at], frag[at + 16]
                    ci = 8 * n + gq
                    for v, co in ((v0, 8 * k + tq), (v1, 8 * k + tq + 4)):
                        assert torch.equal(v[lane, upper], hi[co, ci, tap // 3, tap % 3])
                        assert torch.equal(v[lane, 2 + upper], lo[co, ci, tap // 3, tap % 3])
        start += 2 * 9 * cin * cout // 4
    assert start == frag.shape[0]

    stride, pitch, rows = 184, 18, 10

    def plane(c):
        return c * stride + 4 * ((c >> 2) & 1)

    assert all(plane(c) + rows * pitch <= plane(c + 1) for c in range(255))
    assert (plane(255) + rows * pitch) <= 256 * stride and 256 * stride * 4 <= 232_448
    for c0 in range(0, 256, 8):
        by_thread = {(plane(c0 + int(t)) + int(q)) % 32 for t, q in zip(tq, gq)}
        by_group = {(plane(c0 + int(q)) + int(t)) % 32 for t, q in zip(tq, gq)}
        assert len(by_thread) == len(by_group) == 32, c0


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide DRB kernel runs only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b, offset", [(1, False), (3, False), (128, False), (128, True)],
                         ids=["B1", "B3", "B128", "B128-offset4"])
def test_cuda_wide_kernel_matches_twin_at_b128(cuda_device, b, offset):
    """At B=128 (training), and at B=1 and 3, where one CTA a sample leaves
    most SMs idle. ``offset``: x starts 4 bytes past a 16-byte boundary, so
    the kernel reads it by 4-byte copies; its output is the 16-byte path's
    bit for bit."""
    f, _, slope = WIDE_BLOCK
    ws, bs = block_params(f, seed=11, device=cuda_device)
    x = torch.randn(b, f, 16, 16, generator=torch.Generator().manual_seed(12)).to(cuda_device)
    packed = pack_drb_weights(ws, bs)
    before = drb_forward.launches_wide
    with torch.inference_mode():
        got = drb_forward(x, ws, bs, packed, slope)
        want = drb_forward_reference(x, ws, bs, slope=slope)
    torch.cuda.synchronize()
    assert drb_forward.launches_wide == before + 1
    torch.testing.assert_close(got, want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    if offset:
        shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x)
        shifted.copy_(x)
        with torch.inference_mode():
            assert torch.equal(drb_forward(shifted, ws, bs, packed, slope), got)
    with torch.inference_mode(), pytest.raises(ValueError, match="wide DRB kernel takes"):
        drb_forward(x[:, :, :8].contiguous(), ws, bs, None, slope)


@pytest.mark.cuda
def test_cuda_generator_forward_launches_69_wide_kernels(cuda_device):
    """ESRGAN at its published widths on the main path: every one of the 69
    dense blocks launches the wide kernel, and no twin runs."""
    cfg = Config(generator_arch="esrgan", filters=64, num_res_blocks=23)
    gen = make_generator(cfg, cuda_device)
    x = torch.randn(8, 7, 16, 16, generator=torch.Generator().manual_seed(13)).to(cuda_device)
    before = (drb_forward.launches, drb_forward.launches_wide)
    with torch.inference_mode():
        out = gen(x)
    torch.cuda.synchronize()
    assert (drb_forward.launches - before[0], drb_forward.launches_wide - before[1]) == (69, 69)
    assert out.shape == (8, 2, 128, 128) and bool(torch.isfinite(out).all())


def chain_sides(x, ws, bs, slope):
    """For stages 1-4, whether each pre-activation is above zero, by
    ``cudnn_chain``'s calls in x's dtype: in fp32 the LeakyReLU sides that
    ``DRBFunction``'s recompute backward differentiates."""
    sides, acts = [], x
    with torch.no_grad():
        for s in range(4):
            y = F.conv2d(acts, ws[s], bs[s], padding=1)
            sides.append(y > 0)
            acts = torch.cat([acts, F.leaky_relu(y, slope)], 1)
    return sides


def block_on_sides(x, ws, bs, slope, sides):
    """The dense block in x's dtype, stage s's LeakyReLU passing its input
    where ``sides[s]`` and scaling it by ``slope`` elsewhere."""
    acts = x
    for s in range(5):
        y = F.conv2d(acts, ws[s], bs[s], padding=1)
        if s < 4:
            acts = torch.cat([acts, torch.where(sides[s], y, slope * y)], 1)
    return y * 0.2 + x


def test_block_on_sides_is_the_twins_function():
    """The float64 yardstick of the card test below, on the CPU: on its own
    sides it is the twin's function, and on fp32's sides it differs only
    where a pre-activation lies within fp32 rounding of zero."""
    f, _, slope = WIDE_BLOCK
    ws, bs = block_params(f, seed=17)
    x = torch.randn(2, f, 16, 16, generator=torch.Generator().manual_seed(18)).double()
    ws, bs = [w.double() for w in ws], [b.double() for b in bs]
    want = drb_forward_reference(x, ws, bs, slope=slope)
    own = block_on_sides(x, ws, bs, slope, chain_sides(x, ws, bs, slope))
    torch.testing.assert_close(own, want, atol=1e-12, rtol=1e-12)
    fp32 = chain_sides(x.float(), [w.float() for w in ws], [b.float() for b in bs], slope)
    torch.testing.assert_close(block_on_sides(x, ws, bs, slope, fp32), want,
                               atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_drb_function_takes_ten_parameters_and_the_slope():
    """``DRBFunction.apply(x, packed, w1..w5, b1..b5, slope)``: on the CPU
    its forward is the twin's with that slope; ten parameters without the
    slope, or anything after it, raise instead of guessing the slope."""
    f, _, slope = WIDE_BLOCK
    ws, bs = block_params(f, seed=19)
    x = torch.randn(1, f, 16, 16, generator=torch.Generator().manual_seed(20))
    packed = pack_drb_weights(ws, bs)
    with torch.no_grad():
        torch.testing.assert_close(DRBFunction.apply(x, packed, *ws, *bs, slope),
                                   drb_forward_reference(x, ws, bs, slope=slope))
        for wrong in ((*ws, *bs), (*ws, *bs, slope, slope)):
            with pytest.raises(TypeError, match="and the slope after x and packed"):
                DRBFunction.apply(x, packed, *wrong)


def test_wide_backward_route_takes_exactly_the_esrgan_block():
    """The wide backward kernel's block, read off the input: fp32 (B, 64,
    16, 16), growth 32, slope 0.2, fp32 parameters. bf16, other sides, other
    slopes, DoWnGAN's growth and other parameter dtypes are refused, and no
    CPU tensor takes the kernel. The florida predicate refuses the wide
    block."""
    f, growth, slope = WIDE_BLOCK
    ws, bs = block_params(f, seed=21)
    x = torch.zeros(2, f, 16, 16)
    assert _wide_backward_block(x, ws, bs, slope)
    assert _wide_backward_block(torch.zeros(128, f, 16, 16), ws, bs, slope)
    assert not backward_on_wide_kernel(x, ws, bs, slope)  # a CPU tensor
    assert not backward_on_kernel(x, ws, bs, slope)
    for other in (x.bfloat16(), x.double(), torch.zeros(2, f, 8, 16), torch.zeros(2, f, 32, 32),
                  torch.zeros(2, f, 16, 12), torch.zeros(f, 16, 16)):
        assert not _wide_backward_block(other, ws, bs, slope), tuple(other.shape)
    assert not _wide_backward_block(x, ws, bs, 0.01)
    assert not _wide_backward_block(x, [w.bfloat16() for w in ws], bs, slope)
    assert not _wide_backward_block(x, ws, [b.double() for b in bs], slope)
    wd, bd = block_params(f, seed=22, growth=f)  # growth 64
    assert not _wide_backward_block(x, wd, bd, slope)
    w8, b8 = block_params(8, seed=23)
    assert not _wide_backward_block(torch.zeros(2, 8, 16, 16), w8, b8, slope)


def wide_backward_case(b, seed, device):
    """ESRGAN's block at its init scale, x and an output weighting."""
    f = WIDE_BLOCK[0]
    ws, bs = block_params(f, seed=seed, device=device)
    rng = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(b, f, 16, 16, generator=rng).to(device)
    weight = torch.randn(b, f, 16, 16, generator=rng).to(device)
    return x, ws, bs, weight


# The wide backward kernel against float64, as the florida backward kernel
# is held (tests/test_torch_drb.py::BACKWARD_KERNEL_TOL): the plain twin in
# float64 masked on the kernel's own LeakyReLU sides (its recomputed c_s,
# bit for bit the wide forward kernel's); a pre-activation that float64
# puts on the other side must lie within 1e-5 of zero. 1e-4 of each
# gradient's largest entry.
WIDE_BACKWARD_TOL = 1e-4
# The recomputed c_1 .. c_4 against float64: c_4 sums 9 x 160 products, each
# 3xTF32, in fp32; on the H100 up to 2.4e-5 off (24 of 4.2 M elements over
# 1e-5 at B=128), so 1e-4, atol = rtol. They are the forward kernel's own.
WIDE_ACTS_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 128])
def test_cuda_wide_backward_kernel_matches_float64(cuda_device, b):
    f, growth, slope = WIDE_BLOCK
    x, ws, bs, weight = wide_backward_case(b, seed=70 + b, device=cuda_device)
    packed = pack_drb_weights(ws, bs)
    leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    before = (drb_backward.launches, drb_backward.launches_wide, drb_backward.recomputes)
    out = DRBFunction.apply(leaves[0], packed, *leaves[1:], slope)
    got = torch.autograd.grad((out * weight).sum(), leaves)
    torch.cuda.synchronize()
    assert (drb_backward.launches, drb_backward.launches_wide, drb_backward.recomputes) == (
        before[0] + 1, before[1] + 1, before[2])
    acts = torch.empty(b, 4 * growth, 16, 16, device=cuda_device)
    direct = drb_backward_kernel_wide(x, ws, bs, weight, packed, acts=acts)
    assert all(torch.equal(g, d) for g, d in zip(got, direct))
    x64, ws64, bs64 = x.double(), [t.double() for t in ws], [t.double() for t in bs]
    acts64, ys = x64, []
    for s in range(4):
        ys.append(F.conv2d(acts64, ws64[s], bs64[s], padding=1))
        acts64 = torch.cat([acts64, F.leaky_relu(ys[-1], slope)], 1)
    torch.testing.assert_close(acts.double(), acts64[:, f:], atol=WIDE_ACTS_TOL, rtol=WIDE_ACTS_TOL)
    sides = [acts[:, s * growth:(s + 1) * growth] > 0 for s in range(4)]
    flipped = torch.cat([(side != (y > 0)) for side, y in zip(sides, ys)], 1)
    assert (torch.cat(ys, 1)[flipped].abs() <= 1e-5).all()
    want = drb_backward_reference(x64, ws64, bs64, weight.double(), slope=slope, sides=sides)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g.double() - w).abs().max() <= WIDE_BACKWARD_TOL * w.abs().max()


@pytest.mark.cuda
def test_cuda_wide_backward_kernel_is_bit_for_bit_and_computes_only_what_is_needed(cuda_device):
    """Two identical calls agree bit for bit (the weight gradients are
    summed over the CTAs in order, with no atomics); ``needs`` drops dx and
    the biases, or every parameter, and the rest equals the full call's."""
    x, ws, bs, weight = wide_backward_case(128, seed=80, device=cuda_device)
    packed = pack_drb_weights(ws, bs)
    first = drb_backward_kernel_wide(x, ws, bs, weight, packed)
    second = drb_backward_kernel_wide(x, ws, bs, weight, packed)
    assert all(torch.equal(p, q) for p, q in zip(first, second))
    part = drb_backward_kernel_wide(x, ws, bs, weight, packed, [False] + [True] * 5 + [False] * 5)
    assert part[0] is None and all(g is None for g in part[6:])
    assert all(torch.equal(p, q) for p, q in zip(part[1:6], first[1:6]))
    no_params = drb_backward_kernel_wide(x, ws, bs, weight, None, [True] + [False] * 10)
    assert torch.equal(no_params[0], first[0]) and all(g is None for g in no_params[1:])


@pytest.mark.cuda
def test_cuda_generator_backward_launches_69_wide_backward_kernels(cuda_device):
    """ESRGAN at its published widths under autograd: every one of the 69
    dense blocks differentiates on the wide backward kernel, and none
    recomputes."""
    cfg = Config(generator_arch="esrgan", filters=64, num_res_blocks=23)
    gen = make_generator(cfg, cuda_device)
    x = torch.randn(8, 7, 16, 16, generator=torch.Generator().manual_seed(24)).to(cuda_device)
    before = (drb_backward.launches, drb_backward.launches_wide, drb_backward.recomputes)
    gen(x).square().mean().backward()
    torch.cuda.synchronize()
    assert (drb_backward.launches - before[0], drb_backward.launches_wide - before[1],
            drb_backward.recomputes - before[2]) == (69, 69, 0)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in gen.parameters())


@pytest.mark.cuda
def test_cuda_wide_drb_function_backward_matches_autograd_through_the_twin(cuda_device):
    """DRBFunction (the wide kernel forward, the wide backward kernel) at
    B=128, against float64 autograd through the twin's function with each
    LeakyReLU on the side the kernel's recomputed activation takes
    (``block_on_sides``), each gradient within 1e-4 of its norm; a wrong
    slope, width or order is off by O(1). The cuDNN recompute that other
    blocks take (``drb_backward``, called directly) against autograd
    through ``cudnn_chain``, the function it differentiates, within 1e-5 of
    each gradient's norm: a plumbing check (cuDNN's backward may sum in
    another order from call to call). The sides are a kernel's own because
    in 14 of 33 cases on the H100 one or two pre-activations lay within
    rounding of zero on the other side of the float64 one's; the element's
    gradient then moves by 0.8 of itself, and the reading on the float64
    block's own sides was up to 1.8e-3."""
    f, growth, slope = WIDE_BLOCK
    ws, bs = block_params(f, seed=14, device=cuda_device)
    x = torch.randn(128, f, 16, 16, generator=torch.Generator().manual_seed(15)).to(cuda_device)
    weight = torch.randn(128, f, 16, 16,
                         generator=torch.Generator().manual_seed(16)).to(cuda_device)
    packed = pack_drb_weights(ws, bs)

    def grads(fn, dtype=torch.float32):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (x, *ws, *bs)]
        return torch.autograd.grad((fn(leaves) * weight.to(dtype)).sum(), leaves)

    before = (drb_forward.launches_wide, drb_backward.launches_wide, drb_backward.recomputes)
    got = grads(lambda v: DRBFunction.apply(v[0], packed, *v[1:], slope))
    assert (drb_forward.launches_wide, drb_backward.launches_wide, drb_backward.recomputes) == (
        before[0] + 1, before[1] + 1, before[2])
    acts = torch.empty(128, 4 * growth, 16, 16, device=cuda_device)
    drb_backward_kernel_wide(x, ws, bs, weight, packed, [False] * 11, acts=acts)
    sides = [acts[:, s * growth:(s + 1) * growth] > 0 for s in range(4)]
    exact = grads(lambda v: block_on_sides(v[0], v[1:6], v[6:], slope, sides), torch.float64)
    for g, e in zip(got, exact):
        assert float((g.double() - e).norm()) <= 1e-4 * float(e.norm())
    recompute = drb_backward(x, ws, bs, weight, slope=slope)
    chain = grads(lambda v: cudnn_chain(v[0], v[1:6], v[6:], slope))
    for r, c in zip(recompute, chain):
        assert float((r - c).norm()) <= 1e-5 * float(c.norm())
