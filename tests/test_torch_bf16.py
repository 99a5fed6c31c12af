"""The port's bf16 compute path (``hp.compute_dtype = "bfloat16"``) against
the JAX package's: the dtype conv against flax ``Conv3x3(dtype=bfloat16)``,
the bf16 DRB twin against the flax ``DenseResidualBlock(dtype=bfloat16)``,
the tiny generator and critic against their bf16 flax modules, and the GP
value and critic gradients against ``jax.grad`` of the JAX critic loss, all
on the same weights and inputs made by numpy; the twin's three rounding
points; and that the path is bf16 inside (hooks see bf16 activations, and
the output is off the fp32 model's by more than fp32 noise).

Tolerances are in bf16 ulps of the compared tensor's largest magnitude, or
relative, and each was measured on this suite's inputs with a margin: the
two frameworks round at other places (flax adds the bias to a conv output
already rounded to bf16, and multiplies by the LeakyReLU slope and the
residual scales as bf16 constants, 0.01 -> 0.010009765625 and 0.2 ->
0.2001953125; torch keeps those constants in fp32 and rounds once).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# The reference side: where JAX or flax is absent (the card machine) the
# module skips rather than failing `pytest -m cuda --noconftest` at collection.
jax = pytest.importorskip("jax")
pytest.importorskip("flax")

import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.models.generator import DenseResidualBlock as JaxDRB  # noqa: E402
from downgan_tpu.models.layers import Conv3x3 as JaxConv3x3  # noqa: E402
from downgan_tpu.training.state import make_models  # noqa: E402
from downgan_tpu.training.wgan import gradient_penalty as jax_gradient_penalty  # noqa: E402
from downgan_tpu.training.wgan import make_loss_fns  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.models.critic import Critic  # noqa: E402
from downgan_tpu_torch.models.generator import DenseResidualBlock  # noqa: E402
from downgan_tpu_torch.models.layers import Conv2d  # noqa: E402
from downgan_tpu_torch.ops.cuda.drb import (  # noqa: E402
    RES_SCALE,
    SLOPE,
    bf16_chunks,
    drb_forward,
    drb_forward_reference,
    pack_drb_weights,
    packed_size,
)
from downgan_tpu_torch.training.state import load_generator  # noqa: E402
from downgan_tpu_torch.training.wgan import critic_loss, gradient_penalty  # noqa: E402
from downgan_tpu_torch.utils.port_weights import (  # noqa: E402
    conv_from_flax,
    critic_state_dict_from_flax,
    generator_state_dict_from_flax,
)

from _torch_parity import flax_critic, flax_generator, one_thread  # noqa: E402,F401

BF16 = torch.bfloat16
# One conv: both sides sum in fp32; the port rounds once (<= 1/2 ulp), flax
# rounds the conv output and again after adding the bias (<= 1 ulp), so
# the two are at most 1.5 ulps apart (measured: 1 ulp at stride 2).
CONV_ULPS = 2
# One DRB: the per-element rounding differences of five stages and the
# residual, carried through the concat (measured: 1 ulp).
DRB_ULPS = 4
# The tiny generator (1 RRDB, three pixel-shuffle stages) and the critic
# (eight convs, two dense layers) compound those differences through every
# layer, relative to the output's largest magnitude (measured: 4.0e-3 and
# 1.7e-2).
GEN_REL, CRITIC_REL = 2e-2, 4e-2
# The GP value, ~100 * (|grad| - 1)^2 (measured: 5.6e-3 relative).
GP_REL = 2e-2
# The critic loss's gradients at the init scale (loss ~100, GP-dominated),
# through the bf16 double backward: bf16 gradients are coarse in both
# frameworks (each backward conv rounds its output), so relative L2 over
# the whole gradient (measured: 8.1e-2; the fp32 port is 8.0e-2 off the
# same JAX bf16 gradient) and per tensor (measured: at most 0.18, the first
# conv's bias, which the fp32 port misses by 0.15).
GRAD_L2, GRAD_TENSOR_L2 = 0.15, 0.3
# What fp32 noise is: the fp32 port against the fp32 flax model
# (tests/test_torch_generator.py's tolerance).
FP32_NOISE = 2e-5

JKW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
CKW = dict(filters=8, num_res_blocks=1, coarse_size=16, fine_size=128)


def bf16_ulp(magnitude):
    """The spacing of bf16 values at ``magnitude`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(magnitude)) - 7)


def as_f64(a):
    return np.asarray(jnp.asarray(a, jnp.float32) if isinstance(a, jax.Array) else a, np.float64)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(dtype)


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def set_compute_dtype(module, dtype):
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


def conv_leaf(rng, cin, cout):
    bound = 1.0 / np.sqrt(9 * cin)
    return {"kernel": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
            "bias": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


@pytest.mark.parametrize("stride", [1, 2])
def test_dtype_conv_matches_flax_conv3x3_bf16(stride):
    rng = np.random.default_rng(stride)
    leaf = conv_leaf(rng, 16, 8)
    x = rng.standard_normal((2, 12, 20, 16)).astype(np.float32)
    flax_conv = JaxConv3x3(8, stride=stride, dtype=jnp.bfloat16)
    want = flax_conv.apply({"params": {"Conv_0": leaf}}, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    conv = Conv2d(16, 8, kernel_size=3, stride=stride, padding=1, compute_dtype=BF16)
    conv.load_state_dict({k[2:]: v for k, v in conv_from_flax(leaf, "c").items()})
    assert conv.weight.dtype == torch.float32  # parameters stay fp32
    with torch.no_grad():
        got = conv(nchw(x))
    assert got.dtype == BF16
    got, want = nhwc(got), as_f64(want)
    ulp = bf16_ulp(np.abs(want).max())
    assert np.abs(got - want).max() <= CONV_ULPS * ulp
    # fp32 compute is another function: off by more than fp32 noise
    conv.compute_dtype = torch.float32
    with torch.no_grad():
        fp32 = nhwc(conv(nchw(x)))
    assert np.abs(fp32 - want).max() > 100 * FP32_NOISE


def drb_case(f, b, h, w, seed):
    rng = np.random.default_rng(seed)
    tree, ws, bs = {}, [], []
    for k in range(1, 6):
        leaf = conv_leaf(rng, k * f, f)
        tree[f"b{k}"] = {"Conv_0": leaf}
        sd = conv_from_flax(leaf, "c")
        ws.append(sd["c.weight"])
        bs.append(sd["c.bias"])
    x = rng.standard_normal((b, h, w, f)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16-exact on both sides
    return x, {"params": tree}, ws, bs


@pytest.mark.parametrize("case", [(8, 2, 16, 16), (16, 1, 12, 20)],
                         ids=["F8-B2-16x16", "F16-B1-12x20"])
def test_bf16_drb_twin_matches_flax_block_bf16(case):
    f, b, h, w = case
    x, params, ws, bs = drb_case(f, b, h, w, seed=f)
    want = JaxDRB(f, dtype=jnp.bfloat16).apply(params, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    before = drb_forward.launches
    got = drb_forward(nchw(x, BF16), ws, bs)  # a CPU tensor: the twin
    assert drb_forward.launches == before and got.dtype == BF16
    got, want = nhwc(got), as_f64(want)
    assert np.abs(got - want).max() <= DRB_ULPS * bf16_ulp(np.abs(want).max())
    fp32 = nhwc(drb_forward_reference(nchw(x), ws, bs))
    assert np.abs(fp32 - want).max() > 100 * FP32_NOISE


def rounding_variants(x, ws, bs, drop=None):
    """The bf16 DRB evaluated in float64 with F.conv2d (no code shared with
    the twin), rounding to bf16 at the three points of drb.cu except
    ``drop``: "stage" (each stage's conv output), "lrelu" (the activated
    value kept in the concat) or "residual" (the block output)."""
    def rnd(t, point):
        return t if point == drop else t.to(BF16).double()

    x64 = x.double()
    acts = x64
    for s in range(5):
        y = torch.nn.functional.conv2d(acts, ws[s].to(BF16).double(), bs[s].to(BF16).double(),
                                       padding=1)
        y = rnd(y, "stage")
        if s < 4:
            act = torch.nn.functional.leaky_relu(y.float(), SLOPE).double()
            acts = torch.cat([acts, rnd(act, "lrelu")], 1)
    return rnd(y.float() * RES_SCALE + x64.float(), "residual").float()


def test_bf16_twin_rounds_at_the_kernels_three_points():
    """The twin (here with float64 sums) is exactly the function drb.cu's
    header defines, and each of its three rounding points changes the
    result: leaving any one out gives other values."""
    x, _, ws, bs = drb_case(16, 2, 16, 16, seed=3)
    x = nchw(x, BF16)
    twin = drb_forward_reference(x, ws, bs, sum_dtype=torch.float64).float()
    torch.testing.assert_close(twin, rounding_variants(x, ws, bs), rtol=0, atol=0)
    for point in ("stage", "lrelu", "residual"):
        assert not torch.equal(twin, rounding_variants(x, ws, bs, drop=point)), point
    # fp32 sums (the twin as the kernel runs it) round the same way almost
    # everywhere: at most a few elements flip by one ulp of their own size.
    fp32_sums = drb_forward_reference(x, ws, bs).float()
    assert (fp32_sums != twin).float().mean() < 1e-3
    assert ((fp32_sums - twin).abs() <= 2.0 ** -7 * twin.abs()).all()


def test_bf16_pack_layout():
    """bf16: wgmma's canonical K-major B layout with the three dx taps side
    by side in N: with n = dx*F + co = 8*nb + r and ci = 16*c + 8*kb + e,
    w[co, ci, dy, dx] is element (c*3 + dy)*48*F + nb*128 + kb*64 + r*8 + e
    of its stage (bf16_chunks(F, s) k16 chunks c, zero past s*F inputs);
    then the biases, rounded to bf16, as fp32."""
    for f in (8, 16):
        g = torch.Generator().manual_seed(f)
        ws = [torch.rand(f, s * f, 3, 3, generator=g) - 0.5 for s in range(1, 6)]
        bs = [torch.rand(f, generator=g) - 0.5 for _ in range(5)]
        packed = pack_drb_weights(ws, bs, BF16)
        assert packed.dtype == torch.int32 and packed.numel() == packed_size(f, BF16)
        halves = packed.view(BF16)  # little-endian: half 0 of word i is element 2i
        off = 0
        for s, wt in enumerate(ws, start=1):
            n_stage = bf16_chunks(f, s) * 3 * 48 * f
            stage = halves[off:off + n_stage]
            idx = torch.empty(wt.shape, dtype=torch.long)
            for co in range(f):
                for ci in range(wt.shape[1]):
                    c, kk = divmod(ci, 16)
                    kb, e = divmod(kk, 8)
                    for dy in range(3):
                        for dx in range(3):
                            nb, r = divmod(dx * f + co, 8)
                            idx[co, ci, dy, dx] = ((c * 3 + dy) * 48 * f + nb * 128 + kb * 64
                                                   + r * 8 + e)
            assert len(set(idx.reshape(-1).tolist())) == wt.numel()  # one place per weight
            torch.testing.assert_close(stage[idx], wt.to(BF16), rtol=0, atol=0)
            rest = torch.ones(n_stage, dtype=torch.bool)
            rest[idx.reshape(-1)] = False
            assert not stage[rest].float().any()  # the zero-padded inputs past s*F
            off += n_stage
        bias = packed[off // 2:].view(torch.float32)
        torch.testing.assert_close(bias, torch.cat(bs).to(BF16).float(), rtol=0, atol=0)
        # an fp32 pack of the same parameters is another tensor
        assert pack_drb_weights(ws, bs).dtype == torch.float32


def test_drb_block_packs_per_dtype():
    """The block's packed-weight cache keys on the dtype it runs in: an fp32
    and a bf16 pack of the same parameters are never confused."""
    block = DenseResidualBlock(8)
    ws, bs = block.stage_params()
    x = torch.randn(1, 8, 16, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        block(x)
        fp32_pack = block._packed
        block(x.to(BF16))
        assert block._packed.dtype == torch.int32 and fp32_pack.dtype == torch.float32
        torch.testing.assert_close(block._packed, pack_drb_weights(ws, bs, BF16), rtol=0, atol=0)
        block(x)
        torch.testing.assert_close(block._packed, fp32_pack, rtol=0, atol=0)


@pytest.fixture(scope="module")
def bf16_generators():
    jcfg = JaxConfig(hp=JaxHyperParams(compute_dtype="bfloat16"), **JKW)
    cfg = Config(hp=HyperParams(compute_dtype="bfloat16"), **JKW)
    jgen, params = flax_generator(jcfg, cfg, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 7)).astype(np.float32)
    want = as_f64(jax.jit(jgen.apply)(params, jnp.asarray(x)))
    sd = generator_state_dict_from_flax(params, num_res_blocks=1, num_upsample=3)
    return cfg, sd, x, want


def test_bf16_generator_matches_flax_bf16(bf16_generators):
    cfg, sd, x, want = bf16_generators
    gen = load_generator(cfg, sd, "cpu")
    assert gen.compute_dtype == BF16 and all(p.dtype == torch.float32 for p in gen.parameters())
    seen = {}

    def hook(module, args, out):
        seen.setdefault(type(module).__name__, set()).update({args[0].dtype, out.dtype})

    hooks = [m.register_forward_hook(hook) for m in gen.modules()
             if isinstance(m, (Conv2d, DenseResidualBlock, torch.nn.PixelShuffle))]
    with torch.inference_mode():
        got = gen(nchw(x))
    for h in hooks:
        h.remove()
    assert got.dtype == torch.float32  # fp32 out, as the JAX Generator
    assert seen == {"Conv2d": {BF16}, "DenseResidualBlock": {BF16}, "PixelShuffle": {BF16}}
    got = nhwc(got)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= GEN_REL * scale
    fp32 = load_generator(Config(**JKW), sd, "cpu")
    with torch.inference_mode():
        off = np.abs(nhwc(fp32(nchw(x))) - got).max()
    assert off > 100 * FP32_NOISE * scale  # the bf16 path is not the fp32 one


@pytest.fixture(scope="module")
def bf16_critics():
    jcfg = JaxConfig(hp=JaxHyperParams(compute_dtype="bfloat16"), **CKW)
    jcritic, variables, _ = flax_critic(jcfg, seed=6, conv_gain=2.5)
    critic = Critic(base=8, fine_size=128, compute_dtype=BF16)
    critic.load_state_dict(critic_state_dict_from_flax(variables, base=8, fine_size=128))
    return jcfg, jcritic, variables, critic


def test_bf16_critic_matches_flax_bf16(bf16_critics):
    _, jcritic, variables, critic = bf16_critics
    x = np.random.default_rng(7).standard_normal((3, 128, 128, 2)).astype(np.float32)
    want = as_f64(jax.jit(jcritic.apply)(variables, jnp.asarray(x)))
    seen = set()
    hooks = [m.register_forward_hook(lambda m, a, o: seen.add(o.dtype))
             for m in critic.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear,
                                                         torch.nn.LeakyReLU))]
    with torch.no_grad():
        got = critic(nchw(x))
    for h in hooks:
        h.remove()
    assert got.dtype == torch.float32 and seen == {BF16}
    got = got.double().numpy()
    assert np.abs(got - want).max() <= CRITIC_REL * np.abs(want).max()
    with torch.no_grad():
        fp32 = set_compute_dtype(critic, torch.float32)(nchw(x)).double().numpy()
    set_compute_dtype(critic, BF16)
    assert np.abs(fp32 - got).max() > 100 * FP32_NOISE * np.abs(want).max()


def critic_batch(seed):
    rng = np.random.default_rng(seed)
    fake = rng.standard_normal((2, 128, 128, 2)).astype(np.float32)
    real = rng.standard_normal((2, 128, 128, 2)).astype(np.float32)
    return fake, real, rng.uniform(size=(2, 1, 1, 1)).astype(np.float32)


def as_torch(fake, real, alpha):
    return nchw(fake), nchw(real), torch.from_numpy(alpha).permute(0, 3, 1, 2)


def test_bf16_gradient_penalty_matches_jax(bf16_critics):
    """The GP, a double backward through the bf16 critic, against the JAX
    package's ``gradient_penalty`` on the same real, fake and alpha (a
    critic whose input gradients are O(1), so the GP is not ~1 for any
    critic)."""
    _, jcritic, variables, critic = bf16_critics
    fake, real, alpha = critic_batch(8)
    want = float(jax.jit(lambda v: jax_gradient_penalty(
        jcritic.apply, v, jnp.asarray(real), jnp.asarray(fake), jnp.asarray(alpha)))(variables))
    t_fake, t_real, t_alpha = as_torch(fake, real, alpha)
    got = float(gradient_penalty(critic, t_real, t_fake, t_alpha).detach())
    assert got == pytest.approx(want, rel=GP_REL) and 0.1 < got < 0.9


def test_bf16_critic_gradients_match_jax_grad():
    """The critic loss and its gradients at the init scale, against
    ``jax.value_and_grad`` of the JAX package's critic loss on the same
    fake, real and alpha; the gradients without the GP are far off (the
    tolerance sees the GP's double backward)."""
    jcfg = JaxConfig(hp=JaxHyperParams(compute_dtype="bfloat16"), **CKW)
    jcritic, variables, _ = flax_critic(jcfg, seed=6)
    critic = Critic(base=8, fine_size=128, compute_dtype=BF16)
    critic.load_state_dict(critic_state_dict_from_flax(variables, base=8, fine_size=128))
    fake, real, alpha = critic_batch(8)
    _, critic_loss_fn, _ = make_loss_fns(jcfg, make_models(jcfg)[0], jcritic)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(critic_loss_fn, has_aux=True))(
        variables, jnp.asarray(fake), jnp.asarray(real), jnp.asarray(alpha))
    want = critic_state_dict_from_flax(jax.tree.map(np.asarray, j_grads), base=8, fine_size=128)

    cfg = Config(hp=HyperParams(compute_dtype="bfloat16"), **CKW)
    t_fake, t_real, t_alpha = as_torch(fake, real, alpha)
    names = [k for k, _ in critic.named_parameters()]
    loss, c_real, c_fake = critic_loss(cfg, critic, t_fake, t_real, t_alpha)
    loss_value = float(loss.detach())
    assert loss_value == pytest.approx(float(j_loss), rel=GP_REL) and 95 < loss_value < 100.5
    grads = dict(zip(names, torch.autograd.grad(loss, list(critic.parameters()),
                                                retain_graph=True)))
    no_gp = dict(zip(names, torch.autograd.grad(c_fake - c_real, list(critic.parameters()))))
    # The last bias gets a zero gradient: C(fake) and C(real) cancel, the
    # GP does not see it.
    assert float(grads["classifier.2.bias"].abs().max()) == float(
        want["classifier.2.bias"].abs().max()) == 0.0
    kept = [k for k in names if k != "classifier.2.bias"]
    assert all(grads[k].dtype == torch.float32 for k in kept)  # fp32 parameters, fp32 gradients

    def flat(d):
        return torch.cat([d[k].reshape(-1) for k in kept])

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    assert rel_l2(flat(grads), flat(want)) <= GRAD_L2
    for k in kept:
        assert rel_l2(grads[k], want[k]) <= GRAD_TENSOR_L2, k
    assert rel_l2(flat(no_gp), flat(want)) > 0.5
