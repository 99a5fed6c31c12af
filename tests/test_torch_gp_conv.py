"""The critic's conv (``models/layers.py::CriticConv2d``, :func:`critic_conv2d`):
its double backward takes each conv's weight term on the convolution
backward's weight-gradient route, where stock autograd runs a convolution
whose kernel is the layer's whole output. Held here to float64 finite
differences, to the stock path on a florida-shaped critic update (the same
gradients, no wide kernel, the same bytes saved for backward), and through
its ``double_backwards`` counter.

No JAX here, so the card's leg runs where JAX is absent:
``python -m pytest tests/test_torch_gp_conv.py -m cuda --noconftest``.
"""
import copy

import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.models.layers import (  # noqa: E402
    CriticConv2d,
    _weight_term,
    critic_conv2d,
)
from downgan_tpu_torch.training.state import make_critic, make_train_state  # noqa: E402
from downgan_tpu_torch.training.wgan import (  # noqa: E402
    build_metric_pass,
    critic_loss,
    critic_update,
    generator_update,
    gp_alpha,
)

from _torch_parity import one_thread  # noqa: E402,F401

# The florida critic (16 filters, 128x128 fields); a one-RRDB generator
# keeps the generator update cheap and changes nothing the critic sees.
FLORIDA_CRITIC = dict(filters=16, coarse_size=16, fine_size=128, num_res_blocks=1)
# Its eight convs: (in channels, out channels, input size, stride).
FLORIDA_LAYERS = [(2, 16, 128, 1), (16, 16, 128, 2), (16, 32, 64, 1), (32, 32, 64, 2),
                  (32, 64, 32, 1), (64, 64, 32, 2), (64, 128, 16, 1), (128, 128, 16, 2)]


def _config(batch: int = 4, **hp_kw) -> Config:
    return Config(hp=HyperParams(batch_size=batch, **hp_kw), **FLORIDA_CRITIC)


def _batch(config: Config, seed: int, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    b, fs, cs = config.hp.batch_size, config.fine_size, config.coarse_size
    coarse = torch.randn(b, config.generator_in_channels, cs, cs, generator=g)
    fine = torch.randn(b, config.n_predictands, fs, fs, generator=g)
    fake = torch.randn(b, config.n_predictands, fs, fs, generator=g)
    return coarse.to(device), fine.to(device), fake.to(device)


@pytest.fixture
def stock(monkeypatch):
    """Turns the critic's conv back into the stock ``F.conv2d`` path."""
    def use():
        monkeypatch.setattr(CriticConv2d, "_conv_forward", nn.Conv2d._conv_forward)
    return use


def _critic_grads(config: Config, critic: nn.Module, real, fake, alpha):
    loss, _, _ = critic_loss(config, critic, fake, real, alpha)
    return torch.autograd.grad(loss, list(critic.parameters()))


def _assert_rel_close(got, want, rel: float):
    for g, w in zip(got, want):
        assert float((g - w).norm()) <= rel * float(w.norm())


@pytest.mark.parametrize("stride", (1, 2))
@pytest.mark.parametrize("bias", (True, False))
@pytest.mark.parametrize("cin", (2, 9))
def test_gradgradcheck_float64(stride, bias, cin):
    g = torch.Generator().manual_seed(10 * stride + cin + bias)
    x = torch.randn(2, cin, 7, 6, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(3, cin, 3, 3, dtype=torch.float64, generator=g, requires_grad=True)
    b = torch.randn(3, dtype=torch.float64, generator=g, requires_grad=True)

    def fn(x, w, *b):
        return critic_conv2d(x, w, b[0] if b else None, (stride, stride), (1, 1), (1, 1), 1)

    args = (x, w, b) if bias else (x, w)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def _weight_term_inputs(layer, batch: int, device="cpu"):
    cin, cout, h, s = layer
    g = torch.Generator().manual_seed(cin * 7 + h + s)
    gg_x = torch.randn(batch, cin, h, h, generator=g).to(device)
    g_out = torch.randn(batch, cout, h // s, h // s, generator=g).to(device)
    weight = torch.randn(cout, cin, 3, 3, generator=g).to(device)
    return g_out, gg_x, weight, ((s, s), (1, 1), (1, 1), False, (0, 0), 1)


def _wgrad(g_out, gg_x, weight, conv):
    return torch.ops.aten.convolution_backward(g_out, gg_x, weight, None, *conv,
                                               [False, True, False])[1]


@pytest.mark.parametrize("layer", FLORIDA_LAYERS)
def test_cpu_weight_term_nearer_float64_than_onednn(layer):
    """On the CPU the double backward's weight term runs the GEMM
    convolution: at each florida critic layer (B=4) it is within 1e-6 of
    the float64 result, and nearer it than oneDNN's backward-weights."""
    g_out, gg_x, weight, conv = _weight_term_inputs(layer, 4)
    exact = _wgrad(g_out.double(), gg_x.double(), weight.double(), conv)
    got = _weight_term(g_out, gg_x, weight, conv)
    assert torch.backends.mkldnn.enabled
    err = float((got.double() - exact).norm() / exact.norm())
    assert err <= 1e-6
    assert err <= float((_wgrad(g_out, gg_x, weight, conv).double() - exact).norm()
                        / exact.norm())


class _Convs(TorchDispatchMode):
    """Records the weight shape of every ``aten.convolution``."""

    def __init__(self):
        super().__init__()
        self.weights = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket is torch.ops.aten.convolution:
            self.weights.append(tuple(args[1].shape))
        return func(*args, **(kwargs or {}))


def test_critic_update_convolves_with_no_kernel_wider_than_3x3():
    """A florida-shaped critic update at B=4 runs no convolution whose
    kernel is a layer's output: every weight it convolves with is 3x3."""
    config = _config()
    state = make_train_state(config, "cpu")
    _, fine, fake = _batch(config, 1)
    with _Convs() as seen:
        critic_update(config, state, state.critic, list(state.critic.parameters()), fake, fine,
                      gp_alpha(config.seed, 0, 4, fine.device))
    assert len(seen.weights) >= 3 * 8
    assert max(max(w[2:]) for w in seen.weights) == 3


def test_critic_update_gradients_match_the_stock_path(stock):
    """The critic loss's parameter gradients (real and fake forwards, the
    GP's double backward) in fp32 equal the stock path's within 1e-5 of
    each tensor's norm."""
    config = _config()
    critic = make_critic(config, "cpu")
    _, real, fake = _batch(config, 2)
    alpha = gp_alpha(config.seed, 3, 4, real.device)
    got = _critic_grads(config, critic, real, fake, alpha)
    stock()
    want = _critic_grads(config, critic, real, fake, alpha)
    _assert_rel_close(got, want, 1e-5)


def _saved_bytes(fn) -> int:
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total


def test_saves_what_stock_autograd_saves(stock):
    """The bytes saved for backward over a critic loss and its double
    backward equal the stock path's: the first backward keeps (gO, x, W),
    as ``ConvolutionBackwardBackward0`` does, and nothing more."""
    config = _config()
    critic = make_critic(config, "cpu")
    _, real, fake = _batch(config, 3)
    alpha = gp_alpha(config.seed, 4, 4, real.device)

    def run():
        _critic_grads(config, critic, real, fake, alpha)

    got = _saved_bytes(run)
    stock()
    assert got == _saved_bytes(run) > 0


def test_counter_adds_eight_per_gp_and_none_elsewhere():
    """``critic_conv2d.double_backwards`` adds one a critic conv a double
    backward: 8 a critic update (16 over two microbatches), 0 in the
    generator update and the metric pass."""
    config = _config()
    state = make_train_state(config, "cpu")
    coarse, fine, fake = _batch(config, 4)
    alpha = gp_alpha(config.seed, 0, 4, fine.device)
    c_params = list(state.critic.parameters())
    g_params = list(state.generator.parameters())

    def added(fn) -> int:
        before = critic_conv2d.double_backwards
        fn()
        return critic_conv2d.double_backwards - before

    assert added(lambda: critic_update(config, state, state.critic, c_params, fake, fine,
                                       alpha)) == 8
    assert added(lambda: generator_update(config, state, state.generator, state.critic,
                                          g_params, coarse, fine, None)) == 0
    score = build_metric_pass(config)
    assert added(lambda: score(state.critic, fake, fine, coarse)) == 0
    accum = _config(grad_accum=2)
    assert added(lambda: critic_update(accum, state, state.critic, c_params, fake, fine,
                                       alpha)) == 16


def test_conditional_critic_gradients_match_the_stock_path(stock):
    """The conditional critic (2 + 7 input channels): the same gradients
    as the stock path."""
    config = Config(hp=HyperParams(batch_size=4), critic_conditional=True, **FLORIDA_CRITIC)
    critic = make_critic(config, "cpu")
    coarse, real, fake = _batch(config, 5)
    up = torch.nn.functional.interpolate(coarse[:, :config.n_covariates], scale_factor=8)
    real, fake = torch.cat([real, up], 1), torch.cat([fake, up], 1)
    assert real.shape[1] == config.critic_in_channels == 9
    alpha = gp_alpha(config.seed, 5, 4, real.device)
    got = _critic_grads(config, critic, real, fake, alpha)
    stock()
    _assert_rel_close(got, _critic_grads(config, critic, real, fake, alpha), 1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's wgrad route is the card's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _float64(critic: nn.Module) -> nn.Module:
    """A copy of ``critic`` computing every layer in float64."""
    critic = copy.deepcopy(critic).double()
    for m in critic.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return critic


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()) / max(float(b.double().norm()), 1e-300)


@pytest.mark.cuda
def test_cuda_florida_gp_gradients_match_the_stock_path(cuda_device, stock):
    """Florida at B=128, fp32, TF32 off: each critic loss parameter gradient
    on the new path is within 1e-5 of the stock path's (norm of the
    difference over the norm), or nearer the float64 gradient than the
    stock path's is: the stock path's 128x128-kernel convs carry their own
    rounding. The counter adds 8."""
    config = _config(batch=128)
    critic = make_critic(config, cuda_device)
    _, real, fake = _batch(config, 6, cuda_device)
    alpha = gp_alpha(config.seed, 7, 128, cuda_device)
    before = critic_conv2d.double_backwards
    got = _critic_grads(config, critic, real, fake, alpha)
    assert critic_conv2d.double_backwards - before == 8
    stock()
    want = _critic_grads(config, critic, real, fake, alpha)
    exact = _critic_grads(config, _float64(critic), real.double(), fake.double(),
                          alpha.double())
    torch.cuda.synchronize()
    for name, g, w, e in zip([n for n, _ in critic.named_parameters()], got, want, exact):
        assert _rel(g, w) <= 1e-5 or _rel(g, e) < _rel(w, e), name
