"""The port's FLOP census (``downgan_tpu_torch/utils/flops.py``) against the
JAX package's (``downgan_tpu/utils/flops.py``) on tiny configs.

The multiplicities (reference schedule, fused round, ``grad_accum``,
``metrics_reuse_fake``) are ported from ``tests/test_flops.py`` and hold
exactly. The generator piece is the hand-worked sum of its convolutions,
every tap counted. Against XLA's counts each piece sits in an interval
worked out here from the networks' shapes:

* XLA counts only the taps of a padded convolution that fall inside the
  image: ``valid(n)`` taps along an axis of n pixels, ``3n - 2`` of ``3n``
  for a 3x3 SAME conv. Every convolution of the forward, of its input
  gradient and of its weight gradient sums over the same (output pixel,
  tap, input pixel) triples, so XLA counts at least ``v_min`` of the
  port's count of any of them, ``v_min`` the smallest valid share of the
  network's convolutions (0.84 on the tiny configs' 8x8 images);
* XLA also counts one FLOP an element for elementwise ops, which the
  port's census (matmuls and convolutions only) leaves out: at most 5 an
  output element of a convolution a pass (the bias add, the LeakyReLU's
  compare and select, a residual's scale and add; XLA counts 3.4-3.9 in
  the forwards here), 3 an element of a metric's fields (difference,
  abs or square, the mean's add);
* PyTorch's double backward of a convolution (the gradient penalty) runs
  two more convolutions a layer than XLA's: 6 a layer where XLA counts 4
  (``test_gp_double_backward_costs_six_convs_a_layer`` pins the port's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.utils.flops import FlopCount, train_flop_census  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

METRICS = ("MAE", "MSE", "Wass")
TINY = dict(coarse_size=8, fine_size=64, filters=8, num_res_blocks=1)
# The JAX multiplicity tests' model (tests/test_flops.py::_census).
SMALL = dict(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1)


def _config(shape=SMALL, schedule="reference", batch=8, **hp_kw):
    return Config(hp=HyperParams(batch_size=batch, schedule=schedule,
                                 metrics_to_calculate=METRICS, **hp_kw), **shape)


def _census(schedule="reference", batch=8, scan_steps=10, **hp_kw):
    return train_flop_census(_config(SMALL, schedule, batch, **hp_kw), scan_steps)


def valid(n: int, k: int = 3, s: int = 1, p: int = 1) -> int:
    """Taps of a k-wide, stride-s, p-padded conv along an n-pixel axis that
    read a pixel inside the image, summed over its outputs."""
    out = (n + 2 * p - k) // s + 1
    return sum(1 for i in range(out) for t in range(k) if 0 <= i * s - p + t < n)


def generator_convs(cfg):
    """(cin, cout, n) of every 3x3 SAME conv of the RRDB generator on n x n."""
    f, n = cfg.filters, cfg.coarse_size
    convs = [(cfg.n_covariates, f, n)]
    convs += [(s * f, f, n) for _ in range(cfg.num_res_blocks) for _ in range(3)
              for s in range(1, 6)]
    convs.append((f, f, n))
    for _ in range(cfg.num_upsample):
        convs.append((f, 4 * f, n))
        n *= 2
    return convs + [(f, f, n), (f, cfg.n_predictands, n)]


def critic_convs(cfg):
    """(cin, cout, n_in, stride) of the critic's eight 3x3 convs."""
    b, n, out = cfg.filters, cfg.fine_size, []
    for cin, cout, s in [(cfg.n_predictands, b, 1), (b, b, 2), (b, 2 * b, 1), (2 * b, 2 * b, 2),
                         (2 * b, 4 * b, 1), (4 * b, 4 * b, 2), (4 * b, 8 * b, 1),
                         (8 * b, 8 * b, 2)]:
        out.append((cin, cout, n, s))
        n = (n - 1) // s + 1
    return out


def critic_counts(cfg):
    """Per sample: (every tap, valid taps, conv output elements, smallest
    valid share) of the critic's convs, and its two linear layers' FLOPs."""
    every = val = outs = 0
    share = 1.0
    for cin, cout, n, s in critic_convs(cfg):
        o = (n - 1) // s + 1
        every += 2 * cin * cout * 9 * o * o
        val += 2 * cin * cout * valid(n, 3, s) ** 2
        outs += cout * o * o
        share = min(share, (valid(n, 3, s) / (3 * o)) ** 2)
    n_last = critic_convs(cfg)[-1][2] // 2
    linear = 2 * 8 * cfg.filters * n_last * n_last * 100 + 2 * 100
    return every, val, outs, share, linear


@pytest.fixture(scope="module")
def jax_and_port():
    """Both censuses of the tiny config at B=8 over 10 reference steps."""
    from downgan_tpu.config.config import Config as JConfig
    from downgan_tpu.training.state import create_state, make_models
    from downgan_tpu.utils.flops import train_flop_census as jax_census

    cfg = _config(TINY)
    jcfg = JConfig.from_json(cfg.to_json())
    gen, critic = make_models(jcfg)
    state = jax.eval_shape(lambda: create_state(jcfg, jax.random.PRNGKey(0)))
    return cfg, jax_census(jcfg, gen, critic, state, 10), train_flop_census(cfg, 10)


def test_generator_piece_is_the_hand_conv_sum():
    """fake_gen counts every tap of every conv once, the DRBs' included
    (through the plain twin's nine shifted products a stage), exactly; the
    florida generator is 1.0351e9 FLOPs a sample."""
    for shape, batch in ((TINY, 8), (dict(), 2)):
        cfg = _config(shape, batch=batch)
        got = train_flop_census(cfg, 1)["pieces"]["fake_gen"]
        want = batch * sum(2 * cin * cout * 9 * n * n for cin, cout, n in generator_convs(cfg))
        assert got == want
    assert want / 2 == 1_035_067_392


def test_meta_census_equals_the_cpu_at_batch_one_scaled():
    """The meta-device census (shapes only) equals the CPU's real runs at
    batch 1, scaled by each piece's batch, exactly."""
    cfg = _config(TINY, "fused", batch=4, grad_accum=2)
    assert train_flop_census(cfg, 3) == train_flop_census(cfg, 3, device="cpu")


def test_gp_double_backward_costs_six_convs_a_layer():
    """The gradient penalty's parameter gradient through L stacked 3x3
    convs costs 6L - 1 convolutions' FLOPs in PyTorch (the forward, the
    input gradient, and four in the double backward, three for the last
    layer), where XLA's is 4L - 1."""
    import torch.nn.functional as F

    for layers in (1, 2, 3):
        ws = [torch.randn(8, 8, 3, 3, device="meta", requires_grad=True) for _ in range(layers)]
        x = torch.randn(1, 8, 32, 32, device="meta", requires_grad=True)
        with FlopCount() as counter:
            h = x
            for w in ws:
                h = F.leaky_relu(F.conv2d(h, w, padding=1), 0.2)
            (g,) = torch.autograd.grad(h.sum(), x, create_graph=True)
            torch.autograd.grad(g.square().sum(), ws)
        assert counter.total == (6 * layers - 1) * 2 * 8 * 8 * 9 * 32 * 32


def test_fake_gen_against_jax_within_the_padding_and_elementwise(jax_and_port):
    cfg, jc, pc = jax_and_port
    convs = generator_convs(cfg)
    b = cfg.hp.batch_size
    val = b * sum(2 * cin * cout * valid(n) ** 2 for cin, cout, n in convs)
    outs = b * sum(cout * n * n for _, cout, n in convs)
    assert val <= jc["pieces"]["fake_gen"] <= val + 5 * outs
    assert pc["pieces"]["fake_gen"] == b * sum(2 * cin * cout * 9 * n * n
                                               for cin, cout, n in convs)


def test_metrics_against_jax_within_the_padding_and_elementwise(jax_and_port):
    """MAE, MSE and Wass: two critic forwards at B and the two field
    metrics, elementwise."""
    cfg, jc, pc = jax_and_port
    b = cfg.hp.batch_size
    every, val, outs, _, linear = critic_counts(cfg)
    fields = b * cfg.n_predictands * cfg.fine_size ** 2
    assert pc["pieces"]["metrics"] == 2 * b * (every + linear)
    lo = 2 * b * (val + linear)
    assert lo <= jc["pieces"]["metrics"] <= lo + 2 * b * 5 * outs + 2 * 3 * fields


def test_update_pieces_against_jax_within_the_padding(jax_and_port):
    """gen_vag: the convs of the generator's and the critic's forward and
    backward, each XLA count at least v_min of the port's and at most it
    plus 5 elementwise FLOPs an output element a pass (three passes).
    critic_vag: the same once the GP's two extra convolutions a critic
    layer are taken off the port's count."""
    cfg, jc, pc = jax_and_port
    b = cfg.hp.batch_size
    every, _, c_outs, c_share, _ = critic_counts(cfg)
    g_convs = generator_convs(cfg)
    g_share = min((valid(n) / (3 * n)) ** 2 for _, _, n in g_convs)
    g_outs = sum(cout * n * n for _, cout, n in g_convs)
    v_min = min(g_share, c_share)
    port_g = pc["pieces"]["gen_vag_microbatch"]
    assert v_min * port_g <= jc["pieces"]["gen_vag_microbatch"] \
        <= port_g + 3 * 5 * b * (g_outs + c_outs)
    port_c = pc["pieces"]["critic_vag_microbatch"]
    gp_extra = 2 * b * every
    assert v_min * (port_c - gp_extra) <= jc["pieces"]["critic_vag_microbatch"] \
        <= port_c - gp_extra + 3 * 5 * 3 * b * c_outs


def test_census_pieces_positive_and_batch_scaling():
    c8, c16 = _census("reference", batch=8), _census("reference", batch=16)
    for name, v in c8["pieces"].items():
        assert v > 0, name
    # every piece is linear in the batch: doubling it doubles each exactly
    assert c16["flops_per_step"] == 2 * c8["flops_per_step"]


def test_census_reference_schedule_multiplicity():
    """Over K steps from step 0: K critic updates + K metric passes +
    ceil(K / n_critic) generator updates."""
    c = _census("reference", scan_steps=10)  # n_critic 5 -> 2 generator updates
    p = c["pieces"]
    assert c["total_flops"] == (10 * (p["fake_gen"] + p["critic_vag_microbatch"])
                                + 10 * (p["fake_gen"] + p["metrics"])
                                + 2 * p["gen_vag_microbatch"])
    # metrics_reuse_fake drops the metric pass's generator forward
    c2 = _census("reference", scan_steps=10, metrics_reuse_fake=True)
    assert c2["total_flops"] == c["total_flops"] - 10 * p["fake_gen"]
    # a window from step 3: steps 3..12 hold the updates of steps 5 and 10
    c3 = train_flop_census(_config(), 10, start_step=3)
    assert c3["total_flops"] == c["total_flops"]
    c4 = train_flop_census(_config(), 3, start_step=1)
    assert c4["total_flops"] == 3 * (2 * p["fake_gen"] + p["critic_vag_microbatch"]
                                     + p["metrics"])


def test_census_fused_round_is_n_critic_steps_of_critic_work():
    ref = _census("reference", scan_steps=10)
    fused = _census("fused", scan_steps=10)
    p = fused["pieces"]
    per_round = (5 * (p["fake_gen"] + p["critic_vag_microbatch"]) + p["gen_vag_microbatch"]
                 + p["fake_gen"] + p["metrics"])
    assert fused["flops_per_step"] == per_round
    assert fused["flops_per_step"] > 2 * ref["flops_per_step"]
    reuse = _census("fused", scan_steps=10, metrics_reuse_fake=True)
    assert reuse["flops_per_step"] == per_round - p["fake_gen"]


def test_census_grad_accum_splits_microbatches():
    """grad_accum = k counts the update pieces at B/k, k times: the same
    total as the whole batch (every counted op is linear in the batch)."""
    c1 = _census("reference", batch=8)
    c2 = _census("reference", batch=8, grad_accum=2)
    assert c2["pieces"]["critic_vag_microbatch"] * 2 == c1["pieces"]["critic_vag_microbatch"]
    assert c2["flops_per_step"] == c1["flops_per_step"]


def test_census_missing_piece_returns_zeros(monkeypatch):
    """A census that counts nothing for a piece it needs returns zeros, as
    the JAX census does (its pieces still reported)."""
    import downgan_tpu_torch.utils.flops as flops

    real = flops.count_flops
    calls = []

    def zero_second(fn):
        calls.append(fn)
        return 0 if len(calls) == 2 else real(fn)

    monkeypatch.setattr(flops, "count_flops", zero_second)
    c = flops.train_flop_census(_config(), 5)
    assert c["total_flops"] == 0.0 and c["flops_per_step"] == 0.0
    assert c["pieces"]["critic_vag_microbatch"] == 0.0 and c["pieces"]["fake_gen"] > 0


def test_census_refuses_other_devices():
    with pytest.raises(ValueError, match="'meta' or 'cpu'"):
        train_flop_census(_config(), 1, device="cuda")
    assert np.isfinite(train_flop_census(_config(), 1)["flops_per_step"])
