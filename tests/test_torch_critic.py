"""The port's critic against the JAX package's flax Critic: forward on
carried-over random weights (so a wrong fc1 flatten order fails), the
florida parameter count, the weight mapping against ``export_critic`` and
its ``strict=True`` load, and seeded initialisation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.utils.port_weights import export_critic  # noqa: E402

from downgan_tpu_torch.config.config import Config  # noqa: E402
from downgan_tpu_torch.models.critic import Critic  # noqa: E402
from downgan_tpu_torch.training.state import make_critic, make_generator  # noqa: E402
from downgan_tpu_torch.utils.port_weights import critic_state_dict_from_flax  # noqa: E402

from _torch_parity import flax_critic, one_thread  # noqa: E402,F401

# fp32 on both sides; each score sums 4,096 fc1 products of conv outputs
# summed in another order.
ATOL, RTOL = 2e-5, 1e-5
KW = dict(filters=8, coarse_size=16, fine_size=128, num_res_blocks=1)


@pytest.fixture(scope="module")
def carried():
    jcfg = JaxConfig(**KW)
    critic, variables, sd = flax_critic(jcfg, seed=5, conv_gain=2.5)
    x = np.random.default_rng(6).standard_normal((3, 128, 128, 2)).astype(np.float32)
    want = np.asarray(jax.jit(critic.apply)(variables, jnp.asarray(x)))
    return variables, sd, x, want


def port_scores(state_dict, x_nhwc):
    critic = Critic(base=8, fine_size=128)
    critic.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return critic(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous()).numpy()


def test_forward_matches_flax_critic_on_random_weights(carried):
    variables, _, x, want = carried
    got = port_scores(critic_state_dict_from_flax(variables, base=8, fine_size=128), x)
    assert got.shape == want.shape == (3, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_fc1_rows_in_flax_order_do_not_match(carried):
    """The fc1 weights are random, so leaving its rows in flax's NHWC
    flatten order gives other scores: the parity above can see the order."""
    variables, _, x, want = carried
    sd = critic_state_dict_from_flax(variables, base=8, fine_size=128)
    sd["classifier.0.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(variables["params"]["fc1"]["kernel"]).T))
    assert np.abs(port_scores(sd, x) - want).max() > 1e3 * ATOL


def test_mapping_equals_export_critic_and_loads_strict(carried):
    variables, sd_numpy, x, want = carried
    exported = export_critic(variables, base=8, fine_size=128)
    ours = critic_state_dict_from_flax(variables, base=8, fine_size=128)
    assert set(exported) == set(ours) == set(Critic(base=8, fine_size=128).state_dict())
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(sd_numpy[k], v, err_msg=k)  # port_critic round trip
    got = port_scores({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()}, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_florida_param_count_and_bias_layout():
    with open("examples/florida.json") as f:
        config = Config.from_json(f.read())
    critic = make_critic(config, "cpu")
    assert sum(p.numel() for p in critic.parameters()) == 1_112_313
    biased = sorted(k for k in critic.state_dict() if k.endswith(".bias"))
    assert biased == ["classifier.0.bias", "classifier.2.bias", "features.0.bias"]
    assert critic.classifier[0].in_features == 8 * 16 * 8 * 8


def test_seeded_init_draws_torch_default_bounds_and_own_stream():
    config = Config(**KW)
    a, b = make_critic(config, "cpu"), make_critic(config, "cpu")
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        fan_in = a.state_dict()[k.rsplit(".", 1)[0] + ".weight"][0].numel()
        assert p.abs().max() <= 1 / fan_in ** 0.5
        assert p.abs().max() > 0.5 / fan_in ** 0.5
    # The critic's stream is not the generator's: its first conv differs
    # from the one drawn by the generator's seed for the same shape.
    gen = make_generator(config, "cpu")
    assert not torch.equal(a.features[0].bias, gen.conv1.bias[:8])
