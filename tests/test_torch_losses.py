"""The port's losses, metrics and gradient penalty against the JAX
package's on the same numpy inputs and weights: MAE/MSE, MS-SSIM at
128x128 (with a constant channel, where the metric's guard keeps it
defined), the odd-size pooling between scales, the registry's refusals,
and the GP's value and critic-parameter gradients against ``jax.grad``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.ops import losses as jax_losses  # noqa: E402
from downgan_tpu.ops import msssim as jax_msssim  # noqa: E402
from downgan_tpu.training.wgan import gradient_penalty as jax_gradient_penalty  # noqa: E402

from downgan_tpu_torch.models.critic import Critic  # noqa: E402
from downgan_tpu_torch.ops import losses, msssim  # noqa: E402
from downgan_tpu_torch.ops.metrics import resolve_metrics  # noqa: E402
from downgan_tpu_torch.training.wgan import gradient_penalty  # noqa: E402
from downgan_tpu_torch.utils.port_weights import critic_state_dict_from_flax  # noqa: E402

from _torch_parity import flax_critic, one_thread  # noqa: E402,F401

# fp32 on both sides, sums in another order. MS-SSIM is a product of five
# scale terms, each a mean of 10^2..10^4 ratios of blurred moments.
ATOL = 1e-5
MSSSIM_ATOL = 2e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def fields(seed, shape=(3, 128, 128, 2)):
    rng = np.random.default_rng(seed)
    real = rng.standard_normal(shape).astype(np.float32)
    fake = (0.6 * real + 0.8 * rng.standard_normal(shape)).astype(np.float32)
    return real, fake


@pytest.mark.parametrize("name", ["content_loss", "content_mse_loss"])
def test_mae_mse_match(name):
    real, fake = fields(0, (4, 32, 24, 2))
    want = float(getattr(jax_losses, name)(jnp.asarray(real), jnp.asarray(fake)))
    got = float(getattr(losses, name)(nchw(real), nchw(fake)))
    assert got == pytest.approx(want, rel=1e-6, abs=ATOL)
    assert float(losses.wass_loss(torch.tensor(0.75), torch.tensor(0.25))) == 0.5


@pytest.mark.parametrize("case", ["random", "constant_channel", "equal_constant_channels",
                                  "odd_batch_of_one"])
def test_msssim_matches_at_128(case):
    real, fake = fields(1)
    if case == "constant_channel":
        fake[..., 1] = 0.3  # span 0 in the fake's channel 1 only
    elif case == "equal_constant_channels":
        real[..., 0] = fake[..., 0] = -1.5
    elif case == "odd_batch_of_one":
        real, fake = real[:1], fake[:1]
    want = float(jax_msssim.msssim_metric(jnp.asarray(real), jnp.asarray(fake)))
    got = float(msssim.msssim_metric(nchw(real), nchw(fake)))
    assert np.isfinite(want) and np.isfinite(got)
    assert got == pytest.approx(want, abs=MSSSIM_ATOL)


def test_msssim_of_a_field_with_itself_is_one_and_small_fields_raise():
    real, _ = fields(2)
    real[..., 1] = 4.0
    assert float(msssim.msssim_metric(nchw(real), nchw(real))) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="too small"):
        msssim.msssim_metric(torch.zeros(1, 2, 64, 64), torch.zeros(1, 2, 64, 64))


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (33, 16)])
def test_odd_size_pooling_matches(hw):
    x = np.random.default_rng(3).standard_normal((2, *hw, 2)).astype(np.float32)
    want = np.asarray(jax_msssim._downsample(jnp.asarray(x))).transpose(0, 3, 1, 2)
    got = msssim._downsample(nchw(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_resolve_metrics_refuses_unknown_and_unported():
    assert list(resolve_metrics(["MAE", "Wass", "MSSSIM"])) == ["MAE", "MSSSIM"]
    with pytest.raises(KeyError, match="unknown metrics"):
        resolve_metrics(["MAE", "PSNR"])
    # the physics and spectral metrics are in the registry now
    assert list(resolve_metrics(["Divergence", "Vorticity", "RALSD"])) == [
        "Divergence", "Vorticity", "RALSD"]


@pytest.mark.parametrize("conv_gain", [1.0, 2.5])
def test_gradient_penalty_value_and_critic_grads_match_jax(conv_gain):
    """Same weights, batch and alpha on both sides. The JAX side is the
    nested ``jax.grad`` of ``gradient_penalty``; the port's is
    ``autograd.grad(create_graph=True)`` then a second backward. Gradients
    are compared after the weight mapping (linear, so it carries gradients
    too), each within 1e-4 of its tensor's largest entry: a double
    backward in fp32 through eight convs, summed in another order."""
    jcfg = JaxConfig(filters=8, num_res_blocks=1)
    jcritic, variables, _ = flax_critic(jcfg, seed=7, conv_gain=conv_gain)
    real, fake = fields(4, (2, 128, 128, 2))
    alpha = np.random.default_rng(5).uniform(size=(2, 1, 1, 1)).astype(np.float32)

    def jgp(params):
        return jax_gradient_penalty(jcritic.apply, params, jnp.asarray(real), jnp.asarray(fake),
                                    jnp.asarray(alpha))

    want, jgrads = jax.jit(jax.value_and_grad(jgp))(variables)
    want_grads = critic_state_dict_from_flax(jax.tree.map(np.asarray, jgrads), base=8,
                                             fine_size=128)

    critic = Critic(base=8, fine_size=128)
    critic.load_state_dict(critic_state_dict_from_flax(variables, base=8, fine_size=128))
    gp = gradient_penalty(critic, nchw(real), nchw(fake),
                          torch.from_numpy(alpha.transpose(0, 3, 1, 2).copy()))
    names = [k for k, _ in critic.named_parameters()]
    # The input gradient does not depend on the last bias: no gradient there.
    grads = torch.autograd.grad(gp, list(critic.parameters()), allow_unused=True)
    assert float(gp.detach()) == pytest.approx(float(want), rel=1e-5)
    assert names[-1] == "classifier.2.bias" and grads[-1] is None
    assert not want_grads["classifier.2.bias"].any()
    for k, g in zip(names[:-1], grads[:-1]):
        w = want_grads[k]
        assert np.abs(g.numpy() - w.numpy()).max() <= 1e-4 * np.abs(w.numpy()).max(), k
