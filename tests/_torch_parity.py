"""Shared pieces of the port's parity tests (tests/test_torch_*.py): the
same generator weights on both sides, made by numpy."""
import numpy as np

from downgan_tpu.training.state import make_models
from downgan_tpu.utils.port_weights import port_generator
from downgan_tpu_torch.training.state import make_generator


def flax_generator(jcfg, cfg, seed=0):
    """The flax Generator of the JAX config ``jcfg`` and its variables, with
    torch-default-init values drawn by numpy and laid out by the JAX
    package's own ``port_generator`` (no flax init to compile). ``cfg`` is
    the port's config of the same model."""
    gen, _ = make_models(jcfg)
    shapes = {k: tuple(v.shape) for k, v in make_generator(cfg, "cpu").state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        bound = 1.0 / np.sqrt(np.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:]))
        sd[k] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return gen, port_generator(sd, num_res_blocks=jcfg.num_res_blocks,
                               num_upsample=jcfg.num_upsample)


def flax_critic(jcfg, seed=0, conv_gain=1.0):
    """The flax Critic of ``jcfg`` and its variables, with torch-default-init
    values drawn by numpy in the reference (torch) layout and laid out by
    the JAX package's own ``port_critic``; also that torch-layout dict.
    ``conv_gain`` scales the conv weights: at the default init the signal
    shrinks ~6x in variance per conv, and the scores hardly depend on x."""
    from downgan_tpu.utils.port_weights import port_critic
    from downgan_tpu_torch.models.critic import Critic

    _, critic = make_models(jcfg)
    shapes = {k: tuple(v.shape) for k, v in Critic(
        base=jcfg.filters, fine_size=jcfg.fine_size,
        in_channels=jcfg.n_predictands).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        bound = 1.0 / np.sqrt(np.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:]))
        gain = conv_gain if k.startswith("features") and k.endswith("weight") else 1.0
        sd[k] = (gain * rng.uniform(-bound, bound, shape)).astype(np.float32)
    return critic, port_critic(sd, base=jcfg.filters, fine_size=jcfg.fine_size), sd
