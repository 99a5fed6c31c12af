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
