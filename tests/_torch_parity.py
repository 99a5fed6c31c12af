"""Shared pieces of the port's tests (tests/test_torch_*.py): the
``one_thread`` fixture, and the same generator weights on both sides of a
parity test, made by numpy. JAX is imported inside the functions that need
it, so the card's ``-m cuda`` legs, which run without JAX, import this file
too."""
import numpy as np
import pytest
import torch

from downgan_tpu_torch.training.state import make_generator


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests (a module takes it by
    importing this fixture). The suite runs test files in parallel worker
    processes, and torch's default of one thread per core in each of them
    oversubscribes the cores many times over. It also fixes the order of
    torch's CPU reductions, which depends on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_generator(jcfg, cfg, seed=0):
    """The flax Generator of the JAX config ``jcfg`` and its variables, with
    torch-default-init values drawn by numpy and laid out by the JAX
    package's own ``port_generator`` (no flax init to compile). ``cfg`` is
    the port's config of the same model."""
    from downgan_tpu.training.state import make_models
    from downgan_tpu.utils.port_weights import port_generator

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
    from downgan_tpu.training.state import make_models
    from downgan_tpu.utils.port_weights import port_critic
    from downgan_tpu_torch.models.critic import Critic

    _, critic = make_models(jcfg)
    shapes = {k: tuple(v.shape) for k, v in Critic(
        base=jcfg.filters, fine_size=jcfg.fine_size,
        in_channels=jcfg.critic_in_channels).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        bound = 1.0 / np.sqrt(np.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:]))
        gain = conv_gain if k.startswith("features") and k.endswith("weight") else 1.0
        sd[k] = (gain * rng.uniform(-bound, bound, shape)).astype(np.float32)
    return critic, port_critic(sd, base=jcfg.filters, fine_size=jcfg.fine_size), sd


def paired_states(jcfg, cfg):
    """The JAX and the port train state of one model at step 0 from the same
    numpy weights (generator seed 0, critic seed 1; the critic takes
    ``critic_in_channels`` inputs), with the flax modules:
    ``(jgen, jcritic, jstate, state)``."""
    import jax
    import jax.numpy as jnp

    from downgan_tpu.training.state import GANTrainState
    from downgan_tpu.training.state import make_optimizer as jax_make_optimizer
    from downgan_tpu_torch.training.state import make_train_state

    jgen, g_params = flax_generator(jcfg, cfg, seed=0)
    jcritic, c_params, _ = flax_critic(jcfg, seed=1)
    tx = jax_make_optimizer(jcfg)
    jstate = GANTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, c_params=c_params,
                           g_opt_state=tx.init(g_params), c_opt_state=tx.init(c_params),
                           g_ema=jax.tree.map(jnp.copy, g_params) if jcfg.hp.ema_decay else None)
    state = make_train_state(cfg, "cpu")
    gen_sd, critic_sd = port_weights_of(cfg, g_params, c_params)
    state.generator.load_state_dict(gen_sd)
    state.critic.load_state_dict(critic_sd)
    if state.g_ema is not None:
        state.g_ema.load_state_dict(gen_sd)
    return jgen, jcritic, jstate, state


def port_weights_of(cfg, jax_g_params, jax_c_params):
    """The port's (generator, critic) state dicts of flax variables."""
    import jax

    from downgan_tpu_torch.utils.port_weights import (
        critic_state_dict_from_flax,
        generator_state_dict_from_flax,
    )

    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (generator_state_dict_from_flax(host(jax_g_params), num_res_blocks=cfg.num_res_blocks,
                                           num_upsample=cfg.num_upsample),
            critic_state_dict_from_flax(host(jax_c_params), base=cfg.filters,
                                        fine_size=cfg.fine_size))


def jax_alpha(rng, step, b):
    """The JAX step's GP alpha at ``step``: uniform(fold_in(rng, step))."""
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.uniform(jax.random.fold_in(rng, step), (b, 1, 1, 1), jnp.float32))


def jax_flips(rng, step, b):
    """The JAX step's flip masks at ``step`` as the port takes them, (lon,
    lat) bool (b,): bernoulli(0.5) of the two halves of
    fold_in(fold_in(rng, step), 1) (``ops/augment.py::random_flip_pair``)."""
    import jax

    keys = jax.random.split(jax.random.fold_in(jax.random.fold_in(rng, step), 1))
    return tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (b, 1, 1, 1))).reshape(b))
                 for k in keys)
