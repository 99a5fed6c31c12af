"""The port's generator against the JAX package's flax Generator: parameter
count, state-dict keys and mapping, forward on carried-over weights, pixel
shuffle order and seeded initialisation (the stochastic RRDB and the SRResNet:
tests/test_torch_stochastic.py, tests/test_torch_srresnet.py)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.models.layers import pixel_shuffle as jax_pixel_shuffle  # noqa: E402
from downgan_tpu.utils.port_weights import export_generator  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.training.state import load_generator, make_generator  # noqa: E402
from downgan_tpu_torch.utils.port_weights import generator_state_dict_from_flax  # noqa: E402

from _torch_parity import flax_generator, one_thread  # noqa: E402,F401

# The tolerance of the reference-parity tests (tests/test_import_torch.py).
ATOL, RTOL = 2e-5, 1e-5


def tiny(num_res_blocks):
    kw = dict(coarse_size=8, fine_size=64, filters=8, num_res_blocks=num_res_blocks)
    return JaxConfig(**kw), Config(**kw)


def test_florida_param_count():
    with open("examples/florida.json") as f:
        config = Config.from_json(f.read())
    gen = make_generator(config, "cpu")
    assert sum(p.numel() for p in gen.parameters()) == 1_696_514


def test_florida_json_loads_equal_in_both_packages():
    with open("examples/florida.json") as f:
        text = f.read()
    ours, theirs = Config.from_json(text), JaxConfig.from_json(text)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())
    assert ours.num_upsample == theirs.num_upsample == 3
    with pytest.raises(ValueError, match="power of two"):
        Config(coarse_size=128, fine_size=192).num_upsample


@pytest.mark.parametrize("num_res_blocks", [1, 2])
def test_state_dict_keys_and_mapping_match_export_generator(num_res_blocks):
    jcfg, cfg = tiny(num_res_blocks)
    _, params = flax_generator(jcfg, cfg)
    exported = export_generator(params, num_res_blocks=num_res_blocks, num_upsample=3)
    ours = generator_state_dict_from_flax(params, num_res_blocks=num_res_blocks, num_upsample=3)
    gen = make_generator(cfg, "cpu")
    assert set(gen.state_dict()) == set(exported) == set(ours)
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    gen.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("num_res_blocks,batch", [(1, 1), (1, 3), (2, 2)])
def test_forward_matches_flax(num_res_blocks, batch):
    jcfg, cfg = tiny(num_res_blocks)
    flax_gen, params = flax_generator(jcfg, cfg, seed=num_res_blocks)
    x = np.random.default_rng(batch).standard_normal((batch, 8, 8, 7)).astype(np.float32)
    want = np.asarray(jax.jit(flax_gen.apply)(params, jnp.asarray(x)))
    gen = load_generator(cfg, generator_state_dict_from_flax(params, num_res_blocks, 3), "cpu")
    with torch.inference_mode():
        got = gen(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (batch, 64, 64, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_pixel_shuffle_order_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 16)).astype(np.float32)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2))
    got = torch.nn.PixelShuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_seeded_init_is_reproducible_and_torch_default():
    _, cfg = tiny(1)
    a, b = make_generator(cfg, "cpu"), make_generator(cfg, "cpu")
    c = make_generator(cfg, "cpu", rng=torch.Generator().manual_seed(7))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        assert not torch.equal(pa, pc), name
    for m in a.modules():
        if isinstance(m, torch.nn.Conv2d):
            bound = 1.0 / m.weight[0].numel() ** 0.5
            assert m.weight.abs().max() <= bound and m.bias.abs().max() <= bound
            assert m.weight.abs().max() > 0.9 * bound


def test_hyperparams_validation_is_kept():
    with pytest.raises(ValueError):
        HyperParams(schedule="bogus")
    assert JaxHyperParams().effective_gp_weight == HyperParams().effective_gp_weight == 100
