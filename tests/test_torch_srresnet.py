"""The port's SRResNet generator against the JAX package's
``SRResNetGenerator``: the flax -> torch weight mapping, the forward in fp32
(deterministic and stochastic) and in bf16, the per-sample norm's biased
variance, PReLU at 0 and its dtype, the florida parameter count, and the
``train --generator-arch srresnet`` -> ``export`` -> ``serve`` path on the
CPU.

Tiny model: filters 8, 1-2 residual blocks, 8 -> 32. Flax weights are made
by numpy in the port's layout and laid into the flax tree by hand here (no
flax ``init`` to compile)."""
import copy
import json
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.models.generator import BatchNorm as JaxBatchNorm  # noqa: E402
from downgan_tpu.models.generator import PReLU as JaxPReLU  # noqa: E402
from downgan_tpu.training.state import make_models  # noqa: E402

from downgan_tpu_torch.cli.__main__ import _resolve_source, build_parser, main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.models.generator import InstanceNorm, PReLU, SRResNetGenerator  # noqa: E402
from downgan_tpu_torch.serving import SRModel, generate_remote, serve_model  # noqa: E402
from downgan_tpu_torch.training.state import load_generator, make_generator  # noqa: E402
from downgan_tpu_torch.utils.port_weights import (  # noqa: E402
    load_generator_weights,
    srresnet_state_dict_from_flax,
)

from _torch_parity import one_thread  # noqa: E402,F401

KW = dict(generator_arch="srresnet", filters=8, coarse_size=8, fine_size=32)
# fp32 on both sides, convs (9x9: 648 terms a sum) summed in another order.
ATOL, RTOL = 2e-5, 1e-5
# bf16: the port's output may be at most 1.25x as far from a float64
# evaluation as the JAX package's own bf16 output, relative to the largest
# output (the rule tests/test_torch_drb.py holds the bf16 DRB gradients to);
# the two round their bf16 statistics and convolutions in another order.
BF16_VS_REFERENCE_ERROR = 1.25


def configs(num_res_blocks=1, noise_channels=0, compute_dtype="float32"):
    kw = dict(KW, num_res_blocks=num_res_blocks, noise_channels=noise_channels)
    hp = dict(batch_size=2, compute_dtype=compute_dtype)
    return JaxConfig(hp=JaxHyperParams(**hp), **kw), Config(hp=HyperParams(**hp), **kw)


def weights(cfg, seed):
    """Port-layout numpy weights (convs at torch's default-init bound, PReLU
    slopes and the norm's scale and shift drawn away from their initial
    values so the mapping shows) and the same values as a flax tree."""
    shapes = {k: tuple(v.shape) for k, v in make_generator(cfg, "cpu").state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in shapes.items():
        if "prelu" in k:
            lo, hi = 0.05, 0.45
        elif k.startswith("bn2"):
            lo, hi = (0.5, 1.5) if k.endswith("weight") else (-0.3, 0.3)
        else:
            lo = -1.0 / np.sqrt(np.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:]))
            hi = -lo
        sd[k] = rng.uniform(lo, hi, shape).astype(np.float32)
    hwio = lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # noqa: E731
    conv3 = lambda name: {"Conv_0": {"kernel": hwio(sd[f"{name}.weight"])}}  # noqa: E731
    alpha = lambda name: {"alpha": sd[f"{name}.weight"]}  # noqa: E731
    p = {"conv1": {"kernel": hwio(sd["conv1.weight"]), "bias": sd["conv1.bias"]},
         "prelu1": alpha("prelu1"), "conv2": conv3("conv2"),
         "bn2": {"scale": sd["bn2.weight"], "bias": sd["bn2.bias"]},
         "conv3": {"kernel": hwio(sd["conv3.weight"]), "bias": sd["conv3.bias"]}}
    for i in range(cfg.num_res_blocks):
        p[f"res{i}"] = {"conv1": conv3(f"res_blocks.{i}.conv1"),
                        "prelu": alpha(f"res_blocks.{i}.prelu"),
                        "conv2": conv3(f"res_blocks.{i}.conv2")}
    for u in range(cfg.num_upsample):
        p[f"up{u}"], p[f"up_prelu{u}"] = conv3(f"up{u}"), alpha(f"up_prelu{u}")
    return sd, {"params": p}


def jax_forward(jcfg, params, x):
    gen, _ = make_models(jcfg)
    return np.asarray(jax.jit(gen.apply)(params, jnp.asarray(x)))


def port_forward(gen, x):
    with torch.no_grad():
        return gen(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def inputs(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, 8, 8, cfg.generator_in_channels)).astype(np.float32)


@pytest.mark.parametrize("num_res_blocks,noise_channels", [(1, 0), (2, 0), (1, 2)],
                         ids=["1_block", "2_blocks", "stochastic"])
def test_forward_and_mapping_match_flax(num_res_blocks, noise_channels):
    jcfg, cfg = configs(num_res_blocks, noise_channels)
    sd, params = weights(cfg, seed=num_res_blocks + noise_channels)
    mapped = srresnet_state_dict_from_flax(params, num_res_blocks=num_res_blocks,
                                           num_upsample=cfg.num_upsample)
    assert set(mapped) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(mapped[k].numpy(), v, err_msg=k)
    gen = load_generator(cfg, mapped, "cpu")
    assert isinstance(gen, SRResNetGenerator)
    x = inputs(cfg, 3, seed=0)
    got = port_forward(gen, x)
    assert got.shape == (3, 32, 32, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_forward(jcfg, params, x), atol=ATOL, rtol=RTOL)


def float64_forward(gen, x):
    """``gen`` evaluated in float64 throughout."""
    ref = copy.deepcopy(gen).double()
    for m in ref.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    with torch.no_grad():
        out1 = ref.prelu1(ref.conv1(torch.from_numpy(x).double().permute(0, 3, 1, 2)))
        out = out1 + ref.bn2(ref.conv2(ref.res_blocks(out1)))
        for i in range(ref.num_upsample):
            out = getattr(ref, f"up_prelu{i}")(ref.shuffle(getattr(ref, f"up{i}")(out)))
        return ref.conv3(out).permute(0, 2, 3, 1).numpy()


def test_bf16_forward_is_as_close_to_float64_as_jax_bf16():
    jcfg, cfg = configs(2, compute_dtype="bfloat16")
    sd, params = weights(cfg, seed=7)
    gen = load_generator(cfg, srresnet_state_dict_from_flax(params, 2, cfg.num_upsample), "cpu")
    x = inputs(cfg, 4, seed=1)
    want = float64_forward(gen, x)
    scale = np.abs(want).max()
    jax_err = np.abs(jax_forward(jcfg, params, x) - want).max() / scale
    got = port_forward(gen, x)
    port_err = np.abs(got - want).max() / scale
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert 1e-4 < jax_err < 0.1  # bf16 rounding shows, and nothing worse
    assert port_err <= BF16_VS_REFERENCE_ERROR * jax_err, (port_err, jax_err)


def test_norm_is_per_sample_with_biased_variance():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 5, 6)) * [[[[1.0]], [[3.0]], [[0.2]]]] + 2.0).astype(
        np.float32)
    norm = InstanceNorm(3)
    with torch.no_grad():
        norm.weight.copy_(torch.tensor([1.5, 0.5, 1.0]))
        norm.bias.copy_(torch.tensor([0.1, -0.2, 0.0]))
        got = norm(torch.from_numpy(x)).numpy()
        alone = norm(torch.from_numpy(x[1:])).numpy()
    mean = x.mean(axis=(2, 3), keepdims=True)
    w, b = np.array([1.5, 0.5, 1.0])[:, None, None], np.array([0.1, -0.2, 0.0])[:, None, None]
    biased = (x - mean) / np.sqrt(x.var(axis=(2, 3), keepdims=True, ddof=0) + 1e-5) * w + b
    unbiased = (x - mean) / np.sqrt(x.var(axis=(2, 3), keepdims=True, ddof=1) + 1e-5) * w + b
    np.testing.assert_allclose(got, biased, atol=1e-5)
    assert np.abs(got - unbiased).max() > 1e-2  # the ddof shows at 30 points a channel
    np.testing.assert_array_equal(alone, got[1:])  # no batch statistics
    flax_params = {"params": {"scale": np.array([1.5, 0.5, 1.0], np.float32),
                              "bias": np.array([0.1, -0.2, 0.0], np.float32)}}
    want = np.asarray(JaxBatchNorm().apply(flax_params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5)


def test_prelu_at_zero_and_its_dtype():
    x = np.array([-2.0, -1e-30, 0.0, 1e-30, 3.0], np.float32)
    prelu = PReLU()
    assert prelu.weight.shape == (1,) and prelu.weight.item() == 0.25
    with torch.no_grad():
        got = prelu(torch.from_numpy(x)).numpy()
        got_bf16 = prelu(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(got, np.float32([-0.5, -0.25e-30, 0.0, 1e-30, 3.0]))
    alpha = {"params": {"alpha": np.array([0.25], np.float32)}}
    np.testing.assert_array_equal(got, np.asarray(JaxPReLU().apply(alpha, jnp.asarray(x))))
    want_bf16 = JaxPReLU().apply(alpha, jnp.asarray(x, jnp.bfloat16))
    assert got_bf16.dtype == torch.float32 and want_bf16.dtype == jnp.float32


def test_florida_param_count_and_keys():
    with open("examples/florida.json") as f:
        florida = Config.from_json(f.read())
    gen = make_generator(florida.replace(generator_arch="srresnet"), "cpu")
    assert sum(p.numel() for p in gen.parameters()) == 115_414
    keys = set(gen.state_dict())
    assert {"conv1.weight", "conv1.bias", "prelu1.weight", "res_blocks.15.prelu.weight",
            "conv2.weight", "bn2.weight", "bn2.bias", "up2.weight", "up_prelu2.weight",
            "conv3.weight", "conv3.bias"} <= keys
    assert "conv2.bias" not in keys and "res_blocks.0.conv1.bias" not in keys


def test_cli_train_export_and_serve_srresnet(tmp_path, capsys):
    """``train --generator-arch srresnet`` on the CPU; ``export`` of its
    checkpoint; the bundle restored as ``serve --checkpoint`` restores it
    and served over HTTP; an RRDB config refuses its weights."""
    cfg = Config(hp=HyperParams(batch_size=2, metrics_to_calculate=("MAE", "MSE", "Wass")),
                 **{**KW, "generator_arch": "rrdb", "num_res_blocks": 1})
    config_file = tmp_path / "tiny.json"
    config_file.write_text(cfg.to_json())
    trainer = main(["train", "--config", str(config_file), "--synthetic", "--samples", "6",
                    "--epochs", "1", "--device", "cpu", "--generator-arch", "srresnet",
                    "--checkpoint-dir", str(tmp_path / "ck"),
                    "--tracking-root", str(tmp_path / "exps")])
    assert isinstance(trainer.state.generator, SRResNetGenerator)
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert all(np.isfinite(v) for part in ("train", "test") for v in line[part].values())
    run_ckpt = str(tmp_path / "ck")
    (tmp_path / "config.json").write_text(trainer.config.to_json())  # beside the checkpoints
    bundle = main(["export", "--checkpoint", run_ckpt, "--out", str(tmp_path / "bundle")])
    parser = build_parser()
    config, served_weights = _resolve_source(parser.parse_args(
        ["serve", "--checkpoint", bundle, "--device", "cpu"]), parser)
    assert config.generator_arch == "srresnet"
    trained = trainer.state.generator.state_dict()
    assert all(torch.equal(served_weights[k], v) for k, v in trained.items())
    model = SRModel(config, served_weights, batch_size=2, device="cpu")
    server = serve_model(model, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
        x = inputs(config, 3, seed=4)
        fields = generate_remote(url, x)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert health["generator_arch"] == "srresnet"
    np.testing.assert_array_equal(fields, model.generate(x))
    # the trained module at another batch size: convs summed in another order
    np.testing.assert_allclose(fields, port_forward(trainer.state.generator.eval(), x),
                               atol=ATOL, rtol=RTOL)
    sd = load_generator_weights(f"{bundle}/generator.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_generator(cfg, sd, "cpu")
