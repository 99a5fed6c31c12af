"""The port's reference-checkpoint migration (``cli import-torch``,
``cli export-torch``, ``utils/port_weights.py::infer_generator_arch`` and
``infer_critic_arch``) held against the JAX package's on the same files.

Reference state dicts are made by numpy from a seed in the reference
layout (which is the port's own: its networks use the reference keys).
Tolerance: the imported bundle's forward on the CPU against the forward of
the bundle the JAX package's ``import-torch`` writes from the same file,
2e-5 absolute and 1e-5 relative (the two packages' fp32 convolutions round
differently; the JAX import test holds its bundle to the reference net by
the same bound).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.inference import load_bundle, write_generator_bundle  # noqa: E402
from downgan_tpu_torch.models.critic import Critic  # noqa: E402
from downgan_tpu_torch.training.state import load_generator, make_generator  # noqa: E402
from downgan_tpu_torch.utils import port_weights  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

ATOL, RTOL = 2e-5, 1e-5
KW = dict(filters=8, num_res_blocks=2, coarse_size=8, fine_size=64)


def numpy_state_dict(shapes, seed):
    """Torch-default-init values by numpy in ``shapes``' layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        bound = 1.0 / np.sqrt(np.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:]))
        out[k] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return out


def reference_generator(num_res_blocks=2, seed=0):
    cfg = Config(**{**KW, "num_res_blocks": num_res_blocks})
    shapes = {k: tuple(v.shape) for k, v in make_generator(cfg, "cpu").state_dict().items()}
    return numpy_state_dict(shapes, seed)


def reference_critic(n_predictands=2, seed=1):
    shapes = {k: tuple(v.shape) for k, v in Critic(base=8, fine_size=64,
                                                     in_channels=n_predictands).state_dict().items()}
    return numpy_state_dict(shapes, seed)


def save_torch(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def jax_cli(args):
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli

    return CliRunner().invoke(cli, args, catch_exceptions=False)


def refusal(capsys, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    return capsys.readouterr().err


@pytest.mark.parametrize("blocks,ups", [(1, 3), (2, 3), (3, 2)])
def test_infer_generator_arch_equals_jax(blocks, ups):
    from downgan_tpu.utils.port_weights import infer_generator_arch

    sd = reference_generator(blocks)
    sd = {k: v for k, v in sd.items() if not k.startswith("upsampling.")
          or int(k.split(".")[1]) < 3 * ups}
    got = port_weights.infer_generator_arch(sd)
    assert got == infer_generator_arch(sd)
    assert got == {"filters": 8, "n_covariates": 7, "n_predictands": 2,
                   "num_res_blocks": blocks, "num_upsample": ups}
    # tensors in, the same answer
    assert port_weights.infer_generator_arch({k: torch.from_numpy(v)
                                              for k, v in sd.items()}) == got


def test_infer_arch_refusals_equal_jax():
    from downgan_tpu.utils.port_weights import infer_critic_arch, infer_generator_arch

    shifted = reference_generator(1)
    shifted["upsampling.1.weight"] = shifted.pop("upsampling.3.weight")
    no_blocks = {k: v for k, v in reference_generator(1).items()
                 if not k.startswith("res_blocks.")}
    bad_critic = reference_critic()
    bad_critic["classifier.0.weight"] = np.zeros((100, 8 * 8 * 5), np.float32)
    cases = [(infer_generator_arch, port_weights.infer_generator_arch, sd)
             for sd in ({"nope": np.zeros(1)}, shifted, no_blocks)]
    cases += [(infer_critic_arch, port_weights.infer_critic_arch, sd)
              for sd in ({"features.0.weight": np.zeros((8, 2, 3, 3))}, bad_critic)]
    for jax_fn, port_fn, sd in cases:
        with pytest.raises(ValueError) as want:
            jax_fn(sd)
        with pytest.raises(ValueError) as got:
            port_fn(sd)
        assert str(got.value) == str(want.value)


def test_infer_critic_arch_equals_jax():
    from downgan_tpu.utils.port_weights import infer_critic_arch

    sd = reference_critic(n_predictands=3)
    assert port_weights.infer_critic_arch(sd) == infer_critic_arch(sd) == {
        "filters": 8, "n_predictands": 3, "fine_size": 64}


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """One reference generator and critic, imported by both packages' CLIs."""
    d = tmp_path_factory.mktemp("import")
    g_sd, c_sd = reference_generator(2), reference_critic()
    g_pt, c_pt = save_torch(g_sd, d / "generator.pt"), save_torch(c_sd, d / "critic.pt")
    port = main(["import-torch", "--weights", g_pt, "--critic-weights", c_pt,
                 "--out", str(d / "port"), "--device", "cpu"])
    res = jax_cli(["import-torch", "--weights", g_pt, "--critic-weights", c_pt,
                   "--out", str(d / "jax")])
    assert res.exit_code == 0, res.output
    return g_sd, c_sd, port, str(d / "jax")


def test_import_torch_bundle_holds_the_file_bit_for_bit(imported):
    g_sd, c_sd, port, _ = imported
    config, g, c = load_bundle(port)
    assert g.keys() == g_sd.keys() and c.keys() == c_sd.keys()
    assert all(np.array_equal(g[k].numpy(), g_sd[k]) for k in g_sd)
    assert all(np.array_equal(c[k].numpy(), c_sd[k]) for k in c_sd)
    assert (config.filters, config.num_res_blocks, config.coarse_size, config.fine_size,
            config.n_covariates, config.generator_arch, config.noise_channels,
            config.critic_conditional) == (8, 2, 8, 64, 7, "rrdb", 0, False)


def test_import_torch_config_equals_jax(imported):
    _, _, port, jax_bundle = imported
    with open(f"{port}/config.json") as f, open(f"{jax_bundle}/config.json") as g:
        assert json.load(f) == json.load(g)


def test_import_torch_forward_matches_jax_bundle(imported):
    import jax.numpy as jnp

    from downgan_tpu.inference import load_bundle as jax_load_bundle
    from downgan_tpu.training.state import make_models

    _, _, port, jax_bundle = imported
    config, g, _ = load_bundle(port)
    jconfig, jparams, jcritic = jax_load_bundle(jax_bundle)
    assert jcritic is not None
    x = np.random.default_rng(3).standard_normal((3, 8, 8, 7)).astype(np.float32)
    want = np.asarray(make_models(jconfig)[0].apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = load_generator(config, g, "cpu")(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=RTOL)


def test_import_torch_prints_jax_summary(tmp_path, capsys):
    g_pt = save_torch(reference_generator(1), tmp_path / "g.pt")
    main(["import-torch", "--weights", g_pt, "--out", str(tmp_path / "b"), "--device", "cpu"])
    out = capsys.readouterr().out
    res = jax_cli(["import-torch", "--weights", g_pt, "--out", str(tmp_path / "j")])
    assert out.replace(str(tmp_path / "b"), "OUT") == \
        res.output.replace(str(tmp_path / "j"), "OUT")
    # without a critic the coarse size comes from the config's fine size (128)
    assert load_bundle(str(tmp_path / "b"))[0].coarse_size == 128 // 8


def test_import_torch_refuses_a_critic_of_other_channels(tmp_path, capsys):
    g_pt = save_torch(reference_generator(1), tmp_path / "g.pt")
    c_pt = save_torch(reference_critic(n_predictands=3), tmp_path / "c.pt")
    err = refusal(capsys, ["import-torch", "--weights", g_pt, "--critic-weights", c_pt,
                           "--out", str(tmp_path / "b"), "--device", "cpu"])
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli

    res = CliRunner().invoke(cli, ["import-torch", "--weights", g_pt, "--critic-weights", c_pt,
                                   "--out", str(tmp_path / "j")])
    want = "critic takes 3 channels but the generator predicts 2"
    assert res.exit_code == 2 and want in res.output and want in err


def test_import_torch_refuses_other_files(tmp_path, capsys):
    bad = save_torch(reference_critic(), tmp_path / "critic_as_generator.pt")
    err = refusal(capsys, ["import-torch", "--weights", bad, "--out", str(tmp_path / "b"),
                           "--device", "cpu"])
    assert "not a DoWnGAN Generator state_dict: missing key 'conv1.weight'" in err
    torch.save([1, 2, 3], tmp_path / "list.pt")
    err = refusal(capsys, ["import-torch", "--weights", str(tmp_path / "list.pt"), "--out",
                           str(tmp_path / "b"), "--device", "cpu"])
    assert "neither a state_dict nor a torch module" in err


def test_import_torch_reads_a_pickled_module(tmp_path):
    """What the reference's MLflow logged each epoch: the module itself."""
    cfg = Config(**{**KW, "num_res_blocks": 1})
    gen = make_generator(cfg, "cpu")
    torch.save(gen, tmp_path / "module.pth")
    out = main(["import-torch", "--weights", str(tmp_path / "module.pth"), "--out",
                str(tmp_path / "b"), "--device", "cpu"])
    _, g, _ = load_bundle(out)
    assert all(torch.equal(g[k], v) for k, v in gen.state_dict().items())


def test_import_torch_needs_a_card_by_default(tmp_path):
    g_pt = save_torch(reference_generator(1), tmp_path / "g.pt")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["import-torch", "--weights", g_pt, "--out", str(tmp_path / "b")])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A one-epoch tiny run with the EMA, checkpointed."""
    d = tmp_path_factory.mktemp("trained")
    cfg = Config(hp=HyperParams(batch_size=2, ema_decay=0.9,
                                metrics_to_calculate=("MAE", "MSE", "Wass")),
                 **{**KW, "num_res_blocks": 1})
    (d / "tiny.json").write_text(cfg.to_json())
    trainer = main(["train", "--config", str(d / "tiny.json"), "--synthetic", "--samples", "12",
                    "--epochs", "1", "--device", "cpu", "--tracking-root", str(d / "exps"),
                    "--plot-every", "1000"])
    return trainer, d


@pytest.mark.parametrize("ema", [False, True])
def test_export_torch_equals_the_export_bundle(trained, ema, tmp_path):
    """export-torch of a checkpoint writes the tensors the ``export``
    bundle's generator.pt holds (the live or the EMA generator)."""
    trainer, _ = trained
    ckpt = trainer.ckpt.directory
    flag = ["--ema"] if ema else []
    f = main(["export-torch", "--checkpoint", ckpt, *flag, "--out", str(tmp_path / "g.pt")])
    bundle = main(["export", "--checkpoint", ckpt, *flag, "--out", str(tmp_path / "bundle")])
    got = torch.load(f, weights_only=True)
    want = torch.load(f"{bundle}/generator.pt", weights_only=True)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    # and it is a reference-layout file: the JAX package's arch inference reads it
    from downgan_tpu.utils.port_weights import infer_generator_arch

    assert infer_generator_arch({k: v.numpy() for k, v in got.items()})["num_res_blocks"] == 1


def test_export_torch_refusals(trained, tmp_path, capsys):
    trainer, d = trained
    bundle = main(["export", "--checkpoint", trainer.ckpt.directory,
                   "--out", str(tmp_path / "bundle")])
    err = refusal(capsys, ["export-torch", "--checkpoint", bundle, "--ema", "--out",
                           str(tmp_path / "g.pt")])
    assert "an exported bundle holds ONE set of params" in err
    srres = Config(generator_arch="srresnet", **{**KW, "num_res_blocks": 1})
    write_generator_bundle(str(tmp_path / "srres"), srres,
                           make_generator(srres, "cpu").state_dict())
    err = refusal(capsys, ["export-torch", "--checkpoint", str(tmp_path / "srres"), "--out",
                           str(tmp_path / "g.pt")])
    assert "export-torch maps the reference RRDB layout only" in err


def test_export_torch_warns_for_a_stochastic_model(tmp_path, capsys):
    cfg = Config(noise_channels=2, **{**KW, "num_res_blocks": 1})
    write_generator_bundle(str(tmp_path / "sto"), cfg, make_generator(cfg, "cpu").state_dict())
    main(["export-torch", "--checkpoint", str(tmp_path / "sto"), "--out", str(tmp_path / "g.pt")])
    err = capsys.readouterr().err
    assert "stochastic generator (noise_channels=2)" in err
    sd = torch.load(tmp_path / "g.pt", weights_only=True)
    assert port_weights.infer_generator_arch(sd)["n_covariates"] == 9
