"""``cli train`` with the training variants on the CPU: the JAX CLI's
flags (``--lr-schedule``, ``--lr-warmup-steps``, ``--lr-decay-steps``,
``--lr-final-factor``, ``--augment-flips``, ``--grad-accum``,
``--eof-lambda``, ``--critic-conditional``, ``--freq-sep``) on both
schedules, the physics terms and metrics from a config file, the flags'
validation, and ``--warm-start``'s refusal of a critic of the other
conditioning."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.inference import write_generator_bundle  # noqa: E402
from downgan_tpu_torch.training.state import ScheduledAdam, make_train_state  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
B = 2
# 64x64 is too small for MS-SSIM's five levels.
METRICS = ("MAE", "MSE", "Wass")
VARIANT_FLAGS = ["--freq-sep", "--critic-conditional", "--augment-flips", "--eof-lambda", "1",
                 "--grad-accum", "2", "--lr-schedule", "cosine", "--lr-warmup-steps", "2",
                 "--lr-decay-steps", "10"]


def config_file(tmp_path, name="tiny.json", critic_conditional=False, **hp):
    hp = {"batch_size": B, "metrics_to_calculate": METRICS, **hp}
    cfg = Config(hp=HyperParams(**hp), critic_conditional=critic_conditional, **KW)
    path = tmp_path / name
    path.write_text(cfg.to_json())
    return str(path)


def train(tmp_path, config, *flags, samples=14, epochs=1):
    return main(["train", "--config", config, "--synthetic", "--samples", str(samples),
                 "--epochs", str(epochs), "--device", "cpu",
                 "--tracking-root", str(tmp_path / "exps"), *flags])


@pytest.mark.parametrize("schedule", ["reference", "fused"])
def test_cli_train_runs_the_variants(tmp_path, capsys, schedule):
    """All of the flags at once: one epoch (6 steps, or 1 fused round of 5
    batches) with finite means; the EOF basis fit at staging; the
    conditional critic on 9 inputs; two microbatch forwards per generator
    update; both optimizers on the schedule."""
    trainer = train(tmp_path, config_file(tmp_path), *VARIANT_FLAGS, "--schedule", schedule)
    out = capsys.readouterr()
    (line,) = [json.loads(ln) for ln in out.out.splitlines()]
    assert all(np.isfinite(v) for part in ("train", "test") for v in line[part].values())
    hp = trainer.config.hp
    assert (hp.freq_sep, hp.augment_flips, hp.eof_lambda, hp.grad_accum, hp.lr_schedule,
            hp.lr_warmup_steps, hp.lr_decay_steps) == (True, True, 1.0, 2, "cosine", 2, 10)
    assert trainer.config.critic_conditional
    assert trainer.state.critic.features[0].in_channels == 9
    # ncomp 75, but 12 training fields give 12 components
    assert trainer.eof_components.shape == (min(hp.ncomp, 12), 2, 64 * 64)
    assert trainer.eof_fit_seconds is not None and "EOF basis:" in out.err
    assert isinstance(trainer.state.g_opt, ScheduledAdam)
    assert isinstance(trainer.state.c_opt, ScheduledAdam)
    if schedule == "reference":
        assert line["steps"] == 6
        assert trainer.forwards == {"critic_fake": 6, "update": 4, "metric": 6, "test": 1}
    else:
        assert line["steps"] == 1
        assert trainer.forwards == {"critic_fake": 5, "update": 2, "metric": 1, "test": 1}


def test_cli_train_physics_terms_and_metrics_from_a_config(tmp_path, capsys):
    """The JAX CLI has no --divergence-lambda or --vorticity-lambda: a
    config file sets them, and the physics and spectral metrics."""
    cfg = config_file(tmp_path, divergence_lambda=1.0, vorticity_lambda=1.0,
                      metrics_to_calculate=("MAE", "Divergence", "Vorticity", "RALSD", "Wass"))
    trainer = train(tmp_path, cfg)
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert trainer.config.hp.divergence_lambda == trainer.config.hp.vorticity_lambda == 1.0
    for part in ("train", "test"):
        assert {"Divergence", "Vorticity", "RALSD"} <= set(line[part])
        assert all(np.isfinite(v) for v in line[part].values())


def test_cli_variant_flags_override_the_config(tmp_path):
    """Each flag overrides its config field; the negated forms turn a
    config's variant off. (No epoch is trained.)"""
    cfg = config_file(tmp_path, critic_conditional=True, freq_sep=True, augment_flips=True)
    trainer = train(tmp_path, cfg, "--no-freq-sep", "--no-augment-flips",
                    "--no-critic-conditional", "--lr-schedule", "linear", "--lr-decay-steps", "7",
                    "--lr-final-factor", "0.25", "--lr-warmup-steps", "1", epochs=0)
    hp = trainer.config.hp
    assert not (hp.freq_sep or hp.augment_flips or trainer.config.critic_conditional)
    assert (hp.lr_schedule, hp.lr_decay_steps, hp.lr_final_factor, hp.lr_warmup_steps) == (
        "linear", 7, 0.25, 1)
    assert trainer.eof_components is None and trainer.history == []


@pytest.mark.parametrize("flags,match", [
    (["--grad-accum", "3"], "equal microbatches"),
    (["--lr-schedule", "cosine"], "requires lr_decay_steps"),
    (["--lr-schedule", "linear", "--lr-decay-steps", "4", "--lr-warmup-steps", "4"],
     "lr_warmup_steps must be < lr_decay_steps"),
], ids=["grad_accum_divides_batch", "decay_steps", "warmup_inside_decay"])
def test_cli_refuses_invalid_variant_values(tmp_path, capsys, flags, match):
    with pytest.raises(SystemExit) as exc:
        train(tmp_path, config_file(tmp_path), *flags)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Bundles with a critic, trained unconditional and conditional, and
    one without a critic."""
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, conditional, with_critic in (("plain", False, True), ("conditional", True, True),
                                           ("generator_only", True, False)):
        cfg = Config(hp=HyperParams(batch_size=B, metrics_to_calculate=METRICS),
                     critic_conditional=conditional, **KW)
        state = make_train_state(cfg, "cpu")
        out[name] = write_generator_bundle(str(root / name), cfg, state.generator.state_dict(),
                                           state.critic.state_dict() if with_critic else None)
    return out


@pytest.mark.parametrize("bundle,flag", [("plain", "--critic-conditional"),
                                         ("conditional", "--no-critic-conditional")])
def test_cli_warm_start_refuses_a_critic_of_the_other_conditioning(tmp_path, capsys, bundles,
                                                                   bundle, flag):
    with pytest.raises(SystemExit) as exc:
        train(tmp_path, config_file(tmp_path), "--warm-start", bundles[bundle], flag, epochs=0)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "the bundle's critic was trained with critic_conditional=" in err
    assert "drop the bundle's critic.pt" in err


@pytest.mark.parametrize("bundle,flag", [("conditional", "--critic-conditional"),
                                         ("generator_only", "--no-critic-conditional")])
def test_cli_warm_start_takes_a_matching_critic_or_none(tmp_path, bundles, bundle, flag):
    trainer = train(tmp_path, config_file(tmp_path), "--warm-start", bundles[bundle], flag,
                    epochs=0)
    assert trainer.config.critic_conditional == (flag == "--critic-conditional")
    assert trainer.state.critic.features[0].in_channels == (9 if flag == "--critic-conditional"
                                                            else 2)
