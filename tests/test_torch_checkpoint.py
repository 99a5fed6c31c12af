"""The port's checkpoints, exact resume, EMA, best-epoch bundles, SIGTERM
preemption, and the ``train``/``serve``/``export`` CLI around them, on the
CPU (counterparts of the JAX package's ``tests/test_trainer.py`` and
``tests/test_preemption.py``). Tiny model: filters 8, 1 RRDB, 16 -> 128
(so MS-SSIM runs), batch 2. Resume is held bit for bit: the same
operations on the same CPU in the same order give the same bits."""
import csv
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu_torch import serving  # noqa: E402
from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset  # noqa: E402
from downgan_tpu_torch.inference import (  # noqa: E402
    load_bundle,
    restore_generator_params,
    write_generator_bundle,
)
from downgan_tpu_torch.models.generator import DenseResidualBlock  # noqa: E402
from downgan_tpu_torch.ops.cuda.drb import pack_drb_weights  # noqa: E402
from downgan_tpu_torch.tracking import TrackingStore  # noqa: E402
from downgan_tpu_torch.training.state import (  # noqa: E402
    load_generator,
    make_generator,
    make_train_state,
)
from downgan_tpu_torch.training.trainer import (  # noqa: E402
    NonFiniteLossError,
    Trainer,
    full_split_metric_pass,
)
from downgan_tpu_torch.training.wgan import build_train_step, ema_update, gp_alpha  # noqa: E402
from downgan_tpu_torch.utils.checkpoint import CheckpointManager, load_params  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(filters=8, num_res_blocks=1, coarse_size=16, fine_size=128)
B = 2
EMA = 0.5  # moves the EMA far enough in a few updates to tell it from the live weights


def tiny_config(**hp):
    # critic_iterations 2: with 2 steps an epoch every epoch's first step
    # updates the generator (and the EMA), a resumed one included.
    return Config(hp=HyperParams(batch_size=B, critic_iterations=2, **hp), **KW)


@pytest.fixture(scope="module")
def data():
    """4 training samples (2 steps an epoch) and 3 test samples (a batch
    and a ragged tail)."""
    coarse, fine = synthetic_dataset(n_samples=7, seed=5)
    return (DeviceDataset.from_numpy(coarse[:4], fine[:4], "cpu"),
            DeviceDataset.from_numpy(coarse[4:], fine[4:], "cpu"))


def trainer_of(config, data, **kw):
    return Trainer(config, *data, device="cpu", **kw)


def state_tensors(state):
    """Every tensor and number of a train state, by name."""
    out = {"step": state.step}
    for name, sd in state.state_dict().items():
        if isinstance(sd, dict):
            for k, v in _flatten(sd):
                out[f"{name}.{k}"] = v
    return out


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), obj


def assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert torch.equal(ta[k], tb[k]), k
        else:
            assert ta[k] == tb[k], k


# -- the state and its checkpoint ----------------------------------------------

@pytest.mark.parametrize("ema_decay", [0.0, EMA], ids=["no_ema", "ema"])
def test_state_dict_round_trip_and_alpha_stream(tmp_path, data, ema_decay):
    """Every tensor (both networks, both Adam states, the EMA generator)
    and the step come back from a checkpoint into a state made from
    another seed; the next step, with its alpha drawn from the stream,
    then moves both states to the same bits."""
    cfg = tiny_config(ema_decay=ema_decay)
    train, _ = data
    a = make_train_state(cfg, "cpu")
    step_a = build_train_step(cfg, a.generator, a.critic)
    for i in range(3):
        step_a(a, *train.gather(torch.tensor([i, i + 1])))
    mngr = CheckpointManager(str(tmp_path / "ck"))
    assert mngr.save(2, a)
    b = make_train_state(cfg.replace(seed=9), "cpu")
    assert not torch.equal(a.generator.conv1.weight, b.generator.conv1.weight)
    b.load_state_dict(mngr.restore())
    assert_states_equal(a, b)
    assert (b.g_ema is None) == (ema_decay == 0.0)
    for opt in (b.g_opt, b.c_opt):  # hazard: a resumed optimizer stays foreach, not fused
        assert opt.param_groups[0]["foreach"] is True and not opt.param_groups[0]["fused"]
        assert all(s["step"].device.type == "cpu" for s in opt.state.values())
    batch = train.gather(torch.tensor([3, 0]))
    for state in (a, b):  # step 3: alpha from (seed, 3) on both sides
        build_train_step(cfg, state.generator, state.critic)(state, *batch)
    assert_states_equal(a, b)


def test_gp_alpha_is_a_function_of_seed_and_step():
    cpu = torch.device("cpu")
    assert torch.equal(gp_alpha(0, 7, 4, cpu), gp_alpha(0, 7, 4, cpu))
    draws = [gp_alpha(s, t, 4, cpu) for s, t in ((0, 7), (0, 8), (1, 7))]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert draws[0].shape == (4, 1, 1, 1) and bool(((draws[0] >= 0) & (draws[0] < 1)).all())


def test_checkpoint_holds_plain_types_only(tmp_path, data):
    """``weights_only`` loading reads a checkpoint (no pickled object, no
    packed DRB weights) and refuses a file that pickles one."""
    cfg = tiny_config(ema_decay=EMA)
    state = make_train_state(cfg, "cpu")
    with torch.no_grad():
        state.generator(data[0].coarse[:1])  # fills the DRB blocks' packed cache
    mngr = CheckpointManager(str(tmp_path / "ck"))
    mngr.save(0, state)
    names = [k for k, _ in _flatten(load_params(os.path.join(mngr.directory, "0.pt")))]
    assert names and not any("_packed" in k for k in names)
    bad = str(tmp_path / "bad.pt")
    torch.save({"x": DeviceDataset(torch.zeros(1), torch.zeros(1))}, bad)
    with pytest.raises(Exception, match="[Ww]eights only load failed"):
        load_params(bad)


class _Stub:
    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step}


@pytest.mark.parametrize("max_to_keep,keep_period,retained", [
    (2, None, [4, 5]), (3, None, [3, 4, 5]), (None, None, [0, 1, 2, 3, 4, 5]),
    (0, None, [0, 1, 2, 3, 4, 5]), (1, 2, [0, 2, 4, 5]), (2, 3, [0, 3, 4, 5]),
], ids=["window2", "window3", "keep_all_none", "keep_all_zero", "pin_every_2", "pin_every_3"])
def test_retention(tmp_path, max_to_keep, keep_period, retained):
    mngr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=max_to_keep,
                             keep_period=keep_period)
    for step in range(6):
        assert mngr.save(step, _Stub(step))
    assert mngr.all_steps() == retained and mngr.latest_step() == 5
    assert mngr.restore()["step"] == 5 and mngr.restore(retained[0])["step"] == retained[0]


def test_restoring_a_pruned_step_names_the_retained_ones(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in range(4):
        mngr.save(step, _Stub(step))
    with pytest.raises(FileNotFoundError, match=r"retained checkpoints \[2, 3\]"):
        mngr.restore(1)


def test_save_and_restore_semantics(tmp_path):
    """As Orbax: a step at or below the latest is skipped unless forced,
    and forcing never overwrites; reading an absent directory creates
    nothing."""
    path = str(tmp_path / "ck")
    mngr = CheckpointManager(path)
    assert mngr.latest_step() is None and mngr.all_steps() == [] and not os.path.exists(path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mngr.restore()
    assert mngr.save(3, _Stub(3))
    assert not mngr.save(3, _Stub(30)) and not mngr.save(1, _Stub(1))
    assert mngr.save(1, _Stub(1), force=True)
    with pytest.raises(ValueError, match="already exists"):
        mngr.save(3, _Stub(30), force=True)
    assert mngr.all_steps() == [1, 3] and mngr.restore(3)["step"] == 3
    assert sorted(os.listdir(path)) == ["1.pt", "3.pt"]  # no temporary file left behind


# -- the trainer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def straight(data):
    """Three epochs without interruption, EMA on."""
    trainer = trainer_of(tiny_config(ema_decay=EMA), data)
    trainer.train(3)
    return trainer


RESUME_VARIANTS = {
    "deterministic": {},
    "stochastic": dict(noise_channels=2),
    # A cosine schedule in its warmup at the resume (critic count 4 of 8):
    # each optimizer's rate is read from its checkpointed Adam count.
    "lr_schedule": dict(hp=dict(lr_schedule="cosine", lr_warmup_steps=8, lr_decay_steps=20)),
}


@pytest.mark.parametrize("variant", list(RESUME_VARIANTS))
def test_resume_reproduces_the_uninterrupted_run(tmp_path, data, straight, capsys, variant):
    """3 epochs == 2 epochs, checkpoint, a fresh trainer resuming, 1 more:
    every tensor (EMA and Adam states included) and epoch 2's means, bit
    for bit. A stochastic generator's training latents are functions of
    (seed, step, stream) and its test pass scores the fixed latent, and an
    LR schedule's count is each Adam state's own, so the checkpoint
    carries them too."""
    kw = dict(RESUME_VARIANTS[variant])
    cfg = tiny_config(ema_decay=EMA, **kw.pop("hp", {})).replace(**kw)
    if variant != "deterministic":
        straight = trainer_of(cfg, data)
        straight.train(3)
    first = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    first.train(2)
    resumed = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    assert resumed.maybe_resume() and resumed.epoch == 2 and resumed.state.step == 4
    assert "resumed from checkpoint of epoch 1; continuing at epoch 2" in capsys.readouterr().err
    (record,) = resumed.train(3)
    assert record == {**straight.history[2], "seconds": record["seconds"]}
    assert_states_equal(straight.state, resumed.state)
    assert not torch.equal(straight.state.g_ema.conv1.weight, straight.state.generator.conv1.weight)
    if variant == "lr_schedule":  # still warming up: the last critic update ran at count 5
        assert resumed.state.c_opt.param_groups[0]["lr"] == cfg.hp.lr * 5 / 8


def test_epochs_zero_writes_no_checkpoint(tmp_path, data):
    mngr = CheckpointManager(str(tmp_path / "ck"))
    trainer = trainer_of(tiny_config(), data, checkpoint_manager=mngr)
    assert trainer.train(0) == [] and mngr.latest_step() is None


def test_halt_on_nonfinite_raises_before_checkpointing(tmp_path, data):
    cfg = tiny_config(lr=1e12)  # a certain blow-up
    mngr = CheckpointManager(str(tmp_path / "ck"))
    trainer = trainer_of(cfg, data, checkpoint_manager=mngr)
    with pytest.raises(NonFiniteLossError, match="non-finite training metrics at epoch 0"):
        trainer.train(2)
    assert mngr.latest_step() is None
    through = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "c2")),
                         halt_on_nonfinite=False)
    through.train(1)
    assert through.epoch == 1 and through.ckpt.latest_step() == 0
    assert not all(math.isfinite(v) for v in through.history[0]["train"].values())


def test_preempted_flag_stops_checkpoints_and_resumes_exactly(tmp_path, data, straight, capsys):
    """The flag the SIGTERM handler sets, raised during epoch 1: the run
    stops at that epoch's boundary without its test pass, with epoch 1
    checkpointed; a resume trains epoch 2 onto the uninterrupted run's
    trajectory."""
    cfg = tiny_config(ema_decay=EMA)
    trainer = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    real = trainer.run_train_epoch

    def preempt_in_epoch_1():
        if trainer.epoch == 1:
            trainer.preempted = True
        return real()

    trainer.run_train_epoch = preempt_in_epoch_1
    trainer.train(3)
    assert trainer.preempted and trainer.epoch == 2 and trainer.ckpt.latest_step() == 1
    assert "test" in trainer.history[0] and "test" not in trainer.history[1]
    assert "preempted (SIGTERM): stopping after epoch 1" in capsys.readouterr().err
    resumed = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    assert resumed.maybe_resume()
    resumed.train(3)
    assert not resumed.preempted and resumed.ckpt.latest_step() == 2
    assert_states_equal(straight.state, resumed.state)


def test_sigterm_during_test_pass_stops_this_epoch(data):
    trainer = trainer_of(tiny_config(), data)
    real = trainer.run_test_pass

    def preempt_during_test_pass():
        out = real()
        if trainer.epoch == 1:
            trainer.preempted = True
        return out

    trainer.run_test_pass = preempt_during_test_pass
    trainer.train(4)
    assert trainer.preempted and trainer.epoch == 2 and len(trainer.history) == 2


def test_sigterm_handler_is_installed_only_while_training(data):
    trainer = trainer_of(tiny_config(), data)
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    real = trainer.run_train_epoch

    def look():
        seen.append(signal.getsignal(signal.SIGTERM))
        os.kill(os.getpid(), signal.SIGTERM)  # a real signal, caught by the handler
        return real()

    trainer.run_train_epoch = look
    trainer.train(3)
    assert trainer.preempted and trainer.epoch == 1
    assert seen[0] is not before and signal.getsignal(signal.SIGTERM) is before


def _read_lines(proc, want, deadline, lines):
    """Read ``proc``'s stdout until ``want`` JSON epoch lines were seen."""
    seen = 0
    while seen < want:
        assert time.time() < deadline, "".join(lines[-20:])
        line = proc.stdout.readline()
        if not line:
            assert proc.poll() is None, "".join(lines[-20:])
            continue
        lines.append(line)
        seen += line.startswith("{")


def test_sigterm_subprocess_graceful_checkpoint_and_resume(tmp_path):
    """A real signal to the real CLI: exit 0 with the last finished epoch
    checkpointed and the run marked KILLED; --resume finishes the run."""
    cfg = Config(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
                 hp=HyperParams(batch_size=8, metrics_to_calculate=("MAE", "MSE", "Wass")))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    ckpt_dir, root = str(tmp_path / "ck"), str(tmp_path / "exps")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    args = [sys.executable, "-m", "downgan_tpu_torch.cli", "train", "--config", str(cfg_path),
            "--synthetic", "--samples", "24", "--device", "cpu", "--epochs", "100000",
            "--checkpoint-dir", ckpt_dir, "--tracking-root", root]
    proc = subprocess.Popen(args, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, bufsize=1)
    lines = []
    try:
        _read_lines(proc, 2, time.time() + 240, lines)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert "re-run with --resume" in err, err[-3000:]
    last = CheckpointManager(ckpt_dir).latest_step()
    assert last is not None and last >= 1
    store = TrackingStore(root)
    (run,) = store.runs("0")
    assert run.meta["status"] == "KILLED"

    done = subprocess.run(args[:-6] + ["--epochs", str(last + 3), "--checkpoint-dir", ckpt_dir,
                                       "--tracking-root", root, "--resume"],
                          env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    assert f"resumed from checkpoint of epoch {last}" in done.stderr
    assert [json.loads(ln)["epoch"] for ln in done.stdout.splitlines()] == [last + 1, last + 2]
    assert CheckpointManager(ckpt_dir).latest_step() == last + 2
    assert sorted(r.meta["status"] for r in store.runs("0")) == ["FINISHED", "KILLED"]


# -- best-epoch bundles and warm start ------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(no_test=True, best_dir="x"), "needs a test dataset"),
    (dict(track_best="RALSD", best_dir="x"), "not produced"),
    (dict(track_best="gen_loss", best_dir="x"), "not produced"),
    (dict(track_best="critic_loss", best_dir="x"), "not produced"),
    (dict(track_best="MAE"), "best_dir"),
    (dict(track_best="MAE", best_mode="up", best_dir="x"), "best_mode"),
], ids=["no_test_set", "unknown_metric", "gen_loss", "critic_loss", "no_best_dir", "bad_mode"])
def test_track_best_validation(data, kw, match):
    kw = dict(kw)
    test = None if kw.pop("no_test", False) else data[1]
    kw.setdefault("track_best", "MAE")
    with pytest.raises(ValueError, match=match):
        Trainer(tiny_config(), data[0], test, device="cpu", **kw)


def test_track_best_writes_servable_ema_bundle(tmp_path, data):
    """With EMA on the bundle holds the EMA weights and the selection runs
    on their test metric (logged as MAE_ema_test); the bundle loads and,
    scored again, gives exactly the value best.json claims."""
    store = TrackingStore(str(tmp_path / "exps"))
    run = store.create_run(store.create_experiment("t")).start()
    cfg = tiny_config(ema_decay=EMA)
    trainer = trainer_of(cfg, data, run=run, track_best="MAE")
    trainer.train(3)
    assert trainer.forwards["test_ema"] == trainer.forwards["test"] == 3 * 2
    best_dir = os.path.join(run.artifact_dir, "best")
    with open(os.path.join(best_dir, "best.json")) as f:
        best = json.load(f)
    assert set(best) == {"metric", "mode", "value", "epoch", "ema"}
    assert best["metric"] == "MAE" and best["mode"] == "min" and best["ema"] is True
    ema_hist = run.metric_history("MAE_ema_test")
    assert [h["value"] for h in ema_hist] == [r["test_ema"]["MAE"] for r in trainer.history]
    assert best["epoch"] == ema_hist[int(np.argmin([h["value"] for h in ema_hist]))]["step"]
    assert best["value"] == min(h["value"] for h in ema_hist)
    with open(run.artifact_path("test_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1, 2]
    assert float(rows[2]["MAE"]) == pytest.approx(trainer.history[2]["test"]["MAE"], rel=1e-12)
    assert run.metric_history("best_MAE_test")

    config, g_weights, c_weights = load_bundle(best_dir)
    assert config == cfg and c_weights is None
    gen = load_generator(config, g_weights, "cpu")
    measured = full_split_metric_pass(
        data[1], B, lambda c, f: trainer._eval(gen, trainer.state.critic, c, f))
    assert measured["MAE"] == pytest.approx(best["value"], rel=1e-6)


def test_track_best_resume_restores_best_state(tmp_path, data):
    best_dir = str(tmp_path / "best")
    cfg = tiny_config()
    first = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")),
                       track_best="MAE", best_dir=best_dir)
    first.train(2)
    with open(os.path.join(best_dir, "best.json")) as f:
        rec = json.load(f)
    assert rec["ema"] is False
    again = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")),
                       track_best="MAE", best_dir=best_dir)
    assert again.maybe_resume()
    assert again.best_value == rec["value"] and again.best_epoch == rec["epoch"]
    bundle = os.path.join(best_dir, "generator.pt")
    written = os.path.getmtime(bundle)
    again._update_best({"MAE": rec["value"] + 1.0})  # worse: the bundle stays
    assert os.path.getmtime(bundle) == written and again.best_value == rec["value"]
    # a record of another metric or mode is ignored
    other = trainer_of(cfg, data, checkpoint_manager=CheckpointManager(str(tmp_path / "ck")),
                       track_best="MAE", best_mode="max", best_dir=best_dir)
    assert other.maybe_resume() and other.best_value is None


def test_warm_start_loads_bundle_and_resets_ema(tmp_path, data, straight):
    out = write_generator_bundle(str(tmp_path / "b"), straight.config,
                                 straight.state.generator.state_dict(),
                                 straight.state.critic.state_dict())
    _, g_weights, c_weights = load_bundle(out)
    trainer = trainer_of(tiny_config(ema_decay=EMA), data)
    trainer.warm_start(g_weights, c_weights)
    for net, want in (("generator", g_weights), ("g_ema", g_weights), ("critic", c_weights)):
        got = getattr(trainer.state, net).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), net
    state = trainer.state
    assert state.step == 0 and not state.g_opt.state and not state.c_opt.state
    # a generator-only re-save removes the stale critic
    write_generator_bundle(out, straight.config, g_weights)
    assert load_bundle(out)[2] is None


def _drb_blocks(gen):
    return [m for m in gen.modules() if isinstance(m, DenseResidualBlock)]


def _apply(kind, trainer, tmp_path):
    state = trainer.state
    if kind in ("resume", "resume_stochastic"):
        mngr = CheckpointManager(str(tmp_path / "ck"))
        snapshot = make_train_state(trainer.config.replace(seed=4), "cpu")
        mngr.save(0, snapshot)
        trainer.ckpt = mngr
        trainer.maybe_resume()
    elif kind == "warm_start":
        other = make_train_state(trainer.config.replace(seed=4), "cpu")
        trainer.warm_start(other.generator.state_dict())
    else:
        ema_update(EMA, state.g_ema, list(state.generator.parameters()))


@pytest.mark.parametrize("kind", ["resume", "warm_start", "ema_update", "resume_stochastic",
                                  "inference_mode"])
def test_drb_packed_weights_refresh(tmp_path, data, kind):
    """The DRB blocks' packed-weight cache is keyed on each parameter's
    version: a resume, a warm start and an EMA update each change the
    key, and the next forward packs the current weights; so does the
    resume of a stochastic generator (whose trunk is the same). A generator
    built inside ``torch.inference_mode()`` has inference-tensor
    parameters, which keep no version: its blocks pack at every forward,
    cache nothing, and give the normal build's output bit for bit."""
    if kind == "inference_mode":
        x = data[0].coarse[:2]
        with torch.inference_mode():
            gen = make_generator(tiny_config(), "cpu")
            out, again = gen(x), gen(x)
        assert all(p.is_inference() for p in gen.parameters())
        assert all(b._packed_key is None and b._packed is None for b in _drb_blocks(gen))
        with torch.no_grad():
            want = make_generator(tiny_config(), "cpu")(x)
        assert torch.equal(out, want) and torch.equal(again, want)
        return
    k = 2 if kind == "resume_stochastic" else 0
    trainer = trainer_of(tiny_config(ema_decay=EMA).replace(noise_channels=k), data)
    with torch.no_grad():
        trainer.state.generator.state_dict()["conv1.weight"].mul_(1.5)  # EMA != live weights
        x = data[0].coarse[:1]
        x = torch.cat([x, torch.ones(1, k, *x.shape[2:])], dim=1)
        nets = [trainer.state.generator, trainer.state.g_ema]
        for net in nets:
            net(x)
        before = [[b._packed_key for b in _drb_blocks(n)] for n in nets]
        _apply(kind, trainer, tmp_path)
        for net, keys in zip(nets, before):
            if kind == "ema_update" and net is trainer.state.generator:
                continue  # the EMA update writes only the EMA generator
            net(x)
            for block, key in zip(_drb_blocks(net), keys):
                assert block._packed_key != key
                assert torch.equal(block._packed, pack_drb_weights(*block.stage_params()))


def test_ema_update_is_the_jax_formula():
    ema, live = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    want = [0.9 * e.detach().double() + 0.1 * p.detach().double()
            for e, p in zip(ema.parameters(), live.parameters())]
    versions = [p._version for p in ema.parameters()]
    ema_update(0.9, ema, list(live.parameters()))
    for got, w, v in zip(ema.parameters(), want, versions):
        assert torch.allclose(got.double(), w, rtol=0, atol=1e-7) and got._version > v


def test_ema_moves_on_generator_updates_only(data):
    cfg = Config(hp=HyperParams(batch_size=B, ema_decay=EMA, critic_iterations=3), **KW)
    state = make_train_state(cfg, "cpu")
    step = build_train_step(cfg, state.generator, state.critic)
    snap = lambda: state.g_ema.conv1.weight.detach().clone()  # noqa: E731
    moved = []
    for i in range(4):  # generator updates at steps 0 and 3
        before = snap()
        step(state, *data[0].gather(torch.tensor([0, 1])))
        moved.append(not torch.equal(before, snap()))
    assert moved == [True, False, False, True]


# -- the CLI -------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two CLI runs: EMA on with --track-best MSSSIM, every checkpoint kept
    (2 epochs); EMA off (1 epoch)."""
    root = tmp_path_factory.mktemp("cli")
    out = {"root": str(root)}
    for name, ema, epochs in (("ema", EMA, 2), ("plain", 0.0, 1)):
        cfg_path = root / f"{name}.json"
        cfg_path.write_text(tiny_config(ema_decay=ema).to_json())
        trainer = main(["train", "--config", str(cfg_path), "--synthetic", "--samples", "7",
                        "--epochs", str(epochs), "--device", "cpu", "--tracking-root",
                        str(root / "exps"), "--run-name", name, "--max-checkpoints", "0",
                        "--track-best", "MSSSIM"])
        out[name] = trainer
    return out


def test_cli_train_tracks_checkpoints_and_resumes(cli_runs, tmp_path, capsys):
    trainer = cli_runs["ema"]
    run = trainer.run
    assert run.meta["status"] == "FINISHED" and run.meta["run_name"] == "ema"
    assert trainer.ckpt.directory == os.path.join(run.artifact_dir, "checkpoints")
    assert trainer.ckpt.all_steps() == [0, 1]
    with open(os.path.join(run.artifact_dir, "config.json")) as f:
        assert Config.from_json(f.read()) == trainer.config
    assert run.params["ema_decay"] == EMA and run.params["batch_size"] == B
    with open(os.path.join(run.artifact_dir, "best", "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == "MSSSIM" and best["mode"] == "max" and best["ema"] is True

    ckpt_dir = str(tmp_path / "ck")
    common = ["train", "--config", os.path.join(cli_runs["root"], "ema.json"), "--synthetic",
              "--samples", "7", "--device", "cpu", "--tracking-root", str(tmp_path / "exps"),
              "--checkpoint-dir", ckpt_dir]
    main(common + ["--epochs", "1"])
    resumed = main(common + ["--epochs", "2", "--resume"])
    assert "resumed from checkpoint of epoch 0" in capsys.readouterr().err
    assert resumed.epoch == 2 and [r["epoch"] for r in resumed.history] == [1]
    assert_states_equal(trainer.state, resumed.state)


class _StubServer:
    server_address = ("127.0.0.1", 0)

    def serve_forever(self):
        pass

    def server_close(self):
        pass


@pytest.fixture()
def served(monkeypatch):
    models = []

    def fake_serve_model(model, host, port):
        models.append(model)
        return _StubServer()

    monkeypatch.setattr(serving, "serve_model", fake_serve_model)
    return models


def _sources(cli_runs):
    """Each way ``serve`` takes the EMA run's weights: (argv, the weights
    it must serve, the config it must build)."""
    trainer = cli_runs["ema"]
    best, state, ckpt = os.path.join(trainer.run.artifact_dir, "best"), trainer.state, trainer.ckpt
    cfg_file = os.path.join(cli_runs["root"], "ema.json")
    with open(cfg_file) as f:
        file_config = Config.from_json(f.read())
    return {
        "bundle": (["--checkpoint", best], load_bundle(best)[1], trainer.config),
        "checkpoint": (["--checkpoint", ckpt.directory], state.generator.state_dict(),
                       trainer.config),
        "checkpoint_ema": (["--checkpoint", ckpt.directory, "--ema"], state.g_ema.state_dict(),
                           trainer.config),
        "checkpoint_epoch0_ema": (["--checkpoint", ckpt.directory, "--epoch", "0", "--ema"],
                                  ckpt.restore(0)["g_ema"], trainer.config),
        "run_ema": (["--run", trainer.run.run_id, "--tracking-root",
                     os.path.join(cli_runs["root"], "exps"), "--ema"], state.g_ema.state_dict(),
                    trainer.config),
        "weights": (["--weights", os.path.join(best, "generator.pt"), "--config", cfg_file],
                    load_bundle(best)[1], file_config),
    }


@pytest.mark.parametrize("source", ["bundle", "checkpoint", "checkpoint_ema",
                                    "checkpoint_epoch0_ema", "run_ema", "weights"])
def test_cli_serve_restores_each_source(cli_runs, served, source):
    """The served model is built from the logged, bundled or given config
    and answers as a generator with exactly the source's weights."""
    argv, want, config = _sources(cli_runs)[source]
    main(["serve", *argv, "--device", "cpu", "--no-coalesce", "--serving-batch", "2"])
    (model,) = served
    assert model.config == config
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 7)).astype(np.float32)
    gen = load_generator(config, want, "cpu")
    with torch.no_grad():
        ref = gen(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(model.generate(x), ref)


@pytest.mark.parametrize("argv,match", [
    (lambda r: ["--checkpoint", r["ema"].run.artifact_dir + "/best", "--epoch", "0"],
     "epoch/step cannot be selected"),
    (lambda r: ["--checkpoint", r["ema"].run.artifact_dir + "/best", "--ema"], "drop --ema"),
    (lambda r: ["--weights", r["ema"].run.artifact_dir + "/best/generator.pt", "--ema"],
     "drop --ema"),
    (lambda r: ["--checkpoint", r["plain"].ckpt.directory, "--ema"], "no EMA weights"),
    (lambda r: [], "exactly one of --weights, --checkpoint or --run"),
    (lambda r: ["--checkpoint", r["plain"].ckpt.directory, "--run", r["plain"].run.run_id],
     "exactly one of"),
], ids=["bundle_epoch", "bundle_ema", "weights_ema", "no_ema_run", "no_source", "two_sources"])
def test_cli_serve_usage_errors(cli_runs, served, capsys, argv, match):
    with pytest.raises(SystemExit) as exc:
        main(["serve", *argv(cli_runs), "--device", "cpu"])
    assert exc.value.code == 2 and match in capsys.readouterr().err and not served


def test_cli_export_writes_a_bundle_serve_reads(cli_runs, served, tmp_path, capsys):
    trainer = cli_runs["ema"]
    out = main(["export", "--checkpoint", trainer.ckpt.directory, "--epoch", "0", "--ema",
                "--out", str(tmp_path / "bundle")])
    assert "exported EMA generator bundle" in capsys.readouterr().out
    config, g_weights, c_weights = load_bundle(out)
    want = trainer.ckpt.restore(0)["g_ema"]
    assert config == trainer.config and c_weights is None
    assert all(torch.equal(g_weights[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(
        restore_generator_params(os.path.join(out, "generator.pt"), weights_only=True).values(),
        want.values()))
    with pytest.raises(SystemExit):
        main(["export", "--checkpoint", out, "--out", str(tmp_path / "again")])
    assert "already an exported bundle" in capsys.readouterr().err
    main(["serve", "--checkpoint", out, "--device", "cpu", "--no-coalesce"])
    assert served[0].config == trainer.config
