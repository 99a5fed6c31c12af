"""The port's CLI tooling on the CPU (``--device cpu``), held against the
JAX package's commands: every JAX command and option under the same name,
``show-config``, ``profile`` (both modes, both schedules, ``--anomaly``),
``tune --smoke`` (ported from ``tests/test_bench.py::test_tune_smoke``),
``serve-tracking`` and the options ``train --region --lr``,
``generate``/``evaluate --region`` and ``serve --weights-only``."""
import argparse
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")
click = pytest.importorskip("click")

from downgan_tpu_torch.cli.__main__ import _source, build_parser, main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401

KW = dict(filters=8, num_res_blocks=1, coarse_size=8, fine_size=64)
METRICS = ("MAE", "MSE", "Wass")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JSON keys of the JAX package's `profile` line (cli/__main__.py:1382-1389).
JAX_PROFILE_KEYS = {"mode", "steps", "batch", "schedule", "steps_per_s", "patches_per_s",
                    "trace_dir", "hbm"}


def jax_commands():
    from downgan_tpu.cli.__main__ import cli

    return cli.commands


def port_subparsers():
    parser = build_parser()
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


JAX_COMMANDS = ["train", "prepare-data", "generate", "export", "export-mlflow", "export-torch",
                "import-torch", "serve", "evaluate", "serve-tracking", "prepare-covariates",
                "show-config", "profile", "tune"]


def test_the_command_list_is_the_jax_cli_s():
    assert sorted(jax_commands()) == sorted(JAX_COMMANDS)
    assert set(JAX_COMMANDS) <= set(port_subparsers())


@pytest.mark.parametrize("command", JAX_COMMANDS)
def test_every_jax_option_has_a_port_counterpart(command):
    """Read both parsers: every long option of the JAX command (both halves
    of a --x/--no-x pair) is an option of the port's command."""
    jax_opts = {o for p in jax_commands()[command].params
                for o in (*p.opts, *p.secondary_opts) if o.startswith("--")}
    port_opts = {o for a in port_subparsers()[command]._actions for o in a.option_strings}
    assert jax_opts and jax_opts <= port_opts, sorted(jax_opts - port_opts)


def tiny_config_file(tmp_path, name="tiny.json", **hp):
    cfg = Config(hp=HyperParams(**{"batch_size": 2, "metrics_to_calculate": METRICS, **hp}), **KW)
    path = tmp_path / name
    path.write_text(cfg.to_json())
    return str(path)


@pytest.mark.parametrize("which", ["default", "tiny"])
def test_show_config_equals_jax(tmp_path, capsys, which):
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli

    argv = ["show-config"] + (["--config", tiny_config_file(tmp_path)] if which == "tiny" else [])
    text = main(argv)
    assert capsys.readouterr().out == text + "\n"
    res = CliRunner().invoke(cli, argv, catch_exceptions=False)
    assert res.exit_code == 0
    assert json.loads(text) == json.loads(res.output)


def test_profile_keys_equal_jax(tmp_path, capsys):
    """The JAX command's line (infer mode, its keys) against the port's."""
    from click.testing import CliRunner

    from downgan_tpu.cli.__main__ import cli

    cfg = tiny_config_file(tmp_path)
    res = CliRunner().invoke(cli, ["profile", "--config", cfg, "--mode", "infer", "--steps", "1",
                                   "--out", str(tmp_path / "jax")], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    jax_line = json.loads(next(ln for ln in res.output.splitlines() if ln.startswith("{")))
    assert set(jax_line) == JAX_PROFILE_KEYS
    port = main(["profile", "--config", cfg, "--mode", "infer", "--steps", "1", "--out",
                 str(tmp_path / "port"), "--device", "cpu"])
    assert JAX_PROFILE_KEYS <= set(port)
    assert {k: port[k] for k in ("mode", "steps", "batch", "schedule")} == \
        {k: jax_line[k] for k in ("mode", "steps", "batch", "schedule")}
    assert port["hbm"] == jax_line["hbm"] == {}  # the CPU backend has no allocator stats


@pytest.mark.parametrize("mode,schedule", [("infer", "reference"), ("train", "reference"),
                                           ("train", "fused")])
def test_profile_writes_a_trace(tmp_path, capsys, mode, schedule):
    cfg = tiny_config_file(tmp_path, schedule=schedule)
    out = tmp_path / "prof"
    got = main(["profile", "--config", cfg, "--mode", mode, "--steps", "2", "--out", str(out),
                "--batch-size", "3" if mode == "infer" else "2", "--device", "cpu"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert printed == [got]
    traces = list(out.glob("*.pt.trace.json"))
    assert len(traces) == 1 and "profiled_" + mode + "_window" in traces[0].read_text()
    if mode == "train":  # the program's phase spans land in the written trace
        names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]
                 if e.get("cat") == "user_annotation"}
        assert {"train.call", "critic.update", "critic.backward", "metric.pass"} <= names
        # the reference schedule's generator update ran in the warm-up step
        assert ("generator.update" in names) == (schedule == "fused")
    batch = 3 if mode == "infer" else 2
    assert (got["mode"], got["steps"], got["batch"], got["trace_dir"]) == (mode, 2, batch, str(out))
    assert got["schedule"] == (schedule if mode == "train" else None)
    # a fused round is critic_iterations x B patches, counted as one step
    per_step = batch * (5 if (mode, schedule) == ("train", "fused") else 1)
    assert got["patches_per_step"] == per_step
    assert got["patches_per_s"] == pytest.approx(got["steps_per_s"] * per_step)
    # warm-up + 2 steps: the reference step runs 3 forwards at step 0 and 2
    # after; a fused round 5 critic fakes, one update and the metric fake
    want = {"infer": 3, "reference": 3 + 2 * 2, "fused": 3 * 7}[mode if mode == "infer"
                                                                else schedule]
    assert got["generator_forwards"] == want and got["drb_launches"] == 0
    assert got["device"] == "cpu"


def test_profile_anomaly_raises_on_a_nan_and_is_off_after(tmp_path, capsys, monkeypatch):
    import downgan_tpu_torch.training.state as state

    cfg = tiny_config_file(tmp_path)
    real = state.make_generator

    def nan_generator(*args, **kwargs):
        gen = real(*args, **kwargs)
        with torch.no_grad():
            gen.conv3[2].bias.fill_(float("nan"))
        return gen

    monkeypatch.setattr(state, "make_generator", nan_generator)
    argv = ["profile", "--config", cfg, "--mode", "infer", "--steps", "1", "--device", "cpu"]
    # without --anomaly the NaN passes
    assert main([*argv, "--out", str(tmp_path / "a")])["steps"] == 1
    with pytest.raises(FloatingPointError, match="non-finite"):
        main([*argv, "--out", str(tmp_path / "b"), "--anomaly"])
    assert not torch.is_anomaly_enabled()
    # in training the critic's NaN reaches the backward: anomaly mode raises
    monkeypatch.setattr(state, "make_generator", real)
    real_critic = state.make_critic

    def nan_critic(*args, **kwargs):
        critic = real_critic(*args, **kwargs)
        with torch.no_grad():
            critic.features[0].bias.fill_(float("nan"))
        return critic

    monkeypatch.setattr(state, "make_critic", nan_critic)
    argv = ["profile", "--config", cfg, "--mode", "train", "--steps", "1", "--device", "cpu"]
    assert main([*argv, "--out", str(tmp_path / "c")])["steps"] == 1
    with pytest.raises(RuntimeError, match="returned nan values"):
        main([*argv, "--out", str(tmp_path / "d"), "--anomaly"])
    assert not torch.is_anomaly_enabled()


def test_profile_refuses_zero_steps(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["profile", "--steps", "0", "--device", "cpu", "--out", str(tmp_path)])
    assert exc.value.code == 2 and "--steps must be >= 1" in capsys.readouterr().err


def test_tune_smoke(tmp_path, capsys, monkeypatch):
    """``tune`` sweeps candidates, each in its own process, and writes the
    recommended config: the --config base is measured and carried into the
    recommendation (ported from the JAX package's test_tune_smoke)."""
    # The children inherit the environment: one thread each, as this module's.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = Config(hp=HyperParams(critic_iterations=3, metrics_to_calculate=METRICS))
    base_path = tmp_path / "base.json"
    base_path.write_text(base.to_json())
    out, sweep_out = str(tmp_path / "tuned.json"), str(tmp_path / "sweep.json")
    report = main(["tune", "--smoke", "--device", "cpu", "--config", str(base_path),
                   "--batches", "4,8", "--dtypes", "float32", "--schedules", "reference",
                   "--scan-steps", "2", "--reps", "1", "--no-fast-paths",
                   "--out", out, "--sweep-out", sweep_out])
    printed = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")][-1])
    assert printed == report
    assert set(report) == {"best", "recommended_hp", "candidates"}
    assert set(report["best"]) == {"metric", "value", "unit", "batch", "dtype", "schedule",
                                   "grad_accum", "aggregate_patches_per_sec", "n_chips"}
    assert report["best"]["value"] > 0 and report["best"]["batch"] in (4, 8)
    assert len(report["candidates"]) == 2
    assert report["recommended_hp"]["metrics_reuse_fake"] is False
    cfg = Config.from_json(main(["show-config", "--config", out]))
    assert cfg.hp.batch_size == report["best"]["batch"] and cfg.hp.compute_dtype == "float32"
    assert cfg.hp.critic_iterations == 3  # the base, not the default, is what is edited
    with open(sweep_out) as f:
        sweep = json.load(f)
    assert sweep["best"] == report["best"]["metric"]
    for rec in sweep["sweep"]:
        assert rec["rep_times_s"] and rec["flops_per_step"] > 0 and rec["device"] == "cpu"
        assert rec["metric"] == f"wgan_gp_train_patches_per_sec_b{rec['batch']}_float32"
        assert set(rec["census"]) == {"fake_gen", "critic_vag_microbatch",
                                      "gen_vag_microbatch", "metrics"}
        assert rec["peak_tflops"] is None  # no card: no share of a peak
    # the recommended config trains
    main(["train", "--config", out, "--synthetic", "--samples", "10", "--epochs", "1",
          "--batch-size", "2", "--device", "cpu", "--tracking-root", str(tmp_path / "e"),
          "--plot-every", "1000"])


def test_tune_refuses_a_grid_that_never_divides(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["tune", "--smoke", "--device", "cpu", "--batches", "6", "--grad-accums", "4",
              "--scan-steps", "1", "--reps", "1"])
    err = capsys.readouterr().err
    assert exc.value.code == 1
    assert "b6 accum4: skipped (batch must divide into microbatches)" in err
    assert "no runnable (batch, grad-accum) combination" in err


@pytest.mark.parametrize("wins", [(True, True), (True, False)])
def test_tune_fast_path_pass(tmp_path, capsys, monkeypatch, wins):
    """After the sweep: each fast path at the winner, and both together
    only when each wins alone (the JAX command's logic), on fake records."""
    calls = []

    def fake_run(cmd, **kwargs):
        reuse, fused = "--reuse-fake" in cmd, "--fused-critic" in cmd
        calls.append((reuse, fused))
        batch = int(cmd[cmd.index("--batch") + 1])
        value = batch + 10 * (reuse and wins[0]) + 10 * (fused and wins[1]) \
            - 5 * (reuse and not wins[0]) - 5 * (fused and not wins[1])
        rec = {"metric": f"m{batch}{reuse}{fused}", "value": value, "unit": "patches/sec/chip",
               "aggregate_patches_per_sec": value, "n_chips": 1}
        return subprocess.CompletedProcess(cmd, 0, json.dumps(rec) + "\n", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    report = main(["tune", "--smoke", "--device", "cpu", "--batches", "4,8", "--dtypes",
                   "float32", "--schedules", "reference", "--out", str(tmp_path / "t.json")])
    both = wins == (True, True)
    assert calls == [(False, False)] * 2 + [(True, False), (False, True)] + \
        ([(True, True)] if both else [])
    assert report["recommended_hp"]["metrics_reuse_fake"] is True
    assert report["recommended_hp"]["fused_critic_pass"] is both
    assert report["best"]["batch"] == 8


def test_serve_tracking_serves_the_root(tmp_path):
    from downgan_tpu_torch.tracking import TrackingStore

    store = TrackingStore(str(tmp_path / "exps"))
    run = store.create_run(store.create_experiment("served")).start()
    run.log_metric("MAE_train", 0.5, 0)
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "downgan_tpu_torch.cli", "serve-tracking",
                             "--root", store.root, "--host", "127.0.0.1", "-p", str(port)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "PYTHONPATH": ROOT})
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as r:
                    index = r.read().decode()
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/run/{run.run_id}", timeout=5) as r:
            page = r.read().decode()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert "served" in index and "MAE_train" in page
    assert f"tracking UI on http://127.0.0.1:{port}" in out.decode()


def test_train_region_and_lr_override(tmp_path, capsys):
    trainer = main(["train", "--config", tiny_config_file(tmp_path), "--synthetic", "--samples",
                    "6", "--epochs", "1", "--device", "cpu", "--tracking-root",
                    str(tmp_path / "e"), "--region", "central", "--lr", "1e-4",
                    "--plot-every", "1000"])
    assert trainer.config.region == "central" and trainer.config.hp.lr == 1e-4
    assert all(g["lr"] == 1e-4 for g in trainer.state.g_opt.param_groups)


@pytest.mark.parametrize("command", ["generate", "evaluate", "serve"])
def test_region_and_weights_only_resolve_like_jax(tmp_path, command):
    """generate/evaluate --region, serve --weights-only: the source
    resolution the commands share (the JAX CLI's _resolve_source_config)."""
    from downgan_tpu_torch.inference import write_generator_bundle
    from downgan_tpu_torch.training.state import make_generator

    cfg = Config(**KW)
    bundle = write_generator_bundle(str(tmp_path / "b"), cfg,
                                    make_generator(cfg, "cpu").state_dict())
    parser = build_parser()
    if command == "serve":
        args = parser.parse_args(["serve", "--checkpoint", f"{bundle}/generator.pt",
                                  "--weights-only", "--config", str(tmp_path / "b/config.json")])
        config, path, weights_only, _ = _source(args, parser)
        assert weights_only and path.endswith("generator.pt") and config.filters == 8
        return
    args = parser.parse_args([command, "--checkpoint", bundle, "--region", "central"])
    config, _, weights_only, _ = _source(args, parser)
    assert config.region == "central" and weights_only and config.filters == 8
    args = parser.parse_args([command, "--checkpoint", bundle])
    assert _source(args, parser)[0].region == "florida"
    with pytest.raises(SystemExit):
        parser.parse_args([command, "--checkpoint", bundle, "--region", "atlantis"])


def test_serve_weights_only_refuses_ema(tmp_path, capsys):
    from downgan_tpu_torch.inference import write_generator_bundle
    from downgan_tpu_torch.training.state import make_generator

    cfg = Config(**KW)
    bundle = write_generator_bundle(str(tmp_path / "b"), cfg,
                                    make_generator(cfg, "cpu").state_dict())
    with pytest.raises(SystemExit):
        main(["serve", "--checkpoint", f"{bundle}/generator.pt", "--weights-only", "--ema",
              "--config", f"{bundle}/config.json", "--device", "cpu"])
    assert "hold one set of params" in capsys.readouterr().err
