"""The port's host feed (``downgan_tpu_torch/data/feed.py``) and the
trainer's host-fed branch, on the CPU: batch order, reader errors, training
from host RAM equal to device-resident training bit for bit (the
counterpart of ``tests/test_trainer.py::test_host_feed_matches_device_trajectory``;
the device-resident step is held to the JAX step in ``test_torch_train.py``),
the refusals, and ``cli train --host-feed``. On a CUDA card only: pinned
buffers refilled only after their copy, and host-fed batches equal to
``DeviceDataset.gather``'s."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu_torch.cli.__main__ import main  # noqa: E402
from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.data.dataset import DeviceDataset, synthetic_dataset  # noqa: E402
from downgan_tpu_torch.data.feed import FeedStats, HostDataset, prefetch_batches  # noqa: E402
from downgan_tpu_torch.training.trainer import Trainer, full_split_metric_pass  # noqa: E402

from _torch_parity import one_thread  # noqa: E402,F401


def tiny_config(**hp) -> Config:
    hp = {"batch_size": 4, "metrics_to_calculate": ("MAE", "MSE", "Wass"),
          "fused_epoch": False, **hp}
    return Config(coarse_size=8, fine_size=32, filters=8, num_res_blocks=1,
                  hp=HyperParams(**hp))


def counting_dataset(n=20):
    coarse = np.arange(n, dtype=np.float32)[:, None, None, None] * np.ones((n, 2, 2, 1),
                                                                          np.float32)
    return HostDataset(coarse, coarse + 100.0)


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_prefetch_feed_covers_epoch_in_order(prefetch):
    ds = counting_dataset()
    perm = ds.epoch_perm(np.random.default_rng(0), 4, shuffle=False)
    seen, stats = [], FeedStats()
    for c, f in prefetch_batches(ds, perm, "cpu", prefetch=prefetch, stats=stats):
        assert c.shape == (4, 1, 2, 2) and c.dtype == torch.float32
        torch.testing.assert_close(f, c + 100.0, rtol=0, atol=0)
        seen.extend(c[:, 0, 0, 0].int().tolist())
    assert seen == list(range(20))
    assert stats.batches == 5 and stats.consumer_wait_ms() == 0.0


def test_prefetch_feed_takes_batches_of_any_size():
    """The test pass hands over full batches and a ragged tail."""
    ds = counting_dataset(7)
    got = [c[:, 0, 0, 0].int().tolist() for c, _ in
           prefetch_batches(ds, [np.array([3, 1, 1]), np.arange(4), np.array([6])], "cpu")]
    assert got == [[3, 1, 1], [0, 1, 2, 3], [6]]


def test_prefetch_feed_raises_the_reader_threads_error():
    class Unreadable:
        shape = (20, 2, 2, 1)

        def __getitem__(self, idx):
            raise OSError("disk gone")

    ds = counting_dataset()
    ds.coarse = Unreadable()
    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_batches(ds, ds.epoch_perm(np.random.default_rng(0), 4), "cpu"))


def test_host_dataset_validates_and_draws_the_device_permutation():
    coarse, fine = synthetic_dataset(n_samples=12, coarse_size=8, fine_size=32, seed=3)
    with pytest.raises(ValueError, match="differ"):
        HostDataset(coarse, fine[:5])
    host = HostDataset(coarse, fine)
    dev = DeviceDataset.from_numpy(coarse, fine, "cpu")
    np.testing.assert_array_equal(host.epoch_perm(np.random.default_rng(7), 4),
                                  dev.epoch_perm(np.random.default_rng(7), 4))


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(n_samples=24, coarse_size=8, fine_size=32, seed=0)


@pytest.fixture(scope="module")
def device_trained(data):
    coarse, fine = data
    trainer = Trainer(tiny_config(), DeviceDataset.from_numpy(coarse[:16], fine[:16], "cpu"),
                      DeviceDataset.from_numpy(coarse[16:], fine[16:], "cpu"), device="cpu",
                      print_every=100)
    trainer.train(epochs=2)
    return trainer


def assert_same_training(a, b):
    """Two trainers took the same trajectory: the same state bit for bit,
    the same epoch means and generator forwards."""
    sa, sb = a.state.state_dict(), b.state.state_dict()
    assert a.state.step == b.state.step
    for part in ("generator", "critic"):
        assert sa[part].keys() == sb[part].keys()
        for k in sa[part]:
            torch.testing.assert_close(sa[part][k], sb[part][k], rtol=0, atol=0)
    for part in ("g_opt", "c_opt"):
        for k, state in sa[part]["state"].items():
            for name, v in state.items():
                torch.testing.assert_close(v, sb[part]["state"][k][name], rtol=0, atol=0)
    assert [{k: r[k] for k in ("train", "test")} for r in a.history] == \
        [{k: r[k] for k in ("train", "test")} for r in b.history]
    assert a.forwards == b.forwards


def test_host_feed_matches_device_trajectory(data, device_trained):
    coarse, fine = data
    host = Trainer(tiny_config(), HostDataset(coarse[:16], fine[:16]),
                   HostDataset(coarse[16:], fine[16:]), device="cpu", print_every=100)
    host.train(epochs=2)
    assert_same_training(device_trained, host)
    assert [s.batches for s in host.feed_stats] == [4, 4] and not device_trained.feed_stats


def test_host_test_pass_matches_the_device_one_with_a_ragged_tail(data, device_trained):
    """7 test samples at batch 4: a batch and a tail of 3, from host RAM
    and from the device, scored by the trained networks."""
    coarse, fine = data
    gen, critic = device_trained.state.generator, device_trained.state.critic
    forwards = []

    def eval_batch(c, f):
        forwards.append(len(c))
        return device_trained._eval(gen, critic, c, f)

    host = full_split_metric_pass(HostDataset(coarse[:7], fine[:7]), 4, eval_batch, "cpu")
    dev = full_split_metric_pass(DeviceDataset.from_numpy(coarse[:7], fine[:7], "cpu"), 4,
                                 eval_batch)
    assert host == dev and forwards == [4, 3, 4, 3]


def test_host_feed_rejects_device_only_paths(data):
    coarse, fine = data
    host = HostDataset(coarse[:8], fine[:8])
    with pytest.raises(ValueError, match="fused_epoch"):
        Trainer(tiny_config().replace(hp=HyperParams(batch_size=4)), host, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        Trainer(tiny_config(schedule="fused"), host, device="cpu")


def test_cli_train_host_feed(tmp_path, capsys):
    """``train --host-feed --synthetic`` forces the per-step reference loop,
    says so, and trains from host RAM."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(tiny_config(fused_epoch=True, schedule="fused", critic_iterations=2)
                   .to_json())
    trainer = main(["train", "--config", str(cfg), "--synthetic", "--samples", "12",
                    "--epochs", "1", "--host-feed", "--device", "cpu",
                    "--tracking-root", str(tmp_path / "exps")])
    out, err = capsys.readouterr()
    assert "host feed: using the per-step loop" in err
    assert isinstance(trainer.train_ds, HostDataset) and isinstance(trainer.test_ds, HostDataset)
    assert trainer.config.hp.schedule == "reference" and not trainer.config.hp.fused_epoch
    record = json.loads(out.strip().splitlines()[-1])
    assert record["steps"] == 2 and np.isfinite(list(record["test"].values())).all()


# ---------------------------------------------------------------------------
# On a CUDA card only.


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: pinned buffers and copy streams exist only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_pinned_ring_refills_only_after_its_copy(cuda_device):
    """A ring of 2 pinned buffers whose copies start late (the copy stream
    first spins ~50 ms on the card) and a slow consumer: batch 2 may not
    overwrite batch 0's buffer before batch 0's copy has read it. Every
    batch arrives intact and in order."""
    late = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(late):
        torch.cuda._sleep(100_000_000)
    n = 24
    coarse = np.arange(n, dtype=np.float32)[:, None, None, None] * np.ones((n, 8, 8, 7),
                                                                          np.float32)
    ds = HostDataset(coarse, np.repeat(np.repeat(coarse[..., :2], 4, 1), 4, 2) + 1000.0)
    perm = ds.epoch_perm(np.random.default_rng(1), 4)
    stats, batches = FeedStats(), []
    for c, f in prefetch_batches(ds, perm, cuda_device, prefetch=2, stats=stats,
                                 copy_stream=late):
        batches.append((c, f))
        torch.cuda._sleep(20_000_000)  # the consumer's step
    torch.cuda.synchronize()
    for (c, f), idx in zip(batches, perm):
        want = torch.as_tensor(idx, dtype=torch.float32, device=cuda_device)
        assert c.shape == (4, 7, 8, 8) and f.shape == (4, 2, 32, 32)
        assert torch.equal(c[:, :, 3, 5], want[:, None].expand(4, 7))
        assert torch.equal(f[:, :, 17, 2], want[:, None].expand(4, 2) + 1000.0)
    assert len(batches) == len(perm) == stats.batches
    assert stats.ring_wait_s > 0 and stats.pinned_bytes == 2 * 4 * (8 * 8 * 7 + 32 * 32 * 2) * 4
    assert stats.consumer_wait_ms() >= 0.0


@pytest.mark.cuda
def test_cuda_host_batches_equal_device_gather(cuda_device, data):
    coarse, fine = data
    host, dev = HostDataset(coarse, fine), DeviceDataset.from_numpy(coarse, fine, cuda_device)
    perm = host.epoch_perm(np.random.default_rng(2), 5)
    for (c, f), idx in zip(prefetch_batches(host, perm, cuda_device), perm):
        want_c, want_f = dev.gather(torch.as_tensor(idx, dtype=torch.long, device=cuda_device))
        assert c.is_contiguous() and torch.equal(c, want_c) and torch.equal(f, want_f)
