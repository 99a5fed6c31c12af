"""The port's serving path against the JAX package's on the same weights:
SRModel, BatchingSRModel, the HTTP protocol and its guards, tiled domain
inference, generate_fields, client/server interoperation, the CLI, and the
CUDA-by-default entry points."""
import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from downgan_tpu.config.config import Config as JaxConfig  # noqa: E402
from downgan_tpu.config.config import HyperParams as JaxHyperParams  # noqa: E402
from downgan_tpu.inference import generate_fields as jax_generate_fields  # noqa: E402
from downgan_tpu.parallel import spatial as jax_spatial  # noqa: E402
from downgan_tpu.serving import SRModel as JaxSRModel  # noqa: E402
from downgan_tpu.serving import generate_remote as jax_generate_remote  # noqa: E402

from downgan_tpu_torch.config.config import Config, HyperParams  # noqa: E402
from downgan_tpu_torch.inference import generate_fields  # noqa: E402
from downgan_tpu_torch.parallel.spatial import (  # noqa: E402
    count_tiled_dispatches,
    tiled_sr_inference,
)
from downgan_tpu_torch.serving import (  # noqa: E402
    BatchingSRModel,
    RequestTooLarge,
    SRModel,
    generate_domain_remote,
    generate_remote,
    serve_model,
)
from downgan_tpu_torch.training.state import make_generator  # noqa: E402
from downgan_tpu_torch.utils.port_weights import generator_state_dict_from_flax  # noqa: E402

from _torch_parity import flax_generator, one_thread  # noqa: E402,F401

ATOL, RTOL = 2e-5, 1e-5  # fp32 on both sides, convs summed in another order
KW = dict(coarse_size=8, fine_size=64, filters=8, num_res_blocks=1, chunk_size=4)


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig(hp=JaxHyperParams(batch_size=4), **KW)
    cfg = Config(hp=HyperParams(batch_size=4), **KW)
    _, params = flax_generator(jcfg, cfg, seed=3)
    weights = generator_state_dict_from_flax(params, num_res_blocks=1, num_upsample=3)
    return jcfg, cfg, params, weights


@pytest.fixture(scope="module")
def jax_model(models):
    jcfg, _, params, _ = models
    return JaxSRModel(jcfg, params, batch_size=4)


@pytest.fixture(scope="module")
def served(models):
    _, cfg, _, weights = models
    model = SRModel(cfg, weights, batch_size=4, device="cpu")
    server = serve_model(model, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield model, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def coarse(n, h=8, w=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, h, w, 7)).astype(np.float32)


def post(url, body, **headers):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/octet-stream", **headers})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    return exc.value.code, exc.value.read().decode()


def test_srmodel_matches_jax(models, jax_model):
    _, cfg, _, weights = models
    x = coarse(6)  # ragged over the serving batch of 4
    got = SRModel(cfg, weights, batch_size=4, device="cpu").generate(x)
    assert got.shape == (6, 64, 64, 2)
    np.testing.assert_allclose(got, jax_model.generate(x), atol=ATOL, rtol=RTOL)


def test_batching_model_coalesces_and_matches_jax(models, jax_model):
    _, cfg, _, weights = models
    plain = SRModel(cfg, weights, batch_size=8, device="cpu")
    model = BatchingSRModel(cfg, weights, batch_size=8, max_wait_ms=50.0, device="cpu")
    try:
        inputs = [coarse(2, seed=i) for i in range(8)]
        results = [None] * len(inputs)
        barrier = threading.Barrier(len(inputs))

        def worker(i):
            barrier.wait()
            results[i] = model.generate(inputs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for x, got in zip(inputs, results):
            np.testing.assert_allclose(got, plain.generate(x), atol=1e-6)
            np.testing.assert_allclose(got, jax_model.generate(x), atol=ATOL, rtol=RTOL)
        assert model.dispatch_count < len(inputs)
        with pytest.raises(ValueError, match="expected"):
            model.generate(np.zeros((1, 5, 5, 7), np.float32))
        assert model.generate(coarse(3)).shape == (3, 64, 64, 2)  # still serving
    finally:
        model.close()
    with pytest.raises(RuntimeError, match="closed"):
        model.generate(coarse(1))


def test_healthz_and_metrics(served):
    model, url = served
    info = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
    assert info == {"status": "ok", "coarse_shape": [8, 8, 7], "fine_shape": [64, 64, 2],
                    "serving_batch": 4, "generator_arch": "rrdb"}
    before = model.stats()
    generate_remote(url, coarse(5))
    stats = json.loads(urllib.request.urlopen(f"{url}/metrics").read())
    assert stats["requests"] == before["requests"] + 1
    assert stats["samples"] == before["samples"] + 5
    assert stats["dispatches"] == before["dispatches"] + 2  # 5 samples at batch 4
    assert stats["serving_batch"] == 4 and stats["latency_ms_p50"] is not None
    assert set(stats) == {"requests", "samples", "dispatches", "serving_batch",
                          "latency_ms_p50", "latency_ms_p95"}


def test_http_guards(served):
    _, url = served
    buf = io.BytesIO()
    np.save(buf, np.zeros((2, 5, 5, 7), np.float32))
    assert post(f"{url}/v1/generate", buf.getvalue())[0] == 400  # bad shape
    buf = io.BytesIO()
    np.save(buf, np.zeros((0, 8, 8, 7), np.float32))
    code, text = post(f"{url}/v1/generate", buf.getvalue())
    assert code == 400 and "at least one sample" in text
    assert post(f"{url}/v1/generate", b"")[0] == 400  # empty body
    big = 8192 * 8 * 8 * 7 * 4 + 8192
    try:
        code = post(f"{url}/v1/generate", b"x" * 16, **{"Content-Length": str(big)})[0]
        assert code == 413
    except (ConnectionError, OSError):
        pass  # the server may close before the client finishes sending
    # a tiny body whose header declares ~7 TB: refused before np.load allocates
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        buf, {"descr": "<f4", "fortran_order": False, "shape": (10**9, 16, 16, 7)})
    code, text = post(f"{url}/v1/generate", buf.getvalue())
    assert code == 400 and "payload" in text
    assert post(f"{url}/v1/nope", b"")[0] == 404


@pytest.mark.parametrize("shape,tile_cols", [((2, 24, 16), 0), ((1, 20, 24), 8)])
def test_tiled_inference_matches_jax(models, shape, tile_cols):
    jcfg, cfg, params, weights = models
    x = coarse(*shape, seed=5)
    kw = dict(tile_rows=8, overlap=4, tile_cols=tile_cols, tiles_per_dispatch=3)
    got = tiled_sr_inference(cfg, weights, x, device="cpu", **kw)
    want = jax_spatial.tiled_sr_inference(jcfg, params, x, **kw)
    assert got.shape == (shape[0], shape[1] * 8, shape[2] * 8, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_count_tiled_dispatches_matches_jax():
    for args in [(2, 24, 16, 8, 0, 2), (1, 25, 16, 8, 8, 8), (4, 24, 24, 8, 8, 8),
                 (2, 56, 112, 16, 0, 8), (3, 7, 9, 4, 4, 1)]:
        assert count_tiled_dispatches(*args) == jax_spatial.count_tiled_dispatches(*args)


def test_domain_endpoint_matches_jax(models, served):
    jcfg, _, params, _ = models
    model, url = served
    x = coarse(2, 24, 16, seed=6)
    before = model.dispatch_count
    got = generate_domain_remote(url, x, tile_rows=8, overlap=4, tiles_per_dispatch=2)
    assert model.dispatch_count == before + 3  # 6 tiles, 2 per dispatch
    want = jax_spatial.tiled_sr_inference(jcfg, params, x, tile_rows=8, overlap=4,
                                          tiles_per_dispatch=2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    huge = generate_domain_remote(url, x, tile_rows=8, overlap=4, tiles_per_dispatch=10**9)
    np.testing.assert_allclose(huge, got, atol=1e-6)
    for bad in (dict(tiles_per_dispatch=0), dict()):
        sub = x if bad else x[:, :8]  # a domain smaller than one band
        with pytest.raises(urllib.error.HTTPError) as exc:
            generate_domain_remote(url, sub, tile_rows=8, overlap=4, **bad)
        assert exc.value.code == 400


def test_domain_output_cap(models):
    _, cfg, _, weights = models
    model = SRModel(cfg, weights, batch_size=4, max_domain_output_bytes=1000, device="cpu")
    with pytest.raises(RequestTooLarge):
        model.generate_domain(np.zeros((1, 24, 16, 7), np.float32), tile_rows=8, overlap=4)
    assert model.dispatch_count == 0
    server = serve_model(model, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            generate_domain_remote(f"http://127.0.0.1:{server.server_address[1]}",
                                   np.zeros((1, 24, 16, 7), np.float32), tile_rows=8, overlap=4)
        assert exc.value.code == 413
    finally:
        server.shutdown()
        server.server_close()


def test_generate_fields_matches_jax(models):
    jcfg, cfg, params, weights = models
    x = coarse(6, seed=7)  # ragged tail over chunk 4
    got = generate_fields(cfg, weights, x, device="cpu")
    np.testing.assert_allclose(got, jax_generate_fields(jcfg, params, x), atol=ATOL, rtol=RTOL)


def test_jax_client_against_port_server(models, served, jax_model):
    _, url = served
    x = coarse(3, seed=8)
    np.testing.assert_allclose(jax_generate_remote(url, x), jax_model.generate(x),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("entry", ["make_generator", "SRModel", "BatchingSRModel",
                                   "generate_fields", "tiled_sr_inference"])
def test_entry_points_default_to_cuda(models, entry):
    _, cfg, _, weights = models
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    calls = {
        "make_generator": lambda: make_generator(cfg),
        "SRModel": lambda: SRModel(cfg, weights),
        "BatchingSRModel": lambda: BatchingSRModel(cfg, weights),
        "generate_fields": lambda: generate_fields(cfg, weights, coarse(1)),
        "tiled_sr_inference": lambda: tiled_sr_inference(cfg, weights, coarse(1, 24, 16)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_cli_serve_on_cpu(models, tmp_path):
    _, cfg, _, weights = models
    (tmp_path / "config.json").write_text(cfg.to_json())
    torch.save(dict(weights), tmp_path / "generator.pt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "downgan_tpu_torch.cli", "serve", "--config",
         str(tmp_path / "config.json"), "--weights", str(tmp_path / "generator.pt"),
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--serving-batch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "SR inference on http://127.0.0.1:" in line, proc.stderr.read()
        url = line.split()[3]
        assert json.loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())["status"] == "ok"
        x = coarse(3, seed=9)
        want = SRModel(cfg, weights, batch_size=4, device="cpu").generate(x)
        np.testing.assert_allclose(generate_remote(url, x), want, atol=1e-6)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
