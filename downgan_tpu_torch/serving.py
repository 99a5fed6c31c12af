"""HTTP inference service for super-resolution generation (counterpart of
``downgan_tpu/serving.py``, same protocol, so clients and servers of the two
packages interoperate).

Protocol:
  * ``GET /healthz``  -> ``{"status": "ok", ...}``
  * ``GET /metrics``  -> request/sample/dispatch counters and p50/p95
    request latency
  * ``POST /v1/generate`` with a .npy body of coarse covariates
    (N, h, w, C) float32 -> .npy body of generated (N, H, W, P)
  * ``POST /v1/generate-domain?tile_rows=16&overlap=8&tile_cols=0&``
    ``tiles_per_dispatch=8`` with a .npy body of arbitrary-size coarse
    fields (B, H, W, C) -> .npy of (B, H*sf, W*sf, P) by overlap-tiled
    inference. Domain requests bypass coalescing and are bounded by a body
    cap and an estimated-output cap (413).

The wire format is NHWC .npy; the model runs NCHW on the device, and the
transposes happen there. Clients send covariates only: a stochastic
generator (``noise_channels > 0``) serves the fixed latent realization,
appended on the host, so the same request always returns the same fields. Every device call runs under
``torch.inference_mode()``, entered by the thread that makes it.

Client: ``generate_remote(url, coarse)``.
Run: ``python -m downgan_tpu_torch.cli serve --config c.json --weights g.pt``.
"""
from __future__ import annotations

import collections
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from downgan_tpu_torch.config.config import Config
from downgan_tpu_torch.parallel.spatial import (count_tiled_dispatches, generator_replicas,
                                                tiled_generate)
from downgan_tpu_torch.training.state import load_generator
from downgan_tpu_torch.training.wgan import fixed_latent


class RequestTooLarge(ValueError):
    """A request's input or estimated output exceeds the serving caps."""


class SRModel:
    """The generator on one device with fixed-batch padding; thread-safe.

    ``weights`` is a reference-layout generator state dict (what
    ``export-torch`` writes). Patch requests run on ``device``. Domain
    requests split each dispatch's tiles over a replica on each of
    ``devices`` (default: the patch generator alone), as the JAX package's
    ``mesh=`` shards them; the fields are those of one device."""

    def __init__(self, config: Config, weights: Mapping[str, torch.Tensor],
                 batch_size: int = 0, max_request_samples: int = 8192,
                 max_domain_output_bytes: int = 1 << 30,
                 device: str | torch.device = "cuda",
                 devices: Optional[Sequence[str | torch.device]] = None):
        self.config = config
        self.batch = batch_size or config.chunk_size
        self._gen = load_generator(config, weights, device)
        self.device = next(self._gen.parameters()).device
        self._replicas = ([self._gen] if devices is None
                          else generator_replicas(config, weights, devices))
        # A stochastic generator serves the fixed latent (wgan.fixed_latent):
        # row i of every serving-batch block gets row i of this one block,
        # laid out per request (_augment), so a request coalesced with other
        # traffic gets the latents, and the fields, of a direct call.
        k, cs = config.noise_channels, config.coarse_size
        self._latent = fixed_latent(config, (self.batch, cs, cs, k)) if k else None
        self._lock = threading.Lock()
        # Observability counters (GET /metrics).
        self.dispatch_count = 0
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._samples = 0
        self._latencies_ms: "collections.deque[float]" = collections.deque(maxlen=512)
        # Request-body cap: max_request_samples coarse patches plus .npy
        # header slack, refused with 413 before the body is read.
        per_sample = config.coarse_size * config.coarse_size * config.n_covariates * 4
        self.max_request_bytes = max_request_samples * per_sample + 4096
        # Domain bodies carry whole fields; their binding bound is the
        # output cap, since the output is ~sf^2 * (P/C) times the input.
        self.max_domain_request_bytes = 4 * self.max_request_bytes
        self.max_domain_output_bytes = max_domain_output_bytes

    def check_domain_output(self, shape) -> None:
        """Reject a domain request whose output allocation would exceed the
        cap, before any compute: B * (H*sf) * (W*sf) * n_predictands * 4."""
        b, h, w = int(shape[0]), int(shape[1]), int(shape[2])
        sf = 2 ** self.config.num_upsample
        out_bytes = b * (h * sf) * (w * sf) * self.config.n_predictands * 4
        if out_bytes > self.max_domain_output_bytes:
            raise RequestTooLarge(
                f"estimated output {out_bytes} bytes for input shape "
                f"{tuple(shape)} exceeds cap {self.max_domain_output_bytes}")

    def _validate_patches(self, coarse: np.ndarray) -> None:
        """The request contract of the patch endpoints, direct and coalesced."""
        cs, c = self.config.coarse_size, self.config.n_covariates
        if coarse.ndim != 4 or coarse.shape[1:] != (cs, cs, c):
            raise ValueError(f"expected (N, {cs}, {cs}, {c}) float32, got {coarse.shape}")
        if coarse.shape[0] == 0:
            raise ValueError("empty request: need at least one sample")

    def _pad_blocks(self, union: np.ndarray):
        """Serving-batch blocks of ``union`` (the last one zero-padded) with
        the pad count: the one padding rule of every dispatch path."""
        for start in range(0, union.shape[0], self.batch):
            block = union[start:start + self.batch]
            pad = self.batch - block.shape[0]
            if pad:
                block = np.concatenate([block, np.zeros((pad, *block.shape[1:]), block.dtype)])
            yield block, pad

    def _augment(self, coarse: np.ndarray) -> np.ndarray:
        """``coarse`` with the fixed latent appended as channels, in the
        request's own padded-block layout: sample j of the request gets
        latent row ``j % batch``."""
        if self._latent is None:
            return coarse
        n = coarse.shape[0]
        z = np.concatenate([self._latent[:min(self.batch, n - s)]
                            for s in range(0, n, self.batch)])
        return np.concatenate([coarse, z], axis=-1)

    def _forward(self, block: np.ndarray) -> np.ndarray:
        """One generator dispatch: NHWC host block -> NHWC host fields."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(block, np.float32)).to(self.device)
            y = self._gen(x.permute(0, 3, 1, 2).contiguous())
            return y.permute(0, 2, 3, 1).cpu().numpy()

    def _run_blocks(self, coarse: np.ndarray) -> np.ndarray:
        outs = []
        with self._lock:  # serialized device access
            for block, pad in self._pad_blocks(coarse):
                fake = self._forward(block)
                self.dispatch_count += 1
                outs.append(fake[:self.batch - pad] if pad else fake)
        return np.concatenate(outs, axis=0)

    def generate(self, coarse: np.ndarray) -> np.ndarray:
        self._validate_patches(coarse)
        t0 = time.perf_counter()
        fields = self._run_blocks(self._augment(np.asarray(coarse, np.float32)))
        self._record(coarse.shape[0], time.perf_counter() - t0)
        return fields

    def generate_domain(self, coarse: np.ndarray, tile_rows: int = 16,
                        overlap: int = 8, tile_cols: int = 0,
                        tiles_per_dispatch: int = 8) -> np.ndarray:
        """Overlap-tiled SR over arbitrary-size fields (B, H, W, C), the
        serving surface of :func:`parallel.spatial.tiled_sr_inference`.
        Serialized against all other device work on the model lock;
        ``/metrics`` counts the tiler's real dispatches."""
        if coarse.ndim != 4 or coarse.shape[-1] != self.config.n_covariates:
            raise ValueError(f"expected (B, H, W, {self.config.n_covariates}) "
                             f"float32, got {coarse.shape}")
        if tile_rows < 1 or overlap < 0 or tile_cols < 0:
            raise ValueError(f"invalid tiling: tile_rows={tile_rows} (>=1), "
                             f"overlap={overlap} (>=0), tile_cols={tile_cols} (>=0)")
        if tiles_per_dispatch < 1:
            raise ValueError(f"tiles_per_dispatch must be >= 1, got {tiles_per_dispatch}")
        self.check_domain_output(coarse.shape)
        t0 = time.perf_counter()
        b, h, w, _ = coarse.shape
        # Clamp the client-supplied fold to the real tile count, so it
        # cannot force a huge padded dispatch.
        n_tiles = b * -(-h // tile_rows) * (-(-w // tile_cols) if tile_cols else 1)
        tiles_per_dispatch = min(tiles_per_dispatch, n_tiles)
        with self._lock:
            out = tiled_generate(self._replicas, self.config, np.asarray(coarse, np.float32),
                                 tile_rows=tile_rows, overlap=overlap, tile_cols=tile_cols,
                                 tiles_per_dispatch=tiles_per_dispatch)
            self.dispatch_count += count_tiled_dispatches(
                b, h, w, tile_rows, tile_cols, tiles_per_dispatch, len(self._replicas))
        self._record(b, time.perf_counter() - t0)
        return out

    def _record(self, n_samples: int, seconds: float) -> None:
        with self._stats_lock:
            self._requests += 1
            self._samples += n_samples
            self._latencies_ms.append(seconds * 1e3)

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies_ms)
            # nearest-rank percentile: index ceil(p*n) - 1
            pct = (lambda p: round(lat[max(0, math.ceil(p * len(lat) - 1e-9) - 1)], 2)) \
                if lat else (lambda p: None)
            return {
                "requests": self._requests,
                "samples": self._samples,
                "dispatches": self.dispatch_count,
                "serving_batch": self.batch,
                "latency_ms_p50": pct(0.50),
                "latency_ms_p95": pct(0.95),
            }


class BatchingSRModel(SRModel):
    """SRModel that coalesces concurrent requests: requests enqueue their
    samples, and a worker thread drains the queue (lingering up to
    ``max_wait_ms`` for stragglers once the first request arrives), runs
    one padded forward over the union and scatters the slices back.
    Per-sample results equal :meth:`SRModel.generate`'s (same padding, and
    every sample is computed independently of its batch neighbours)."""

    def __init__(self, config: Config, weights: Mapping[str, torch.Tensor],
                 batch_size: int = 0, max_request_samples: int = 8192,
                 max_wait_ms: float = 5.0, max_domain_output_bytes: int = 1 << 30,
                 device: str | torch.device = "cuda",
                 devices: Optional[Sequence[str | torch.device]] = None):
        super().__init__(config, weights, batch_size=batch_size,
                         max_request_samples=max_request_samples,
                         max_domain_output_bytes=max_domain_output_bytes,
                         device=device, devices=devices)
        self.max_wait_ms = max_wait_ms
        self._queue: "list[tuple[np.ndarray, list, threading.Event]]" = []
        self._cv = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(target=self._drain_loop, daemon=True)
        self._worker.start()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5)

    def generate(self, coarse: np.ndarray) -> np.ndarray:
        self._validate_patches(coarse)
        t0 = time.perf_counter()
        # The latent is appended per request, before coalescing.
        coarse = self._augment(np.asarray(coarse, np.float32))
        slot: list = [None]
        done = threading.Event()
        with self._cv:
            if self._stop:
                raise RuntimeError("BatchingSRModel is closed")
            self._queue.append((coarse, slot, done))
            self._cv.notify()
        done.wait()
        if isinstance(slot[0], BaseException):
            raise slot[0]
        self._record(coarse.shape[0], time.perf_counter() - t0)
        return slot[0]

    def _drain_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                # Linger briefly so concurrent clients share a dispatch.
                deadline = time.monotonic() + self.max_wait_ms / 1e3
                while (sum(a.shape[0] for a, _, _ in self._queue) < self.batch
                       and not self._stop):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                work, self._queue = self._queue, []
            # Two-phase delivery: assign every slot first and signal after,
            # so no client wakes to a slot a later failure overwrites.
            try:
                fields = self._run_blocks(np.concatenate([a for a, _, _ in work], axis=0))
                offset = 0
                for arr, slot, _ in work:
                    slot[0] = fields[offset:offset + arr.shape[0]]
                    offset += arr.shape[0]
            except BaseException as exc:  # deliver the failure to every waiter
                for _, slot, _ in work:
                    slot[0] = exc
            finally:
                for _, _, done in work:
                    done.set()


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _load_npy_checked(body: bytes) -> np.ndarray:
    """Decode a .npy body, checking the header's declared payload against
    the bytes present first: np.load allocates from the declared shape, so
    a tiny body declaring a huge array would otherwise attempt that
    allocation despite the Content-Length cap."""
    buf = io.BytesIO(body)
    version = np.lib.format.read_magic(buf)
    if version == (1, 0):
        shape, _, dtype = np.lib.format.read_array_header_1_0(buf)
    elif version == (2, 0):
        shape, _, dtype = np.lib.format.read_array_header_2_0(buf)
    else:
        raise ValueError(f"unsupported .npy format version {version}")
    declared = math.prod(shape) * dtype.itemsize  # Python ints: no overflow
    remaining = len(body) - buf.tell()
    if declared != remaining:
        raise ValueError(f".npy header declares {declared} payload bytes but the "
                         f"body carries {remaining}")
    buf.seek(0)
    return np.load(buf, allow_pickle=False)


class _Handler(BaseHTTPRequestHandler):
    model: SRModel = None  # injected by serve_model

    def log_message(self, *args) -> None:
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._send(code, json.dumps({"error": message}).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            cfg = self.model.config
            body = json.dumps({
                "status": "ok",
                "coarse_shape": [cfg.coarse_size, cfg.coarse_size, cfg.n_covariates],
                "fine_shape": [cfg.fine_size, cfg.fine_size, cfg.n_predictands],
                "serving_batch": self.model.batch,
                "generator_arch": cfg.generator_arch,
            }).encode()
            self._send(200, body, "application/json")
        elif self.path == "/metrics":
            self._send(200, json.dumps(self.model.stats()).encode(), "application/json")
        else:
            self._send(404, b"{}", "application/json")

    def do_POST(self) -> None:  # noqa: N802
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(self.path)
        if parsed.path not in ("/v1/generate", "/v1/generate-domain"):
            self._send(404, b"{}", "application/json")
            return
        domain_mode = parsed.path == "/v1/generate-domain"
        q = parse_qs(parsed.query)
        cap = (self.model.max_domain_request_bytes if domain_mode
               else self.model.max_request_bytes)
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length > cap:
                self._error(413, f"request body {length} bytes exceeds cap {cap}")
                return
            coarse = _load_npy_checked(self.rfile.read(length))
        except (ValueError, OSError, EOFError) as exc:  # bad .npy body
            self._error(400, str(exc))
            return
        try:
            if domain_mode:
                fields = self.model.generate_domain(
                    np.asarray(coarse, np.float32),
                    tile_rows=int(q.get("tile_rows", ["16"])[0]),
                    overlap=int(q.get("overlap", ["8"])[0]),
                    tile_cols=int(q.get("tile_cols", ["0"])[0]),
                    tiles_per_dispatch=int(q.get("tiles_per_dispatch", ["8"])[0]),
                )
            else:
                fields = self.model.generate(np.asarray(coarse, np.float32))
        except RequestTooLarge as exc:  # output-allocation cap
            self._error(413, str(exc))
            return
        except ValueError as exc:  # shape rejection
            self._error(400, str(exc))
            return
        except Exception as exc:  # device/worker failure: answer, don't reset
            self._error(503, str(exc))
            return
        self._send(200, _npy_bytes(fields), "application/octet-stream")


def serve_model(model: SRModel, host: str = "0.0.0.0", port: int = 8080) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"model": model})
    return ThreadingHTTPServer((host, port), handler)


def _post_npy(endpoint: str, arr: np.ndarray) -> np.ndarray:
    """POST a float32 array as .npy, return the decoded .npy response."""
    import urllib.request

    req = urllib.request.Request(endpoint, data=_npy_bytes(np.asarray(arr, np.float32)),
                                 headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req) as resp:
        return np.load(io.BytesIO(resp.read()), allow_pickle=False)


def generate_remote(url: str, coarse: np.ndarray) -> np.ndarray:
    """Client helper: POST covariates, return generated fields."""
    return _post_npy(f"{url.rstrip('/')}/v1/generate", coarse)


def generate_domain_remote(url: str, coarse: np.ndarray, tile_rows: int = 16,
                           overlap: int = 8, tile_cols: int = 0,
                           tiles_per_dispatch: int = 8) -> np.ndarray:
    """Client helper for arbitrary-size fields: POST (B, H, W, C), get
    (B, H*r, W*r, P) from the server's overlap-tiled inference."""
    return _post_npy(
        f"{url.rstrip('/')}/v1/generate-domain"
        f"?tile_rows={tile_rows}&overlap={overlap}&tile_cols={tile_cols}"
        f"&tiles_per_dispatch={tiles_per_dispatch}",
        coarse,
    )
