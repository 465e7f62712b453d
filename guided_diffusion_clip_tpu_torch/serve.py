"""HTTP sampling server on PyTorch/CUDA: the port of scripts/serve.py.

    python -m guided_diffusion_clip_tpu_torch.serve --model_path model.pt \\
        --image_size 256 --num_channels 256 ... --timestep_respacing ddim25 \\
        --use_ddim True --batch_size 8 --port 8080

    GET  /healthz            -> {"ok": true, "compiled": true, ...}
    POST /sample             <- {"num_samples": 4, "seed": 7,
                                 "clip_feat": [[...512 floats...], ...]
                                 (optional on conditioned models),
                                 "format": "npz" | "png_base64"}
                             -> .npz bytes {"arr_0": uint8 [n,H,W,3]}
                                or JSON {"png_base64": ..., "n": n}

The same flags, endpoints, JSON and npz bytes as scripts/serve.py, plus
``--device`` (default ``cuda``; the model runs where it says, and a missing
card is an error). ``--model_path`` is a reference-format ``.pt`` state_dict.

Requests are padded to the smallest fitting batch bucket (``--batch_buckets``,
routed by the warm latency measured at startup) and sliced back; larger
requests are chunked across chains of the batch size (capped by
``--max_request``). A lock serializes device use; decode/encode runs outside
it. RNG is PER-SAMPLE (``diffusion.sampling.sample_generators``): sample i
draws only from its own generator, seeded from (seed, subidx), so its result
does not depend on padding or co-batched requests. That makes COALESCING
safe: with ``--coalesce_ms W > 0`` concurrent requests that fit in one batch
share one chain.

Not yet ported, and rejected at startup: ``--cfg_scale``, ``--cfg_cache``,
``--guidance_interval``, ``--deep_cache``, ``--conv_impl int8`` and
``--sampler dpm++2m``.
"""

from __future__ import annotations

import argparse
import base64
import collections
import dataclasses
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .diffusion.sampling import sample_generators
from .utils.checkpoint import load_model_weights
from .utils.saving_imgs import tensor2img
from .utils.script_util import (
    add_dict_to_argparser,
    args_to_dict,
    create_model_and_diffusion,
    model_and_diffusion_defaults,
    parse_yaml,
    resolve_sampler,
)

# flag -> its "off" value; any other value is a feature not yet ported
_UNPORTED = {"cfg_scale": 0.0, "cfg_cache": 0, "guidance_interval": "", "deep_cache": 0}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Sampler:
    """Owns the model, the sampling chain, the device lock and the batching."""

    def __init__(self, args):
        for name, off in _UNPORTED.items():
            if getattr(args, name, off) != off:
                raise SystemExit(f"--{name}: not yet ported to the PyTorch package")
        if getattr(args, "conv_impl", "auto") != "auto":
            raise SystemExit(
                f"--conv_impl {args.conv_impl}: not yet ported to the PyTorch package "
                "(convs run through cuDNN in the model's dtype)"
            )
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        if not args.model_path:
            raise SystemExit("--model_path: a reference-format .pt state_dict is required")
        self.args = args
        self.batch = args.batch_size
        model, diffusion = create_model_and_diffusion(
            **args_to_dict(args, model_and_diffusion_defaults().keys())
        )
        load_model_weights(model, args.model_path)
        self.model = model.to(self.device).eval()
        self.diffusion = dataclasses.replace(diffusion, sched=diffusion.sched.to(self.device))
        self.steps = diffusion.num_timesteps
        # the fork's conditioning is the 512-d CLIP embedding (class_cond
        # repurposes NUM_CLASSES=512, reference script_util.py:9)
        self.cond_key = "clip_feat" if args.class_cond else None
        self._loop = resolve_sampler(self.diffusion, args)
        self._lock = threading.Lock()
        self.compiled = False  # "warm": every bucket has run once (healthz name kept)
        self.forwards = 0  # model forwards run, for kernel-launch accounting
        # --batch_buckets: extra SMALLER batch shapes; a request pads only to
        # the fastest fitting bucket instead of the full batch
        raw = str(getattr(args, "batch_buckets", "") or "")
        extra = sorted({int(b) for b in raw.split(",") if b.strip()})
        if any(b < 1 or b > self.batch for b in extra):
            raise SystemExit(
                f"--batch_buckets entries must be in [1, batch_size={self.batch}], got {extra}"
            )
        self.buckets = sorted(set(extra) | {self.batch})
        self.bucket_latency: dict = {}  # bucket -> measured warm s (warmup)
        self.max_request = int(getattr(args, "max_request", 0)) or 8 * self.batch
        if self.max_request < 1:
            raise SystemExit(
                f"--max_request must be >= 1 (got {self.max_request}); a request above "
                f"batch_size ({self.batch}) is served by several serial chains behind "
                f"one HTTP response"
            )
        self.coalesce_ms = float(getattr(args, "coalesce_ms", 0.0))
        self.dispatches = 0
        self.coalesced_requests = 0
        self._closed = False
        self._dispatch_thread = None
        if self.coalesce_ms > 0:
            self._queue: collections.deque = collections.deque()
            self._queue_cv = threading.Condition()
            self._dispatch_thread = threading.Thread(target=self._dispatcher, daemon=True)
            self._dispatch_thread.start()

    def close(self) -> None:
        """Stop the coalescing dispatcher thread (if any)."""
        if self._dispatch_thread is None:
            return
        with self._queue_cv:
            self._closed = True
            self._queue_cv.notify_all()
        self._dispatch_thread.join(timeout=30)
        self._dispatch_thread = None

    def _model_fn(self, x, t, **kw):
        self.forwards += 1
        return self.model(x, t, **kw)

    def _chain(self, seeds, subidx, feats) -> np.ndarray:
        """One sampling chain over the padded batch -> uint8 [B, H, W, 3]."""
        B = len(seeds)
        s = self.args.image_size
        gens = sample_generators(seeds, subidx, self.device)
        model_kwargs = (
            {"clip_feat": torch.from_numpy(feats).to(self.device)} if self.cond_key else {}
        )
        with torch.inference_mode():
            out = self._loop(
                self._model_fn, (B, 3, s, s), gens, clip_denoised=True, model_kwargs=model_kwargs
            )
            img = ((out + 1) * 127.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
            return img.cpu().numpy()

    def warmup(self):
        for b in self.buckets:
            log(f"serve: warming the chain (batch {b}, {self.steps} steps)...")
            out = self.sample(b, seed=0, cond=None)
            assert out.shape == (b, self.args.image_size, self.args.image_size, 3), out.shape
            # time one WARM chain per bucket; routing picks the measured-fastest
            # bucket that fits
            t0 = time.perf_counter()
            self.sample(b, seed=0, cond=None)
            self.bucket_latency[b] = time.perf_counter() - t0
        self.compiled = True
        lat = {b: round(self.bucket_latency[b], 3) for b in self.buckets}
        routed = sorted({self._bucket_for(n) for n in range(1, self.batch + 1)})
        log(
            f"serve: chain warm for buckets {self.buckets}; measured warm latency "
            f"{lat}; effective buckets after latency routing {routed}; serving"
        )

    def _validate(self, n, cond):
        """-> per-sample feat array [n, 512] (zeros when unconditioned)."""
        if not 1 <= n <= self.max_request:
            raise ValueError(
                f"num_samples must be in [1, {self.max_request}] (requests larger than "
                f"the batch of {self.batch} are chunked across chains, capped at --max_request)"
            )
        feats = np.zeros((n, 512), np.float32)
        if cond is not None and self.cond_key is not None:
            arr = np.asarray(cond, np.float32)
            if arr.shape != (n, 512):
                raise ValueError(f"clip_feat must be [{n}, 512], got {list(arr.shape)}")
            feats = arr
        return feats

    def _bucket_for(self, n: int) -> int:
        """Fastest batch shape that fits n samples: by measured warm latency
        when available (post-warmup), else by size; ties break toward the
        smaller shape."""
        fits = [b for b in self.buckets if b >= n]
        measured = [b for b in fits if b in self.bucket_latency]
        if measured:
            return min(measured, key=lambda b: (self.bucket_latency[b], b))
        return min(fits)

    def _run_batch(self, seeds, subidx, feats):
        """Pad per-sample arrays to the fastest fitting bucket and run ONE chain."""
        n = len(seeds)
        pad = self._bucket_for(n) - n
        seeds = np.pad(np.asarray(seeds, np.int64), (0, pad))
        subidx = np.pad(np.asarray(subidx, np.int64), (0, pad))
        feats = np.pad(np.asarray(feats, np.float32), ((0, pad), (0, 0)))
        with self._lock:
            self.dispatches += 1
            out = self._chain(seeds.tolist(), subidx.tolist(), feats)
        return out[:n]

    def sample(self, n, seed, cond):
        feats = self._validate(n, cond)
        seeds = np.full((n,), int(seed), np.int64)
        subidx = np.arange(n, dtype=np.int64)
        # requests larger than the batch are CHUNKED; per-sample RNG makes the
        # chunked result the same as any other packing of the same samples
        chunks = [slice(i, min(i + self.batch, n)) for i in range(0, n, self.batch)]
        if self.coalesce_ms <= 0 or not self.compiled:
            return np.concatenate([self._run_batch(seeds[s], subidx[s], feats[s]) for s in chunks])
        pendings = [_Pending(s.stop - s.start, seeds[s], subidx[s], feats[s]) for s in chunks]
        with self._queue_cv:
            self._queue.extend(pendings)
            self._queue_cv.notify()
        for pending in pendings:
            pending.event.wait()
            if pending.error is not None:
                raise pending.error
        return np.concatenate([p.result for p in pendings])

    def _dispatcher(self):
        """Coalescing loop: the first queued request opens a --coalesce_ms
        window; whatever else fits in the batch by the deadline rides the same
        chain."""
        while True:
            with self._queue_cv:
                while not self._queue and not self._closed:
                    self._queue_cv.wait()
                if self._closed:  # fail whatever is still queued, then stop
                    for pending in self._queue:
                        pending.error = RuntimeError("server closed")
                        pending.event.set()
                    self._queue.clear()
                    return
                items = [self._queue.popleft()]
                used = items[0].n
                deadline = time.monotonic() + self.coalesce_ms / 1000.0
                while used < self.batch:
                    if self._queue and self._queue[0].n <= self.batch - used:
                        items.append(self._queue.popleft())
                        used += items[-1].n
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._queue:
                        break  # window over, or the head doesn't fit
                    self._queue_cv.wait(timeout=remaining)
            if len(items) > 1:
                self.coalesced_requests += len(items)
            try:
                out = self._run_batch(
                    np.concatenate([i.seeds for i in items]),
                    np.concatenate([i.subidx for i in items]),
                    np.concatenate([i.feats for i in items]),
                )
                off = 0
                for i in items:
                    i.result = out[off:off + i.n]
                    off += i.n
            except Exception as e:  # deliver failures to the waiters
                for i in items:
                    i.error = e
            for i in items:
                i.event.set()


class _Pending:
    """One queued request awaiting a coalesced chain."""

    def __init__(self, n, seeds, subidx, feats):
        self.n, self.seeds, self.subidx, self.feats = n, seeds, subidx, feats
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


def make_handler(sampler: Sampler):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # route access logs through ours
            log(f"serve: {self.address_string()} {fmt % a}")

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "unknown path"})
            a = sampler.args
            self._json(200, {
                "ok": True,
                "compiled": sampler.compiled,
                "image_size": a.image_size,
                "batch_size": sampler.batch,
                "steps": sampler.steps,
                "cond": sampler.cond_key,
                "sampler": getattr(a, "sampler", "") or ("ddim" if a.use_ddim else "ancestral"),
                "coalesce_ms": sampler.coalesce_ms,
                "batch_buckets": sampler.buckets,
                "bucket_latency_s": {
                    str(b): round(s, 3) for b, s in sorted(sampler.bucket_latency.items())
                },
                "max_request": sampler.max_request,
                "dispatches": sampler.dispatches,
                "coalesced_requests": sampler.coalesced_requests,
            })

        def do_POST(self):
            if self.path != "/sample":
                return self._json(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                n = int(req.get("num_samples", 1))
                seed = int(req.get("seed", 0))
                cond = req.get(sampler.cond_key) if sampler.cond_key else None
                fmt = req.get("format", "npz")
                imgs = sampler.sample(n, seed, cond)
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            if fmt == "png_base64":
                import cv2

                grid = tensor2img(imgs.astype(np.float32) / 127.5 - 1.0)
                ok, buf = cv2.imencode(".png", grid[..., ::-1])
                if not ok:
                    return self._json(500, {"error": "png encoding failed"})
                return self._json(200, {
                    "n": int(n),
                    "png_base64": base64.b64encode(buf.tobytes()).decode(),
                })
            bio = io.BytesIO()
            np.savez(bio, imgs)
            body = bio.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def create_argparser():
    defaults = dict(
        model_path="",
        device="cuda",
        host="127.0.0.1",
        port=8080,
        batch_size=8,
        seed=0,
        use_ddim=False,
        sampler="",        # "", ancestral, ddim (dpm++2m not yet ported)
        conv_impl="auto",  # int8 not yet ported
        cfg_scale=0.0,     # not yet ported
        cfg_cache=0,       # not yet ported
        guidance_interval="",  # not yet ported
        deep_cache=0,      # not yet ported
        coalesce_ms=0.0,   # >0: batch concurrent requests into one chain
        batch_buckets="",  # e.g. "1,2,4": extra smaller batch shapes
        max_request=0,     # per-request sample cap; 0 = 8x batch_size
        main_path="",
    )
    defaults.update(model_and_diffusion_defaults())
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults)  # also adds --config-file / -d
    return parser


def parse_args(argv=None):
    args = parse_yaml(create_argparser().parse_args(argv))
    if int(getattr(args, "max_request", 0)) < 0:
        raise SystemExit(
            f"--max_request must be >= 1 (got {args.max_request}); 0 means the default 8x batch_size"
        )
    return args


def main(argv=None):
    args = parse_args(argv)
    sampler = Sampler(args)
    sampler.warmup()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(sampler))
    log(f"serve: listening on {args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        sampler.close()


if __name__ == "__main__":
    main()
