"""HTTP sampling server on PyTorch/CUDA: the port of scripts/serve.py.

    python -m guided_diffusion_clip_tpu_torch.serve --model_path model.pt \\
        --image_size 256 --num_channels 256 ... --timestep_respacing ddim25 \\
        --use_ddim True --batch_size 8 --port 8080

    GET  /healthz            -> {"ok": true, "compiled": true, ...,
                                 "forwards": n, "kernel_launches": {...}}
    POST /sample             <- {"num_samples": 4, "seed": 7,
                                 "clip_feat": [[...512 floats...], ...]
                                 (optional on conditioned models),
                                 "format": "npz" | "png_base64"}
                             -> .npz bytes {"arr_0": uint8 [n,H,W,3]}
                                or JSON {"png_base64": ..., "n": n}

The same flags, endpoints, JSON and npz bytes as scripts/serve.py, plus
``--device`` (default ``cuda``; the model runs where it says, and a missing
card is an error) and two keys of /healthz: ``forwards``, the model forwards
run so far, and ``kernel_launches``, each kernel's launches in the server's
process (``ops.launch_counts``), so that a client in another process can
check which kernels the chains ran. ``--model_path`` is a reference-format
``.pt`` state_dict.
``--conv_impl int8`` runs the convs on the int8 path (kernels K4 and K5);
``auto`` and ``xla`` run them through cuDNN in the model's dtype.

Requests are padded to the smallest fitting batch bucket (``--batch_buckets``,
routed by the warm latency measured at startup) and sliced back; larger
requests are chunked across chains of the batch size (capped by
``--max_request``). A lock serializes device use; decode/encode runs outside
it. RNG is PER-SAMPLE (``diffusion.sampling.sample_generators``): sample i
draws only from its own generator, seeded from (seed, subidx), so its result
does not depend on padding or co-batched requests. That makes COALESCING
safe: with ``--coalesce_ms W > 0`` concurrent requests that fit in one batch
share one chain. Under ``--conv_impl int8`` that independence does not hold,
in the JAX server as here: the per-tensor activation scale of ``int8_conv``
spans the whole batch, so a sample's bytes depend on what it was batched
with (the same request served the same way gives the same bytes).

``--cfg_scale S`` serves classifier-free guidance against the null
conditioning ``clip_feat = 0`` (one doubled batch a step); ``--cfg_cache N``
recomputes the unconditional branch one step in N and ``--guidance_interval
lo,hi`` restricts CFG to a window of model timesteps (both need
``--cfg_scale``); ``--deep_cache N`` reuses the deep sub-UNet between
refreshes (not together with ``--cfg_scale``); ``--sampler dpm++2m`` is the
second-order solver.
"""

from __future__ import annotations

import argparse
import base64
import collections
import dataclasses
import functools
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .diffusion.deep_cache import deep_cache_model_fn, zero_state
from .diffusion.guidance import (
    cfg_cached_model_fn,
    cfg_cached_state0,
    cfg_model_fn,
    parse_guidance_interval,
)
from .diffusion.sampling import sample_generators
from .models.unet import CONV_IMPLS
from .ops import launch_counts
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

# classifier-free guidance runs against this null conditioning
_NULL_COND = {"clip_feat": 0.0}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Sampler:
    """Owns the model, the sampling chain, the device lock and the batching."""

    def __init__(self, args):
        if getattr(args, "conv_impl", "auto") not in CONV_IMPLS:
            raise SystemExit(f"--conv_impl {args.conv_impl!r}: choose from {CONV_IMPLS}")
        self.device = torch.device(args.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        self.cfg_scale = float(getattr(args, "cfg_scale", 0.0))
        self.cfg_cache = int(getattr(args, "cfg_cache", 0))
        self.deep_cache = int(getattr(args, "deep_cache", 0))
        self.g_interval = parse_guidance_interval(getattr(args, "guidance_interval", ""))
        if self.cfg_scale and not args.class_cond:
            raise SystemExit("--cfg_scale needs a conditioned model (--class_cond)")
        if self.g_interval is not None and not self.cfg_scale:
            raise SystemExit("serve: --guidance_interval gates CFG; it needs --cfg_scale")
        if self.cfg_cache > 1 and not self.cfg_scale:
            raise SystemExit("serve: --cfg_cache caches the CFG uncond branch; it needs --cfg_scale")
        if self.cfg_scale and self.deep_cache > 1:
            raise SystemExit("serve: use --deep_cache or --cfg_scale, not both")
        if not args.model_path:
            raise SystemExit("--model_path: a reference-format .pt state_dict is required")
        self.args = args
        self.batch = args.batch_size
        # the model built on its device: the initializer, which the loaded weights replace, runs there
        with torch.device(self.device):
            model, diffusion = create_model_and_diffusion(
                **args_to_dict(args, model_and_diffusion_defaults().keys()), conv_impl=args.conv_impl)
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

    def _stateful_model(self, B: int):
        """The chain's model function and its initial state (None for a
        stateless one), from the CFG and DeepCache flags."""
        if self.cfg_scale:
            if self.cfg_cache > 1:
                # cached uncond branch: (1 + 1/N) model calls a step
                fn = cfg_cached_model_fn(
                    self._model_fn, self.cfg_scale, _NULL_COND, self.cfg_cache, interval=self.g_interval
                )
                s = self.args.image_size
                out_shape = (B, self.model.config.out_channels, s, s)
                return fn, cfg_cached_state0(out_shape, device=self.device)
            return cfg_model_fn(self._model_fn, self.cfg_scale, _NULL_COND, interval=self.g_interval), None
        if self.deep_cache > 1:
            def apply_shallow(x, t, deep, **kw):
                return self._model_fn(x, t, deep_cache=deep, cache_mode="shallow", **kw)

            fn = deep_cache_model_fn(
                functools.partial(self._model_fn, cache_mode="full"), apply_shallow, self.deep_cache
            )
            return fn, zero_state(self.model.config, B, dtype=self.model.dtype, device=self.device)
        return self._model_fn, None

    def _chain(self, seeds, subidx, feats) -> np.ndarray:
        """One sampling chain over the padded batch -> uint8 [B, H, W, 3]."""
        B = len(seeds)
        s = self.args.image_size
        gens = sample_generators(seeds, subidx, self.device)
        model_kwargs = (
            {"clip_feat": torch.from_numpy(feats).to(self.device)} if self.cond_key else {}
        )
        model_fn, state0 = self._stateful_model(B)
        with torch.inference_mode():
            out = self._loop(
                model_fn, (B, 3, s, s), gens, clip_denoised=True, model_kwargs=model_kwargs,
                model_state0=state0,
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
                "forwards": sampler.forwards,
                "kernel_launches": launch_counts(),
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
        sampler="",        # "", ancestral, ddim or dpm++2m
        conv_impl="auto",  # auto or xla: cuDNN; int8: kernels K4 and K5
        cfg_scale=0.0,     # >0: classifier-free guidance scale (conditioned models)
        cfg_cache=0,       # N>1: recompute the CFG uncond branch 1 step in N
        guidance_interval="",  # "lo,hi": CFG only for t in [lo, hi] (original units)
        deep_cache=0,      # N>1: DeepCache deep-feature reuse interval
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
