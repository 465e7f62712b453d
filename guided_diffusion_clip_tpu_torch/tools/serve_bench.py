"""Measure the HTTP server's latency and request rate on the card.

    python -m guided_diffusion_clip_tpu_torch.tools.serve_bench [--device cuda]

Counterpart of ``tools/serve_bench.py``: writes a random-init checkpoint of
the ADM-256 configuration (the fork's UNet at bench.py's widths, unconditioned;
N(0, 0.02) weights in the reference's ``state_dict`` names, keyed by size and
channels, so a file of another configuration is never served), starts
``python -m guided_diffusion_clip_tpu_torch.serve`` on it as a subprocess,
waits on ``/healthz``, then times single requests from one client: the warm
latency (best and median of ``SB_REQUESTS``) and the sustained rate of
back-to-back requests. Serving latency does not depend on the weights.

Environment, as the JAX tool's: ``SB_BATCH`` (8), ``SB_IMAGE_SIZE`` (256),
``SB_CH`` (256 at 256 px, else 192), ``SB_RESPACING`` (ddim25),
``SB_CONV_IMPL`` (int8: kernels K4 and K5), ``SB_REQUESTS`` (6),
``SB_NUM_SAMPLES`` (the batch), ``SB_HEALTH_BUDGET`` (900 s for the server to
come up warm); ``SB_COALESCE_MS`` > 0 starts the server with
``--coalesce_ms`` and also times ``SB_CONCURRENCY`` (4) parallel clients,
``SB_REQUESTS`` rounds; ``SB_BUCKETS`` (e.g. ``1,2,4``) starts it with
``--batch_buckets`` and also gives each bucket's best latency of three
requests (``latency_n{b}_best_s``). ``SB_CKPT_DIR`` (the temporary
directory) is where the checkpoint is kept between runs.

A server that exits, or is not warm within ``SB_HEALTH_BUDGET``, ends the
tool with a non-zero exit and the server's last output; the server is
stopped on every way out.

One JSON line with the JAX tool's keys and ``card``, the card's name and
power limit. ``main`` returns that row and, under ``server``, the server's
last ``/healthz`` (its model forwards and each kernel's launches), which the
line leaves out. ``--device cpu`` serves on the CPU with the plain versions,
for rehearsing the tool only: it prints latencies but no rate.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import torch

from ..utils.script_util import create_model
from ._timing import built_on, card_label, pick_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def model_flags(size: int, ch: int) -> list:
    """The server's model and diffusion flags (tools/serve_bench.py:89-103)."""
    return [
        "--image_size", str(size), "--num_channels", str(ch), "--num_res_blocks", "2",
        "--attention_resolutions", "32,16,8", "--num_heads", "4", "--num_head_channels", "64",
        "--use_scale_shift_norm", "True", "--resblock_updown", "True", "--learn_sigma", "True",
        "--class_cond", "False", "--use_fp16", "True", "--diffusion_steps", "1000",
        "--noise_schedule", "linear",
    ]


def make_ckpt(path: str, size: int, ch: int, device=torch.device("cpu")) -> None:
    """A reference-format .pt of the configuration, every weight N(0, 0.02)
    (seed 0) drawn on ``device`` (``_timing.built_on``: no initializer runs
    on the host), written under a temporary name and renamed, so that an
    interrupted write never leaves a file behind."""
    model = built_on(lambda: create_model(
        size, ch, 2, learn_sigma=True, class_cond=False, attention_resolutions="32,16,8", num_heads=4,
        num_head_channels=64, use_scale_shift_norm=True, resblock_updown=True, use_fp16=False,
    ), device, 0)
    part = f"{path}.{os.getpid()}.part"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, part)
    os.replace(part, path)


def _tail(f, n: int = 3000) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")[-n:]


def _get(url: str, timeout: float = 5) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def wait_warm(proc, out, url: str, budget: float, t0: float) -> float:
    """Seconds from ``t0`` until the server's /healthz says it is warm; exits
    with the server's last output if it dies or is not warm within ``budget``."""
    while time.time() - t0 < budget:
        if proc.poll() is not None:
            raise SystemExit(f"server died rc={proc.returncode}:\n{_tail(out)}")
        try:
            if _get(f"{url}/healthz").get("compiled"):
                return time.time() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(1.0)
    raise SystemExit(f"server never became healthy within {budget:.0f} s:\n{_tail(out)}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    card = card_label(device)
    t0 = time.time()
    B = int(os.environ.get("SB_BATCH", 8))
    size = int(os.environ.get("SB_IMAGE_SIZE", 256))
    respacing = os.environ.get("SB_RESPACING", "ddim25")
    conv_impl = os.environ.get("SB_CONV_IMPL", "int8")
    n_req = int(os.environ.get("SB_REQUESTS", 6))
    n_samp = int(os.environ.get("SB_NUM_SAMPLES", B))
    ch = int(os.environ.get("SB_CH", 256 if size == 256 else 192))
    coalesce_ms = float(os.environ.get("SB_COALESCE_MS", 0))
    concurrency = int(os.environ.get("SB_CONCURRENCY", 4))
    buckets = os.environ.get("SB_BUCKETS", "")
    budget = float(os.environ.get("SB_HEALTH_BUDGET", 900))

    ckpt = os.path.join(os.environ.get("SB_CKPT_DIR", tempfile.gettempdir()), f"serve_bench_ckpt_{size}_{ch}.pt")
    if not os.path.exists(ckpt):
        log(f"[sb +{time.time() - t0:.0f}s] writing random-init ckpt {ckpt}")
        make_ckpt(ckpt, size, ch, device)

    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    argv_server = [
        sys.executable, "-m", "guided_diffusion_clip_tpu_torch.serve", "--model_path", ckpt,
        *model_flags(size, ch), "--timestep_respacing", respacing, "--conv_impl", conv_impl,
        "--batch_size", str(B), "--coalesce_ms", str(coalesce_ms), "--batch_buckets", buckets,
        "--port", str(port), "--device", device.type,
    ]
    with tempfile.TemporaryFile() as out:
        proc = subprocess.Popen(argv_server, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        try:
            compiled_at = wait_warm(proc, out, url, budget, t0)
            log(f"[sb +{time.time() - t0:.0f}s] warm")

            def request(seed: int, n: int = n_samp) -> float:
                payload = json.dumps({"num_samples": n, "seed": seed, "format": "npz"}).encode()
                req = urllib.request.Request(f"{url}/sample", data=payload,
                                             headers={"Content-Type": "application/json"}, method="POST")
                t = time.time()
                with urllib.request.urlopen(req, timeout=600) as r:
                    r.read()
                return time.time() - t

            warm_s = request(0)
            lat = sorted(request(1 + i) for i in range(n_req))
            t = time.time()
            for i in range(n_req):
                request(100 + i)
            sustained_s = (time.time() - t) / n_req

            on_card = device.type == "cuda"  # a CPU rehearsal prints no rate
            extra = {}
            if buckets:
                # small-request latency per bucket: without buckets an n=1 request pays the full batch's chain
                extra["batch_buckets"] = buckets
                for nb in sorted({int(b) for b in buckets.split(",") if b} | {B}):
                    extra[f"latency_n{nb}_best_s"] = min(request(2000 + nb * 10 + i, nb) for i in range(3))
            if coalesce_ms > 0:
                # concurrent clients, n_req rounds: with coalescing the server packs each round's
                # requests into as few chains as the batch allows
                d0 = _get(f"{url}/healthz")["dispatches"]
                t = time.time()
                with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
                    for rnd in range(n_req):
                        list(pool.map(request, [1000 + rnd * concurrency + i for i in range(concurrency)]))
                conc_s = (time.time() - t) / n_req
                h = _get(f"{url}/healthz")
                extra.update({
                    "coalesce_ms": coalesce_ms,
                    "concurrency": concurrency,
                    "concurrent_round_s": conc_s,
                    "concurrent_samples_per_min": concurrency * n_samp * 60.0 / conc_s if on_card else None,
                    "dispatches_for_concurrent_rounds": h["dispatches"] - d0,
                    "coalesced_requests": h["coalesced_requests"],
                })
            server = _get(f"{url}/healthz")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    row = {
        "config": f"serve {size}px {respacing} {conv_impl}, batch {B}, {n_samp} samples/request, npz response",
        "compile_to_healthy_s": compiled_at,
        "first_request_s": warm_s,
        "warm_latency_best_s": lat[0],
        "warm_latency_median_s": lat[len(lat) // 2],
        "sustained_sec_per_request": sustained_s,
        "requests_per_min": 60.0 / sustained_s if on_card else None,
        "samples_per_min": n_samp * 60.0 / sustained_s if on_card else None,
        **extra,
        "known_limit": (
            "requests coalesce into shared dispatches (--coalesce_ms)" if coalesce_ms > 0 else
            "single in-flight request (device lock); enable --coalesce_ms to pack concurrent requests "
            "into one dispatch"
        ),
        "card": card,
    }
    print(json.dumps(row), flush=True)
    return {**row, "server": server}


if __name__ == "__main__":
    main()
