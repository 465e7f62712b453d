"""The PyTorch port's HTTP server (guided_diffusion_clip_tpu_torch.serve),
in-process on the CPU at 16 px: healthz, npz/png, chunking, 400s, and the
per-sample RNG contract (solo, coalesced, chunked and bucketed requests give
the same bytes)."""

import concurrent.futures
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu_torch import serve
from guided_diffusion_clip_tpu_torch.utils.script_util import (
    create_model_and_diffusion,
    model_and_diffusion_defaults,
    resolve_sampler,
)

torch.set_num_threads(2)

TINY = [
    "--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
    "--channel_mult", "1,2", "--num_heads", "2", "--attention_resolutions", "4",
    "--diffusion_steps", "10", "--noise_schedule", "cosine",
    "--learn_sigma", "True", "--class_cond", "True",
    "--timestep_respacing", "5", "--batch_size", "4", "--device", "cpu",
]


def _make_ckpt(path):
    """A reference-format .pt of the TINY model with every weight random
    N(0, 0.02), as bench.py fills its params (the init's zero output layers
    would make the model output exactly 0)."""
    kw = model_and_diffusion_defaults()
    kw.update(
        image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2",
        num_heads=2, attention_resolutions="4", diffusion_steps=10,
        noise_schedule="cosine", learn_sigma=True, class_cond=True,
    )
    model, _ = create_model_and_diffusion(**kw)
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) * 0.02 for k, v in model.state_dict().items()}
    torch.save(sd, path)


class _Server:
    def __init__(self, argv):
        self.sampler = serve.Sampler(serve.parse_args(argv))
        self.sampler.warmup()
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(self.sampler))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        self.sampler.close()

    def healthz(self):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}/healthz", timeout=30) as r:
            return json.loads(r.read())

    def post(self, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/sample", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        return urllib.request.urlopen(req, timeout=120)

    def fetch(self, **payload):
        with self.post(payload) as r:
            assert r.status == 200
            return np.load(io.BytesIO(r.read()))["arr_0"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "model000001.pt")
    _make_ckpt(path)
    return path


def test_serve_end_to_end(ckpt):
    srv = _Server([*TINY, "--model_path", ckpt])
    try:
        h = srv.healthz()
        assert h["ok"] and h["compiled"]
        assert h["batch_size"] == 4 and h["image_size"] == 16
        assert h["cond"] == "clip_feat" and h["steps"] == 5 and h["sampler"] == "ancestral"

        # npz request smaller than the batch (padding + slice)
        rs = np.random.RandomState(0)
        feat = rs.randn(2, 512).astype(np.float32)
        arr = srv.fetch(num_samples=2, seed=3, clip_feat=feat.tolist())
        assert arr.shape == (2, 16, 16, 3) and arr.dtype == np.uint8
        assert arr.std() > 0  # not a constant image

        # determinism: same seed+cond -> same bytes; different seed differs
        np.testing.assert_array_equal(srv.fetch(num_samples=2, seed=3, clip_feat=feat.tolist()), arr)
        assert (srv.fetch(num_samples=2, seed=4, clip_feat=feat.tolist()) != arr).any()

        # png_base64 format
        with srv.post({"num_samples": 1, "format": "png_base64"}) as r:
            body = json.loads(r.read())
        assert body["n"] == 1 and len(body["png_base64"]) > 100

        # a request LARGER than the batch is chunked; per-sample RNG makes the
        # shared prefix identical to the solo 2-sample request
        feat6 = np.concatenate([feat, rs.randn(4, 512).astype(np.float32)])
        arr6 = srv.fetch(num_samples=6, seed=3, clip_feat=feat6.tolist())
        assert arr6.shape == (6, 16, 16, 3)
        np.testing.assert_array_equal(arr6[:2], arr)

        # validation errors come back as 400, server stays up
        for bad in ({"num_samples": 99}, {"num_samples": 2, "clip_feat": [[1.0, 2.0]]}):
            with pytest.raises(urllib.error.HTTPError) as e:
                srv.post(bad)
            assert e.value.code == 400
        assert srv.healthz()["ok"]
    finally:
        srv.close()


def test_serve_coalescing_and_buckets(ckpt):
    """--coalesce_ms packs concurrent requests into one chain and
    --batch_buckets pads small requests to smaller batches; per-sample RNG
    keeps every request's bytes the same as a solo run."""
    srv = _Server([*TINY, "--model_path", ckpt, "--coalesce_ms", "400", "--batch_buckets", "1,2"])
    try:
        h = srv.healthz()
        assert h["coalesce_ms"] == 400 and h["batch_buckets"] == [1, 2, 4]
        assert sorted(h["bucket_latency_s"]) == ["1", "2", "4"]

        solo3, solo9 = srv.fetch(num_samples=2, seed=3), srv.fetch(num_samples=2, seed=9)
        assert (solo3 != solo9).any()
        d0 = srv.healthz()["dispatches"]

        # two concurrent 2-sample requests (batch 4) -> ONE coalesced chain
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            f3 = pool.submit(srv.fetch, num_samples=2, seed=3)
            f9 = pool.submit(srv.fetch, num_samples=2, seed=9)
            co3, co9 = f3.result(), f9.result()
        h2 = srv.healthz()
        assert h2["dispatches"] == d0 + 1, (d0, h2)
        assert h2["coalesced_requests"] >= 2
        np.testing.assert_array_equal(co3, solo3)
        np.testing.assert_array_equal(co9, solo9)

        # the same samples through other buckets and a chunked request
        a1 = srv.fetch(num_samples=1, seed=3)
        a3 = srv.fetch(num_samples=3, seed=3)
        a6 = srv.fetch(num_samples=6, seed=3)
        np.testing.assert_array_equal(a1, solo3[:1])
        np.testing.assert_array_equal(a3[:2], solo3)
        np.testing.assert_array_equal(a6[:3], a3)
    finally:
        srv.close()


def test_coalescing_under_many_concurrent_clients(ckpt):
    """More clients than cores, a short switch interval: every request gets
    its own samples (bytes equal to its solo run) and nothing is lost."""
    import sys

    srv = _Server([*TINY, "--model_path", ckpt, "--coalesce_ms", "100"])
    seeds = list(range(100, 116))
    old = sys.getswitchinterval()
    try:
        solo = {s: srv.fetch(num_samples=1, seed=s) for s in seeds}
        d0 = srv.healthz()["dispatches"]
        sys.setswitchinterval(1e-5)
        with concurrent.futures.ThreadPoolExecutor(len(seeds)) as pool:
            futures = {s: pool.submit(srv.fetch, num_samples=1, seed=s) for s in seeds}
            got = {s: f.result(timeout=120) for s, f in futures.items()}
        sys.setswitchinterval(old)
        for s in seeds:
            np.testing.assert_array_equal(got[s], solo[s], err_msg=f"seed {s}")
        h = srv.healthz()
        assert len(seeds) // 4 <= h["dispatches"] - d0 < len(seeds)
    finally:
        sys.setswitchinterval(old)
        srv.close()


@pytest.mark.parametrize(
    "flag,value",
    [("cfg_scale", "1.5"), ("cfg_cache", "2"), ("guidance_interval", "0,500"),
     ("deep_cache", "3")],
)
def test_unported_flags_raise(flag, value, ckpt):
    """The flags once refused as not yet ported now run: each one
    serves a request (with ``--cfg_scale`` beside the two that gate CFG), and
    the model runs as often as the flag says. The JAX server's own refusals
    of bad combinations stay."""
    needs_cfg = flag in ("cfg_cache", "guidance_interval")
    argv = [*TINY, f"--{flag}", value, "--model_path", ckpt]
    if needs_cfg:
        with pytest.raises(SystemExit, match="needs --cfg_scale"):
            serve.Sampler(serve.parse_args(argv))
        argv += ["--cfg_scale", "1.5"]
    sampler = serve.Sampler(serve.parse_args(argv))
    # a null clip_feat would make both CFG branches the same
    cond = (np.random.RandomState(0).randn(2, 512) * 4).astype(np.float32)
    out = sampler.sample(2, seed=3, cond=cond)
    assert out.shape == (2, 16, 16, 3) and out.dtype == np.uint8 and out.std() > 0
    np.testing.assert_array_equal(sampler.sample(2, seed=3, cond=cond), out)
    # 5 steps a chain, two chains: cfg_cache 2 adds a refresh on steps 0, 2, 4
    assert sampler.forwards == 2 * (8 if flag == "cfg_cache" else 5)
    plain = serve.Sampler(serve.parse_args([*TINY, "--model_path", ckpt]))
    assert (plain.sample(2, seed=3, cond=cond) != out).any()


def test_serve_refuses_bad_cfg_combinations(ckpt):
    """The refusals of scripts/serve.py: CFG needs a conditioned model, and
    DeepCache and CFG do not compose in the server."""
    uncond = [a if a != "True" or TINY[i - 1] != "--class_cond" else "False" for i, a in enumerate(TINY)]
    with pytest.raises(SystemExit, match="needs a conditioned model"):
        serve.Sampler(serve.parse_args([*uncond, "--cfg_scale", "2.0", "--model_path", ckpt]))
    with pytest.raises(SystemExit, match="not both"):
        serve.Sampler(serve.parse_args([*TINY, "--cfg_scale", "2.0", "--deep_cache", "2", "--model_path", ckpt]))
    with pytest.raises(ValueError, match="lo,hi"):
        serve.Sampler(serve.parse_args([*TINY, "--cfg_scale", "2.0", "--guidance_interval", "5", "--model_path", ckpt]))


def test_unknown_conv_impl_is_refused():
    with pytest.raises(SystemExit, match="choose from"):
        serve.Sampler(serve.parse_args([*TINY, "--conv_impl", "int4", "--model_path", "unused.pt"]))


def test_serve_conv_impl_xla_is_the_default_path(ckpt):
    """``--conv_impl xla`` (the JAX package's name for the bf16 path) serves
    the same bytes as the default ``auto``."""
    req = dict(num_samples=2, seed=5)
    out = {}
    for impl in ("auto", "xla"):
        srv = _Server([*TINY, "--model_path", ckpt, "--conv_impl", impl])
        try:
            out[impl] = srv.fetch(**req)
        finally:
            srv.close()
    np.testing.assert_array_equal(out["xla"], out["auto"])


def test_serve_int8_on_cpu(ckpt):
    """``--conv_impl int8`` (K4 and K5's plain versions here): the same
    request served twice gives the same bytes, and the samples differ from
    the bf16 path's. Not asserted: packing invariance. ``int8_conv``'s
    per-tensor scale spans the whole batch, in the JAX server as here, so
    under int8 a sample depends on what it is batched with."""
    srv = _Server([*TINY, "--model_path", ckpt, "--conv_impl", "int8"])
    try:
        assert srv.sampler.model.int8
        a = srv.fetch(num_samples=2, seed=3)
        assert a.shape == (2, 16, 16, 3) and a.dtype == np.uint8 and a.std() > 0
        np.testing.assert_array_equal(srv.fetch(num_samples=2, seed=3), a)
        a6 = srv.fetch(num_samples=6, seed=3)  # chunked: 4 + 2
        assert a6.shape == (6, 16, 16, 3)
    finally:
        srv.close()
    plain = _Server([*TINY, "--model_path", ckpt])
    try:
        assert (plain.fetch(num_samples=2, seed=3) != a).any()
    finally:
        plain.close()


def test_dpm_solver_not_yet_ported(ckpt):
    """``--sampler dpm++2m``, once refused as not yet ported, resolves to the
    DPM-Solver++(2M) loop and serves; an unknown sampler is still refused."""
    kw = model_and_diffusion_defaults()
    kw.update(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2")
    _, diffusion = create_model_and_diffusion(**kw)
    args = serve.parse_args([*TINY, "--sampler", "dpm++2m"])
    assert resolve_sampler(diffusion, args) == diffusion.dpm_solver_pp_2m_loop
    with pytest.raises(SystemExit, match="choose from"):
        resolve_sampler(diffusion, serve.parse_args([*TINY, "--sampler", "heun"]))
    assert resolve_sampler(diffusion, serve.parse_args([*TINY, "--use_ddim", "True"])) == diffusion.ddim_sample_loop
    srv = _Server([*TINY, "--model_path", ckpt, "--sampler", "dpm++2m", "--cfg_scale", "2.0", "--cfg_cache", "2"])
    try:
        assert srv.healthz()["sampler"] == "dpm++2m"
        a = srv.fetch(num_samples=2, seed=3)
        assert a.shape == (2, 16, 16, 3) and a.std() > 0
        np.testing.assert_array_equal(srv.fetch(num_samples=2, seed=3), a)
    finally:
        srv.close()


def test_bucket_latency_routing():
    """_bucket_for picks the measured-fastest fitting bucket; size routing
    before warmup; ties break toward the smaller shape."""
    s = object.__new__(serve.Sampler)
    s.buckets = [1, 2, 4, 8]
    s.bucket_latency = {}
    assert serve.Sampler._bucket_for(s, 1) == 1
    assert serve.Sampler._bucket_for(s, 3) == 4
    s.bucket_latency = {1: 1.9, 2: 2.7, 4: 4.0, 8: 2.5}
    assert serve.Sampler._bucket_for(s, 1) == 1
    assert serve.Sampler._bucket_for(s, 2) == 8
    assert serve.Sampler._bucket_for(s, 8) == 8
    s.bucket_latency = {1: 0.5, 2: 0.5, 4: 0.8, 8: 1.0}
    assert serve.Sampler._bucket_for(s, 2) == 2
    assert serve.Sampler._bucket_for(s, 3) == 4
    s.bucket_latency = {1: 9.9}
    assert serve.Sampler._bucket_for(s, 2) == 2


def test_missing_card_is_an_error(monkeypatch, ckpt):
    """--device cuda without a card fails; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.Sampler(serve.parse_args([*TINY, "--device", "cuda", "--model_path", ckpt]))
