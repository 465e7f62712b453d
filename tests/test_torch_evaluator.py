"""The port's evaluator (guided_diffusion_clip_tpu_torch/evaluations/evaluator.py)
against the JAX package's (evaluations/evaluator.py) on the CPU.

Tolerances: the Frechet distance within 1e-6 relative (the eps retry too),
the Inception Score within 1e-9, a distance block within 1e-5 of its largest
entry, precision and recall equal, on the same feature arrays. ``main()`` end
to end with the pixel extractor on 256 + 256 images of 32 px, where the
192-d pool covariance has full rank: FID and IS within 1e-4 * max(1, |ref|),
precision and recall equal; the sFID's 768-d covariance of 256 images is
singular, where the eps retry magnifies feature rounding, so it is only
required finite (the metric math above holds it on identical features)."""

import contextlib
import io
import os
import resource
import sys

import numpy as np
import pytest
import scipy.linalg
import torch

from evaluations import evaluator as jev
from evaluations import inception_flax as jinc
from guided_diffusion_clip_tpu_torch.evaluations import evaluator as ev
from guided_diffusion_clip_tpu_torch.evaluations import inception as inc


def feature_pair(seed, n=400, d=12, scale=1.3, shift=0.2):
    rs = np.random.RandomState(seed)
    return rs.randn(n, d), rs.randn(n, d) * scale + shift


# ---------------------------------------------------------------------------
# the metric math against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,d", [(3, 400, 12), (4, 300, 64), (5, 2000, 8)])
def test_frechet_matches_jax(seed, n, d):
    a, b = feature_pair(seed, n, d)
    ours = ev.statistics_from_activations(a).frechet_distance(ev.statistics_from_activations(b))
    ref = jev.statistics_from_activations(a).frechet_distance(jev.statistics_from_activations(b))
    assert ours == pytest.approx(ref, rel=1e-6)


def test_frechet_eps_retry_matches_jax(monkeypatch):
    """A singular product (sqrtm gives no finite root): both retry with eps
    on the diagonals and agree."""
    real = scipy.linalg.sqrtm
    calls = []

    def first_fails(m, *args, **kw):
        calls.append(m)
        out = real(m, *args, **kw)
        if len(calls) % 2 == 1:  # each distance's first root is the singular one
            root = out[0] if isinstance(out, tuple) else out
            root = np.full_like(root, np.inf)
            return (root, np.inf) if isinstance(out, tuple) else root
        return out

    monkeypatch.setattr(scipy.linalg, "sqrtm", first_fails)
    rs = np.random.RandomState(6)
    a, b = rs.randn(20, 32), rs.randn(20, 32) * 2  # n < d: singular covariances
    with pytest.warns(UserWarning, match="singular product"):
        ours = ev.statistics_from_activations(a).frechet_distance(ev.statistics_from_activations(b))
    with pytest.warns(UserWarning, match="singular product"):
        ref = jev.statistics_from_activations(a).frechet_distance(jev.statistics_from_activations(b))
    assert len(calls) == 4
    assert np.isfinite(ours) and ours == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("seed,n,k,split", [(0, 100, 10, 5000), (1, 1200, 1008, 500), (2, 64, 64, 5000)])
def test_inception_score_matches_jax(seed, n, k, split):
    logits = np.random.RandomState(seed).randn(n, k) * 3
    preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ours = ev.inception_score_from_preds(preds, split)
    ref = jev.inception_score_from_preds(preds, split)
    assert abs(ours - ref) <= 1e-9


@pytest.mark.parametrize("n,m,d", [(50, 70, 8), (300, 200, 64), (64, 64, 2048)])
def test_distance_block_matches_jax(n, m, d):
    rs = np.random.RandomState(n)
    a, b = rs.randn(n, d).astype(np.float32), rs.randn(m, d).astype(np.float32) + 0.1
    ref = np.asarray(jev._pairwise_l2_sq(a, b))
    ours = ev.pairwise_l2_sq(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert ours.dtype == np.float32 and ours.shape == (n, m)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    exact = ((a.astype(np.float64)[:, None] - b.astype(np.float64)[None]) ** 2).sum(-1)
    assert np.abs(ours - exact).max() <= 1e-5 * exact.max()


@pytest.mark.parametrize("case", ["gaussian", "shifted", "subset", "wide"])
def test_prec_recall_equal_jax(case):
    rs = np.random.RandomState(7)
    ref = rs.randn(500, 16).astype(np.float32)
    sample = {
        "gaussian": rs.randn(400, 16).astype(np.float32),
        "shifted": rs.randn(400, 16).astype(np.float32) + 0.5,
        "subset": ref[:100] + rs.randn(100, 16).astype(np.float32) * 0.01,
        "wide": rs.randn(300, 16).astype(np.float32) * 2,
    }[case]
    assert ev.compute_prec_recall(ref, sample) == jev.compute_prec_recall(ref, sample)


def test_radii_match_jax_in_blocks():
    """Row and column blocks smaller than the set: the radii are the JAX
    estimator's values."""
    feats = np.random.RandomState(8).randn(230, 24).astype(np.float32)
    ours = ev.ManifoldEstimator(feats, row_batch=64, col_batch=100)
    ref = jev.ManifoldEstimator(feats, row_batch=64, col_batch=100)
    np.testing.assert_allclose(ours.radii.numpy(), ref.radii, rtol=1e-5)
    points = np.random.RandomState(9).randn(150, 24).astype(np.float32) * 1.2
    np.testing.assert_array_equal(ours.evaluate_membership(points), ref.evaluate_membership(points))


# ---------------------------------------------------------------------------
# analytic cases (tests/test_evaluator.py's)
# ---------------------------------------------------------------------------


def _identical():
    s = ev.statistics_from_activations(np.random.RandomState(0).randn(500, 16))
    return s, s, 0.0


def _mean_shift():  # same covariance, mean shift d: FID = |d|^2
    return ev.FIDStatistics(np.zeros(4), np.eye(4)), ev.FIDStatistics(np.array([3.0, 0, 0, 0]), np.eye(4)), 9.0


def _cov_scale():  # N(0, I) vs N(0, 4I) in D dims: FID = D (1 + 4 - 2 * 2) = D
    return ev.FIDStatistics(np.zeros(5), np.eye(5)), ev.FIDStatistics(np.zeros(5), 4 * np.eye(5)), 5.0


@pytest.mark.parametrize("make", [_identical, _mean_shift, _cov_scale], ids=lambda f: f.__name__[1:])
def test_frechet_analytic(make):
    s1, s2, want = make()
    assert s1.frechet_distance(s2) == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_frechet_monotone_in_shift():
    base = np.random.RandomState(2).randn(2000, 8)
    s0 = ev.statistics_from_activations(base)
    dists = [s0.frechet_distance(ev.statistics_from_activations(base + shift)) for shift in (0.5, 1.0, 2.0)]
    assert 0 < dists[0] < dists[1] < dists[2]


@pytest.mark.parametrize("preds,want,rel", [
    (np.full((100, 10), 0.1), 1.0, 1e-6),  # uniform predictions score one
    (np.eye(10)[np.arange(1000) % 10] * (1 - 1e-9) + 1e-10, 10.0, 1e-3),  # confident and diverse: K
], ids=["uniform", "confident"])
def test_inception_score_analytic(preds, want, rel):
    assert ev.inception_score_from_preds(preds) == pytest.approx(want, rel=rel)


def _pr_sets(case):
    rs = np.random.RandomState({"identical": 4, "disjoint": 5, "subset": 6}[case])
    if case == "identical":
        f = rs.randn(300, 8).astype(np.float32)
        return f, f.copy()
    if case == "disjoint":
        return rs.randn(300, 8).astype(np.float32), rs.randn(300, 8).astype(np.float32) + 100.0
    ref = rs.randn(1000, 8).astype(np.float32)
    return ref, ref[:100] + rs.randn(100, 8).astype(np.float32) * 0.01


@pytest.mark.parametrize("case", ["identical", "disjoint", "subset"])
def test_prec_recall_analytic(case):
    p, r = ev.compute_prec_recall(*_pr_sets(case))
    if case == "identical":
        assert p == pytest.approx(1.0) and r == pytest.approx(1.0)
    elif case == "disjoint":
        assert p == pytest.approx(0.0) and r == pytest.approx(0.0)
    else:
        assert p > 0.9 and r < p  # samples sit on the ref manifold, but cover less of it


# ---------------------------------------------------------------------------
# main() end to end, port against JAX
# ---------------------------------------------------------------------------


def _metric_lines(out: str, tag: str) -> dict:
    vals = {}
    for line in out.splitlines():
        for name in ev.METRIC_LINES:
            if line.startswith(f"{name}{tag}:"):
                vals[name] = float(line.split(":", 1)[1])
    return vals


@pytest.fixture(scope="module")
def pixel_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pixel")
    rs = np.random.RandomState(7)
    ref = rs.randint(0, 256, (256, 32, 32, 3), dtype=np.uint8)
    sample = np.clip(ref.astype(int) + rs.randint(-40, 41, ref.shape), 0, 255).astype(np.uint8)
    ref_p, sample_p = str(tmp / "ref.npz"), str(tmp / "sample.npz")
    np.savez(ref_p, ref)
    np.savez(sample_p, sample)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        returned = ev.main([ref_p, sample_p, "--extractor", "pixel", "--device", "cpu"])
    ours = buf.getvalue()
    argv = sys.argv
    buf = io.StringIO()
    try:
        sys.argv = ["evaluator.py", ref_p, sample_p, "--extractor", "pixel"]
        with contextlib.redirect_stdout(buf):
            jev.main()
    finally:
        sys.argv = argv
    return ours, buf.getvalue(), returned


def test_main_pixel_matches_jax(pixel_run):
    ours, theirs, returned = pixel_run
    tag = "[pixel-debug]"
    o, t = _metric_lines(ours, tag), _metric_lines(theirs, tag)
    assert set(o) == set(t) == set(ev.METRIC_LINES)
    assert "\nFID:" not in ours  # the debug extractor's numbers are never untagged
    for name in ("Inception Score", "FID"):
        assert abs(o[name] - t[name]) <= 1e-4 * max(1.0, abs(t[name])), (name, o[name], t[name])
    assert (o["Precision"], o["Recall"]) == (t["Precision"], t["Recall"])
    assert np.isfinite(o["sFID"])
    assert returned == o
    assert [line.split(":")[0] for line in ours.splitlines() if ":" in line and tag in line] == [
        f"{name}{tag}" for name in ev.METRIC_LINES]


def test_pixel_features_match_jax():
    batch = np.random.RandomState(1).randint(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    ours = ev.PixelExtractor().extract(batch)
    ref = jev.PixelExtractor().extract(batch)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_main_needs_a_card_or_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = str(tmp_path / "a.npz")
    np.savez(p, np.zeros((2, 8, 8, 3), np.uint8))
    with pytest.raises(SystemExit, match="no CUDA device"):
        ev.main([p, p, "--extractor", "pixel"])


def test_inception_extractor_features(tmp_path):
    """The Inception extractor's three features of an npz batch are the
    module's, in sub-batches, with the spatial map flattened NHWC."""
    params = inc.random_params(0)
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **inc.flat_params({**params, "spatial_pre_activation": np.asarray(False)}))
    ex = ev.InceptionExtractor(weights, batch=4)
    batch = np.random.RandomState(1).randint(0, 255, (6, 24, 24, 3), np.uint8)
    pool, spatial, preds = ex.extract(batch)
    assert pool.shape == (6, 2048) and spatial.shape == (6, 17 * 17 * 7) and preds.shape == (6, 1008)
    model = inc.build_inception(params)
    with torch.no_grad():
        p, s = model(torch.from_numpy(batch))
    np.testing.assert_allclose(pool, p.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(spatial, s.reshape(6, -1).numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(preds, model.softmax(p).numpy(), rtol=1e-5)


def test_read_statistics_takes_cached_mu_sigma(tmp_path):
    rs = np.random.RandomState(2)
    p = str(tmp_path / "ref.npz")
    stats = {k: rs.randn(3) if k.startswith("mu") else np.eye(3) for k in ("mu", "sigma", "mu_s", "sigma_s")}
    np.savez(p, np.zeros((2, 8, 8, 3), np.uint8), **stats)
    assert ev.npz_has_statistics(p) and jev.npz_has_statistics(p)
    s, s_sp = ev.PixelExtractor().read_statistics(p, None)
    np.testing.assert_array_equal(s.mu, stats["mu"])
    np.testing.assert_array_equal(s_sp.sigma, stats["sigma_s"])


# ---------------------------------------------------------------------------
# extractor discovery (tests/test_evaluator.py's)
# ---------------------------------------------------------------------------


def test_auto_prefers_the_converted_npz(tmp_path, monkeypatch):
    npz = str(tmp_path / "inception_v3_fid.npz")
    np.savez(npz, **inc.flat_params(jinc.random_params(0)))
    monkeypatch.setenv(ev.INCEPTION_NPZ_ENV, npz)
    assert isinstance(ev.make_extractor("auto"), ev.InceptionExtractor)
    assert isinstance(ev.make_extractor("flax-inception"), ev.InceptionExtractor)


def test_auto_falls_back_to_pixel(tmp_path, monkeypatch):
    monkeypatch.delenv(ev.INCEPTION_NPZ_ENV, raising=False)
    monkeypatch.delenv(ev.INCEPTION_PB_ENV, raising=False)
    monkeypatch.chdir(tmp_path)  # no default-named files in cwd
    assert isinstance(ev.make_extractor("auto"), ev.PixelExtractor)


def test_explicit_flax_without_npz_raises(tmp_path, monkeypatch):
    monkeypatch.delenv(ev.INCEPTION_NPZ_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="converted Inception"):
        ev.make_extractor("flax-inception")


# ---------------------------------------------------------------------------
# npz streaming (tests/test_inception_flax.py's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["stored", "compressed", "float"])
def test_npz_batches_match_full_load(tmp_path, kind):
    rs = np.random.RandomState(0)
    arr = {"stored": lambda: rs.randint(0, 255, (70, 9, 9, 3), np.uint8),
           "compressed": lambda: rs.randint(0, 255, (33, 5, 5, 3), np.uint8),
           "float": lambda: rs.randn(17, 8).astype(np.float32)}[kind]()
    p = str(tmp_path / "a.npz")
    (np.savez_compressed if kind == "compressed" else np.savez)(p, arr)
    got = np.concatenate(list(ev.iter_npz_batches(p, batch_size=10)), 0)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == arr.dtype


def test_streaming_rss_stays_o_batch(tmp_path):
    """Reading a ~300 MB npz in 64-row batches does not grow RSS by the
    array's size."""
    n, side = 1600, 256
    p = str(tmp_path / "big.npz")
    arr = np.zeros((n, side, side, 3), np.uint8)
    np.savez(p, arr)
    del arr
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB on linux
    total = sum(len(b) for b in ev.iter_npz_batches(p, batch_size=64))
    grown_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) / 1024.0
    assert total == n
    assert grown_mb < 150, f"streaming read grew RSS by {grown_mb:.0f} MB"
    os.remove(p)
