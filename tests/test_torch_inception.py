"""The port's InceptionV3 (guided_diffusion_clip_tpu_torch/evaluations/inception.py)
against the JAX package's (evaluations/inception_flax.py) on the CPU: the same
``random_params(0)`` and the same numpy-made uint8 images, batch 2.

Tolerances: the resize within 1e-6 of the reference's largest value; pool_3
and the spatial features within 1e-4 of it (float32 convs in another order);
the softmax predictions within 1e-6."""

import os

import jax
import numpy as np
import pytest
import torch

from evaluations import inception_flax as jinc
from guided_diffusion_clip_tpu_torch.evaluations import inception as inc

SIZES = (64, 256)


def images(size, seed=0, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def params():
    return jinc.random_params(0)


@pytest.fixture(scope="module")
def jax_features(params):
    """The JAX reference at each size, computed once: (pool_3, spatial, preds)."""
    fwd = jax.jit(lambda p, x: jinc.inception_features(p, x))
    out = {}
    for size in SIZES:
        pool3, spatial = fwd(params, images(size).astype(np.float32))
        out[size] = tuple(np.asarray(v) for v in (pool3, spatial, jinc.inception_softmax(params, pool3)))
    return out


@pytest.fixture(scope="module")
def torch_features(params):
    model = inc.build_inception(params)
    out = {}
    with torch.no_grad():
        for size in SIZES:
            pool3, spatial = model(torch.from_numpy(images(size)))
            out[size] = (pool3.numpy(), spatial.numpy(), model.softmax(pool3).numpy())
    return out


def close(ours, ref, tol):
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def test_random_params_are_the_jax_arrays(params):
    ours = inc.random_params(0)
    assert set(ours) == set(params)
    for k, v in params.items():
        if isinstance(v, dict):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(ours[k][leaf], v[leaf])
        else:
            np.testing.assert_array_equal(ours[k], v)


def test_architecture_table_is_the_jax_table():
    assert inc._expected_conv_units() == jinc._expected_conv_units()
    assert inc._trace_in_channels() == jinc._trace_in_channels()


def test_channel_counts_reach_2048():
    chans = inc._trace_in_channels()
    assert set(chans) == set(inc._expected_conv_units())
    assert [chans[k] for k in ("mixed/conv", "mixed_1/conv", "mixed_2/conv", "mixed_3/conv", "mixed_4/conv",
                               "mixed_8/tower/conv", "mixed_9/conv", "mixed_10/conv")] == [
        192, 256, 288, 288, 768, 768, 1280, 2048]
    model = inc.InceptionV3()
    assert model.convs["mixed_10/tower_2/conv"].in_channels == 2048
    assert model.softmax_w.shape == (2048, 1008)


@pytest.mark.parametrize("size", (64, 256, 512, 299))
def test_legacy_resize_bilinear(size):
    x = np.random.RandomState(size).uniform(0, 255, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jinc.legacy_resize_bilinear(x, 299, 299))
    ours = inc.legacy_resize_bilinear(torch.from_numpy(x), 299, 299).numpy()
    close(ours, ref, 1e-6)
    if size == 299:
        np.testing.assert_array_equal(ours, x)


def test_legacy_resize_is_not_half_pixel():
    x = torch.tensor([0.0, 1.0]).reshape(1, 1, 2, 1)
    np.testing.assert_allclose(inc.legacy_resize_bilinear(x, 1, 4).reshape(-1).numpy(), [0.0, 0.5, 1.0, 1.0],
                               atol=1e-6)


@pytest.mark.parametrize("size", SIZES)
def test_pool3_and_spatial(size, jax_features, torch_features):
    (jp, js, _), (tp, ts, _) = jax_features[size], torch_features[size]
    assert tp.shape == (2, 2048) and ts.shape == (2, 17, 17, 7)
    close(tp, jp, 1e-4)
    close(ts, js, 1e-4)


@pytest.mark.parametrize("size", SIZES)
def test_preds(size, jax_features, torch_features):
    jpred, tpred = jax_features[size][2], torch_features[size][2]
    np.testing.assert_allclose(tpred, jpred, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpred.sum(1), 1.0, rtol=1e-5)


def test_odd_size_shapes(params):
    model = inc.build_inception(params)
    x = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (2, 37, 41, 3)).astype(np.float32))
    with torch.no_grad():
        pool3, spatial = model(x)
    assert pool3.shape == (2, 2048) and spatial.shape == (2, 17, 17, 7)
    assert torch.isfinite(pool3).all() and torch.isfinite(spatial).all()


def test_spatial_pre_activation(params):
    """A converted pb whose mixed_6/conv:0 is the raw Conv2D: the spatial
    features come from the unfolded ``mixed_6/conv_raw`` kernel."""
    rs = np.random.RandomState(3)
    raw = dict(params)
    raw["mixed_6/conv_raw"] = {"w": rs.standard_normal(params["mixed_6/conv"]["w"].shape).astype(np.float32) * 0.03,
                               "b": np.zeros(params["mixed_6/conv"]["b"].shape, np.float32)}
    x = images(64, seed=4)
    _, ref = jax.jit(lambda p, v: jinc.inception_features(p, v, spatial_pre_activation=True))(
        raw, x.astype(np.float32))
    model = inc.build_inception({**raw, "spatial_pre_activation": np.asarray(True)})
    assert model.spatial_pre_activation
    with torch.no_grad():
        pool3, spatial = model(torch.from_numpy(x))
    close(spatial.numpy(), np.asarray(ref), 1e-4)
    assert (np.asarray(ref) < 0).any()  # no ReLU on the raw conv
    with pytest.raises(ValueError, match="mixed_6/conv_raw"):
        inc.state_dict_from_params({**params, "spatial_pre_activation": np.asarray(True)})


def test_load_params_round_trips_the_converter_layout(params, tmp_path):
    path = str(tmp_path / "inception_v3_fid.npz")
    np.savez(path, **inc.flat_params({**params, "spatial_pre_activation": np.asarray(False)}))
    jparams, jflag = jinc.load_params(path)  # the JAX loader reads the same file
    sd, flag = inc.load_params(path)
    assert flag is False and jflag is False
    for name in inc._expected_conv_units():
        np.testing.assert_array_equal(sd[f"convs.{name}.weight"].permute(2, 3, 1, 0).numpy(), jparams[name]["w"])
        np.testing.assert_array_equal(sd[f"convs.{name}.bias"].numpy(), jparams[name]["b"])
    np.testing.assert_array_equal(sd["softmax_w"].numpy(), jparams["softmax_w"])
    model = inc.InceptionV3()
    model.load_state_dict(sd, strict=True)
    assert os.path.basename(inc.DEFAULT_WEIGHTS) == "inception_v3_fid.npz"


def test_forward_keeps_tf32_off(params, monkeypatch):
    """``forward`` turns TF32 off for its convs and product and restores the
    caller's settings after."""
    seen = []
    model = inc.build_inception(params)
    orig = model.features

    def spy(x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return orig(x)

    monkeypatch.setattr(model, "features", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with torch.no_grad():
        model(torch.from_numpy(images(32)))
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
