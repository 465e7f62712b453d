"""The port's process group (``parallel/dist.py``) and what reads it, on two
processes (gloo on the CPU), against one process and the JAX package.

The two ranks run ``tests/torch_dist_worker.py`` under torchrun: once for the
queries, the collectives, the loader's shard, the loss-aware sampler, the
weighted mean and the per-rank log files (``scenario_basics``), once for
``image_sample`` and ``classifier_sample`` at world 2 (``scenario_sample``).
Here, in the parent, the JAX package gives the loader's batches and the
weighted mean's arithmetic, and the one-process CLIs give the samples.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from guided_diffusion_clip_tpu.data import image_datasets as JD
from guided_diffusion_clip_tpu.utils import logger as jlogger
from guided_diffusion_clip_tpu_torch import classifier_sample, image_sample
from guided_diffusion_clip_tpu_torch.data.image_datasets import load_data
from guided_diffusion_clip_tpu_torch.parallel import dist as pdist
from guided_diffusion_clip_tpu_torch.training.resample import LossSecondMomentResampler
from guided_diffusion_clip_tpu_torch.utils import logger
from guided_diffusion_clip_tpu_torch.utils.script_util import (
    create_classifier, create_model_and_diffusion, create_upstream_model, model_and_diffusion_defaults,
)
from torch_dist_worker import run_ranks

torch.set_num_threads(2)

TINY = dict(image_size=16, num_channels=32, num_res_blocks=1, channel_mult="1,2", attention_resolutions="8",
            num_heads=1, learn_sigma=True, class_cond=False, diffusion_steps=20, noise_schedule="cosine",
            timestep_respacing="4")
CLI_UNET = dict(image_size=64, num_channels=64, num_res_blocks=1, attention_resolutions="16,8",
                num_head_channels=64, resblock_updown=True, use_scale_shift_norm=True, learn_sigma=True,
                class_cond=True)
CLI_CLASSIFIER = dict(image_size=64, classifier_use_fp16=True, classifier_width=64, classifier_depth=1,
                      classifier_attention_resolutions="32,16,8", classifier_use_scale_shift_norm=True,
                      classifier_resblock_updown=True, classifier_pool="attention")


def _flags(d: dict) -> list:
    return [x for k, v in d.items() for x in (f"--{k}", str(v))]


def _random_pt(model, path, seed):
    g = torch.Generator().manual_seed(seed)
    torch.save({k: torch.randn(v.shape, generator=g) * 0.02 for k, v in model.state_dict().items()}, path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """9 PNGs of mixed sizes and their flip-indexed CLIP dict; a tiny
    unconditional UNet and the 64 px UNet and classifier of
    ``test_torch_guidance.py`` (random weights); the CLIs' flags."""
    d = tmp_path_factory.mktemp("dist")
    (d / "images").mkdir()
    rs = np.random.RandomState(0)
    clip = {}
    for i in range(9):
        name = f"img_{i:03d}.png"
        h, w = (16, 16) if i % 3 else (24 + i, 40 - i)
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(d / "images" / name)
        clip[name] = rs.randn(2, 512).astype(np.float32)
    np.savez(d / "clip.npz", **clip)
    _random_pt(create_model_and_diffusion(**{**model_and_diffusion_defaults(), **TINY})[0], d / "unet.pt", 0)
    _random_pt(create_upstream_model(**CLI_UNET), d / "model.pt", 0)
    _random_pt(create_classifier(**CLI_CLASSIFIER), d / "classifier.pt", 1)
    argv = {
        "image_sample": [*_flags(TINY), "--device", "cpu", "--model_path", str(d / "unet.pt"), "--data_dir_test",
                         str(d / "images"), "--batch_size", "2", "--num_samples", "6", "--use_ddim", "True",
                         "--seed", "4"],
        "classifier_sample": [*_flags({**CLI_UNET, **CLI_CLASSIFIER}), "--device", "cpu", "--model_path",
                              str(d / "model.pt"), "--classifier_path", str(d / "classifier.pt"), "--use_fp16",
                              "True", "--timestep_respacing", "3", "--batch_size", "2", "--num_samples", "4",
                              "--classifier_scale", "10.0", "--seed", "7"],
    }
    return d, argv


@pytest.fixture(scope="module")
def basics(inputs):
    d, _ = inputs
    run_ranks("basics", str(d))
    return [torch.load(d / f"basics_rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def sampled(inputs):
    """Each CLI's ``.npz`` at world 2 (rank 0's) and at world 1."""
    d, argv = inputs
    for name, flags in argv.items():
        (d / f"{name}.argv").write_text("\n".join([*flags, "--main_path", str(d / "world2" / name)]))
    run_ranks("sample", str(d))
    paths = [torch.load(d / f"sample_rank{r}.pt", weights_only=False) for r in range(2)]
    one = {"image": image_sample.main([*argv["image_sample"], "--main_path", str(d / "world1" / "image")])["path"],
           "classifier": classifier_sample.main([*argv["classifier_sample"], "--main_path",
                                                 str(d / "world1" / "classifier")])["path"]}
    logger.reset()
    return paths, one


@pytest.mark.timeout(60)
def test_setup_dist_does_nothing_without_torchrun(monkeypatch):
    """As the JAX package's without its coordinator: no group, rank 0 of 1,
    and the collectives answer for one process."""
    for k in pdist.TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    assert pdist.setup_dist("cpu") is False and not pdist.is_initialized()
    assert (pdist.rank(), pdist.world_size(), pdist.is_primary()) == (0, 1, True)
    assert pdist.local_device("cuda") == torch.device("cuda") and pdist.local_device("cpu") == torch.device("cpu")
    np.testing.assert_array_equal(pdist.all_gather_host(np.arange(3)), np.arange(3)[None])
    pdist.barrier("one process")
    assert logger.distributed_weighted_mean({"a": 2.0}, {"a": 3}) == {"a": 2.0}
    with pdist.process_group("cpu") as device:
        assert device == torch.device("cpu") and not pdist.is_initialized()


@pytest.mark.timeout(60)
def test_local_device_under_torchrun(monkeypatch):
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    assert pdist.local_device("cuda") == torch.device("cuda", 1)
    assert pdist.local_device("cuda:0") == torch.device("cuda", 0) and pdist.local_device("cpu").type == "cpu"


@pytest.mark.timeout(60)
def test_setup_dist_starts_the_group_under_torchrun(basics):
    for r, out in enumerate(basics):
        assert (out["started"], out["rank"], out["world"], out["primary"]) == (True, r, 2, r == 0)


@pytest.mark.timeout(60)
def test_all_gather_host_shape_and_order(basics):
    want = np.stack([np.full((2, 3), r + 0.5, np.float32) for r in range(2)])
    for out in basics:
        assert out["gathered"].shape == (2, 2, 3) and out["gathered"].dtype == np.float32
        np.testing.assert_array_equal(out["gathered"], want)


@pytest.mark.timeout(60)
def test_barrier_waits_for_every_rank(basics):
    """Rank 1 writes a file half a second late, before the barrier: rank 0 sees it after."""
    assert all(out["marker_after_barrier"] for out in basics)


def _jax_batches(d, shard: int, order_seed: int, n: int):
    """The JAX loader's dataset for ``shard`` of 2, in ``random.Random(order_seed)``'s
    order, as batches of 2 (NCHW)."""
    files = JD.list_image_files_recursively(str(d / "images"))
    ds = JD.ImageDataset(16, files, shard=shard, num_shards=2, random_crop=True,
                         clip_file_path=str(d / "clip.npz"), seed=5)
    order_rng, order, out = random.Random(order_seed), [], []
    while len(out) < n:  # JAX _batched_iterator's epochs: a shuffle each, the tail dropped
        if len(order) < 2:
            order = list(range(len(ds)))
            order_rng.shuffle(order)
        rows, order = order[:2], order[2:]
        imgs, conds = zip(*(ds[i] for i in rows))
        cond = {k: np.stack([c[k] for c in conds]) for k in conds[0]}
        cond["img2"] = cond["img2"].transpose(0, 3, 1, 2)
        out.append((np.stack(imgs).transpose(0, 3, 1, 2), cond))
    return out


def _assert_batches_equal(got, want):
    for (x, c), (jx, jc) in zip(got, want, strict=True):
        np.testing.assert_array_equal(x, jx)
        assert c.keys() == jc.keys()
        for k in c:
            np.testing.assert_array_equal(c[k], jc[k])


@pytest.mark.timeout(60)
@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_reads_its_shard_as_jax(inputs, basics, rank):
    """Rank r of 2 reads ``files[r::2]``, its crops, flips and pairings from
    ``random.Random(seed + r)`` and its order from ``random.Random(1234 + r)``:
    the JAX ``ImageDataset(shard=r, num_shards=2)``'s batches."""
    d, _ = inputs
    _assert_batches_equal(basics[rank]["loader"], _jax_batches(d, rank, 1234 + rank, 3))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("shard", [0, 1])
def test_load_data_explicit_shard_matches_jax(inputs, shard):
    """``load_data(shard=, num_shards=)`` in one process: the JAX loader's
    ``_batched_iterator`` over ``ImageDataset(shard, 2)`` (order from rank 0's
    ``random.Random(1234)``)."""
    d, _ = inputs
    data = load_data(data_dir=str(d / "images"), batch_size=2, image_size=16, random_crop=True,
                     clip_file_path=str(d / "clip.npz"), seed=5, prefetch=0, shard=shard, num_shards=2)
    _assert_batches_equal([next(data) for _ in range(3)], _jax_batches(d, shard, 1234, 3))


@pytest.mark.timeout(60)
def test_loss_second_moment_resampler_over_two_ranks(basics):
    """Each rank's sampler gathers both ranks' (t, loss) before it updates:
    both hold the weights of one sampler fed the rank-ordered concatenation."""
    ref = LossSecondMomentResampler(10, history_per_term=2)
    rss = [np.random.RandomState(100 + r) for r in range(2)]
    for _ in range(8):
        ts, losses = [], []
        for rs in rss:
            t = rs.randint(0, 10, 6)
            ts.append(t)
            losses.append(rs.uniform(0, 2, 6) * (1 + t))
        ref.update_with_all_losses(np.concatenate(ts).tolist(), np.concatenate(losses).tolist())
    assert not np.allclose(ref.weights(), 0.1)  # warmed up
    for out in basics:
        np.testing.assert_array_equal(out["sampler_weights"], ref.weights())


@pytest.mark.timeout(60)
def test_distributed_weighted_mean_matches_jax(basics, monkeypatch):
    """The JAX function's arithmetic (``utils/logger.py:214-222``) on the
    same two ranks' values, its gather replaced by their stack."""
    from jax.experimental import multihost_utils

    import jax

    ranks = [({"a": r + 1.0, "b": 2.0 * r}, {"a": r + 1, "b": 1}) for r in range(2)]
    calls = iter([np.stack([np.array([v[k] for k in sorted(v)], np.float64) for v, _ in ranks]),
                  np.stack([np.array([float(c[k]) for k in sorted(c)], np.float64) for _, c in ranks])])
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda x: next(calls))
    want = jlogger.distributed_weighted_mean(*ranks[0])
    assert want == {"a": pytest.approx(5 / 3), "b": 1.0}
    for out in basics:
        assert out["weighted_mean"] == want


@pytest.mark.timeout(60)
def test_rank1_logs_only_to_its_rank_file(basics):
    """Rank 0 writes ``log.txt`` and ``progress.csv``; rank 1, with
    ``OPENAI_LOG_FORMAT_MPI``'s default, only ``log-rank001.txt``, into rank 0's
    directory."""
    assert basics[0]["log_files"] == basics[1]["log_files"] == ["log-rank001.txt", "log.txt", "progress.csv"]


@pytest.mark.timeout(120)
def test_image_sample_at_world_2(sampled):
    """Rank 0 writes one ``.npz`` of ``num_samples`` rows, the batches
    gathered in rank order; batch i of rank r draws counter ``i * 2 + r``, so
    the set is the one-process run's row for row (the model is unconditional)
    and rank 0's rows are its batches 0 and 2."""
    paths, one = sampled
    assert paths[0]["image"] == paths[1]["image"] and os.path.basename(paths[0]["image"]) == "samples_6x16x16x3.npz"
    got, want = np.load(paths[0]["image"])["arr_0"], np.load(one["image"])["arr_0"]
    assert got.shape == (6, 16, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    run_dir = os.path.dirname(paths[0]["image"])
    assert sorted(f for f in os.listdir(run_dir) if f.startswith("samples_test")) == ["samples_test0.png",
                                                                                     "samples_test1.png"]
    assert "log-rank001.txt" in os.listdir(run_dir)


@pytest.mark.timeout(120)
def test_classifier_sample_at_world_2(sampled):
    """Rank 0 writes one ``.npz`` of ``num_samples`` rows (images and labels),
    each batch gathered in rank order; rank 0 draws from the one-process
    run's generators, so its rows are that run's first rows; rank 1 draws
    from generators of its own."""
    paths, one = sampled
    got, want = np.load(paths[0]["classifier"]), np.load(one["classifier"])
    assert got["arr_0"].shape == (4, 64, 64, 3) and got["arr_1"].shape == (4,)
    np.testing.assert_array_equal(got["arr_0"][:2], want["arr_0"][:2])
    np.testing.assert_array_equal(got["arr_1"][:2], want["arr_1"][:2])
    assert (got["arr_0"][2:] != want["arr_0"][2:]).any()
