"""The port's trainers on two processes (gloo on the CPU) against one process.

The two ranks run ``tests/torch_dist_worker.py`` under torchrun once for the
module (``scenario_train``): from the same weights, each rank takes its half
of a batch of 2B with given timesteps and noise, in each mode (DDP for
``tree``/``flat``, ``zero1``, ``fsdp``), saves, resumes in another mode and
takes a second step; int8 under DDP and FSDP2; a DCP save and resume; the
classifier's step under DDP and FSDP2. Here the one-rank port takes the same
steps on the doubled batch (the one-rank step is held to the JAX loop by
``test_torch_train.py``). f32 throughout: the gradient within 1e-5 relative
L2 of the one-rank step's; checkpoints and resumed steps within 1e-6 of the
replicated run's, as the norms are taken (over all parameters together; an
element whose gradient is rounding noise moves by +-lr under Adam).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from guided_diffusion_clip_tpu_torch.training import train_loop as TL
from guided_diffusion_clip_tpu_torch.utils import checkpoint as ckpt
from torch_dist_worker import B, MODES, batches, classifier_batch, classifier_trainer, make_loop, run_ranks, state, step

torch.set_num_threads(2)


def rel(a: dict, b: dict) -> float:
    """Relative L2 distance of ``a`` from ``b`` over all of their tensors."""
    assert a.keys() == b.keys()
    return (sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
            / sum(float(b[k].double().square().sum()) for k in b)) ** 0.5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_dist"))
    run_ranks("train", d)
    return d, [torch.load(os.path.join(d, f"train_rank{r}.pt"), weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def one_rank():
    """The one-rank port on the doubled batch: a step with one microbatch,
    its second step, and a step with two microbatches of B."""
    b1, b2 = batches(2 * B, 1), batches(2 * B, 2)
    loop = make_loop(tempfile.mkdtemp(), batch_size=2 * B)
    step(loop, b1, slice(None))
    out = {"step1": state(loop)}
    step(loop, b2, slice(None))
    out["step2"] = state(loop)
    loop = make_loop(tempfile.mkdtemp(), batch_size=2 * B, microbatch=B)
    step(loop, b1, slice(None))
    out["micro"] = state(loop)
    return out


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", list(MODES))
def test_two_rank_step_matches_one_rank_on_doubled_batch(ranks, one_rank, mode):
    """The gradient (the mean over the ranks), the logged loss (gathered over
    the ranks) and the updated parameters against the one-rank step."""
    _, out = ranks
    got, ref = out[0][mode], one_rank["step1"]
    assert rel(got["grad"], ref["grad"]) <= 1e-5
    assert rel(got["params"], ref["params"]) <= 1e-5
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", [*MODES, "tree_micro", "tree_step2", "dcp_uninterrupted", "int8_fsdp"])
def test_ranks_hold_bit_identical_parameters(ranks, mode):
    _, out = ranks
    for n, p in out[0][mode]["params"].items():
        assert torch.equal(p, out[1][mode]["params"][n]), n


@pytest.mark.timeout(120)
def test_microbatches_reduce_once(ranks, one_rank):
    """Two microbatches a rank, the first under ``no_sync()``: the summed
    microbatch gradients of both ranks, as one rank with two microbatches of B."""
    _, out = ranks
    assert rel(out[0]["tree_micro"]["grad"], one_rank["micro"]["grad"]) <= 1e-5


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", ["flat", "zero1", "fsdp"])
@pytest.mark.parametrize("kind", ["model", "ema_0.9", "ema_0.99", "opt"])
def test_checkpoints_equal_the_replicated_runs(ranks, mode, kind):
    """``model``/``ema``/``opt`` ``.pt`` files under the same names and layout
    as the replicated (DDP) run's, within 1e-6."""
    d, _ = ranks
    name = {"model": "model000000.pt", "opt": "opt000000.pt"}.get(kind, f"{kind}_000000.pt")
    got, ref = (torch.load(os.path.join(d, m, name), weights_only=True) for m in (mode, "tree"))
    if kind == "opt":
        assert got["count"] == ref["count"] == 1
        for k in ("m", "v"):
            assert rel(got[k], ref[k]) <= 1e-6
    else:
        assert rel(got, ref) <= 1e-6


@pytest.mark.timeout(120)
@pytest.mark.parametrize("src,mode", [("tree", "zero1"), ("zero1", "tree"), ("flat", "zero1"), ("zero1", "flat"),
                                      ("tree", "fsdp"), ("fsdp", "tree")])
def test_resume_across_modes(ranks, src, mode):
    """A run saved in one mode resumes in another: its second step equals the
    uninterrupted replicated run's (bit for bit between tree, flat and zero1)."""
    _, out = ranks
    got, ref = out[0][f"resume_{src}_{mode}"]["params"], out[0]["tree_step2"]["params"]
    if "fsdp" in (src, mode):
        assert rel(got, ref) <= 1e-6
    else:
        assert all(torch.equal(got[n], ref[n]) for n in ref)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", ["fsdp", "zero1", "tree"])
def test_dcp_resume_equals_uninterrupted(ranks, mode):
    """An FSDP2 run saved through DCP (``ckpt_backend orbax``) at step 0;
    resumed from ``<run>/orbax`` in each mode, the next step equals the
    uninterrupted run's."""
    _, out = ranks
    assert out[0][f"dcp_resume_{mode}_step"] == 0
    assert rel(out[0][f"dcp_resume_{mode}"]["params"], out[0]["dcp_uninterrupted"]["params"]) <= 1e-6


@pytest.mark.timeout(120)
def test_dcp_directory_loads_for_sampling(ranks):
    """``{run}/orbax/0/`` is a DCP directory (a file a rank); ``<run>/orbax``
    and ``<run>/orbax@ema_<rate>`` read its entries without a process group,
    equal to the ``.pt`` files of the same FSDP2 step."""
    d, _ = ranks
    orbax = os.path.join(d, "dcp", "orbax")
    assert sorted(os.listdir(os.path.join(orbax, "0"))) == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    for sel, name in (("", "model000000.pt"), ("@ema_0.9", "ema_0.9_000000.pt"), ("@ema_0.99", "ema_0.99_000000.pt")):
        got = ckpt.load_state_dict(orbax + sel)
        ref = torch.load(os.path.join(d, "fsdp", name), weights_only=True)
        assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
    with pytest.raises(KeyError, match="holds"):
        ckpt.load_state_dict(orbax + "@ema_0.5")


@pytest.mark.timeout(120)
def test_jax_orbax_directory_is_refused(tmp_path):
    """A JAX orbax run directory (tensorstore files) is refused with the
    conversion's recipe, by the sampling load and by a resume."""
    from guided_diffusion_clip_tpu.utils import checkpoint as jckpt

    box = jckpt.OrbaxCheckpointer(str(tmp_path / "run" / "orbax"))
    box.save(3, {"model": {"w": np.zeros(4, np.float32)}})
    box.wait()
    box.close()
    with pytest.raises(ValueError, match="save_pt_copy"):
        ckpt.load_state_dict(str(tmp_path / "run" / "orbax@ema_0.9999"))
    with pytest.raises(ValueError, match="save_pt_copy"):
        make_loop(str(tmp_path / "log"), resume_checkpoint=str(tmp_path / "run" / "orbax"))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("opt_impl", ["flat", "zero1"])
def test_fsdp_with_flat_or_zero1_raises(opt_impl):
    with pytest.raises(ValueError, match="does not compose with FSDP"):
        TL.check_ported(param_sharding="fsdp", opt_impl=opt_impl)


@pytest.mark.timeout(120)
def test_int8_fsdp_steps_match_replicated(ranks):
    """Two int8 steps (lr 1e-2, so that many weights move a level) under FSDP2
    and under DDP. FSDP2 refills the unsharded weights in place without a new
    version, so the convs' cached ``w_q`` must be dropped at each update:
    after the second step every cached ``w_q`` is the quantization of the
    weights after the first. The two modes' steps agree as far as the int8
    roundings let them (a level that rounds the other way on a 1e-8
    difference): 1e-3 relative L2 on the second step's gradient."""
    _, out = ranks
    assert out[0]["int8_fsdp"]["stale_w_q"] == [] and out[0]["int8_tree"]["stale_w_q"] == []
    assert rel(out[0]["int8_fsdp_step1"]["grad"], out[0]["int8_tree_step1"]["grad"]) <= 1e-3
    assert rel(out[0]["int8_fsdp"]["grad"], out[0]["int8_tree"]["grad"]) <= 1e-2


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_classifier_step_matches_one_rank_on_doubled_batch(ranks, mode):
    """``ClassifierTrainer.step`` on two ranks (two microbatches of one row
    each, the first under ``no_sync()``) against one rank on the doubled batch
    (two microbatches of two rows)."""
    _, out = ranks
    x, y, t, noise = classifier_batch(4)
    trainer = classifier_trainer(4)
    trainer.step(x, y, t=t, noise=noise)
    ps = dict(trainer.model.named_parameters())
    got = out[0]["classifier"][mode]
    assert rel(got["grad"], {n: p.grad for n, p in ps.items()}) <= 1e-5
    assert rel(got["params"], {n: p.detach() for n, p in ps.items()}) <= 1e-5
