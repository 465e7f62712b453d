"""The port's logger: the TensorBoard writer, ``log_suffix`` and
``scoped_configure``, against the JAX logger's file names and scopes."""

import os
import sys

import pytest

from guided_diffusion_clip_tpu.utils import logger as jlogger
from guided_diffusion_clip_tpu_torch.utils import logger


@pytest.fixture(autouse=True)
def _no_logger_left():
    yield
    logger.reset()


def test_tensorboard_scalars_land_at_the_step_key(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger.configure_dir(str(tmp_path), format_strs=["tensorboard"])
    for step, loss in ((7, 0.5), (9, 0.25)):
        logger.logkv("step", step)
        logger.logkv("loss", loss)
        logger.logkv("note", "text is not a scalar")
        logger.dumpkvs()
    logger.reset()  # closes the writer

    acc = EventAccumulator(str(tmp_path / "tb")).Reload()
    assert sorted(acc.Tags()["scalars"]) == ["loss", "step"]
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(7, 0.5), (9, 0.25)]
    assert [e.step for e in acc.Scalars("step")] == [7, 9]


def test_tensorboard_without_a_step_counts_dumps(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    logger.configure_dir(str(tmp_path), format_strs=["tensorboard"], log_suffix="-a")
    for loss in (3.0, 2.0, 1.0):
        logger.logkv("loss", loss)
        logger.dumpkvs()
    logger.reset()
    acc = EventAccumulator(str(tmp_path / "tb-a")).Reload()
    assert [(e.step, e.value) for e in acc.Scalars("loss")] == [(0, 3.0), (1, 2.0), (2, 1.0)]


def test_tensorboard_is_a_no_op_without_its_backend(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    fmt = logger.make_output_format("tensorboard", str(tmp_path))
    assert fmt.writer is None
    fmt.writekvs({"step": 1, "loss": 2.0})
    fmt.close()
    assert not (tmp_path / "tb").exists()


@pytest.mark.parametrize("suffix", ["", "-rank001"])
def test_log_suffix_names_the_files_as_the_jax_logger(tmp_path, suffix):
    formats = ["log", "json", "csv"]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port = [logger.make_output_format(f, str(port_dir), suffix) for f in formats]
    ref = [jlogger.make_output_format(f, str(jax_dir), suffix) for f in formats]
    for fmt in port + ref:
        fmt.writekvs({"step": 1, "loss": 0.5})
        fmt.close()
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert f"progress{suffix}.csv" in os.listdir(port_dir)
    for name in os.listdir(port_dir):
        if name.endswith(".csv"):
            assert (port_dir / name).read_text() == (jax_dir / name).read_text()


def test_scoped_configure_logs_elsewhere_for_the_block(tmp_path):
    outer, inner = tmp_path / "outer", tmp_path / "inner"
    logger.configure_dir(str(outer), format_strs=["csv", "log"])
    logger.logkv("loss", 1.0)
    logger.dumpkvs()
    with logger.scoped_configure(str(inner), format_strs=["csv"]):
        assert logger.get_dir() == str(inner)
        logger.logkv("val", 2.0)
        logger.dumpkvs()
    assert logger.get_dir() == str(outer)
    logger.logkv("loss", 3.0)
    logger.dumpkvs()
    logger.log("after the block")
    assert (inner / "progress.csv").read_text().splitlines() == ["val", "2.0"]
    assert (outer / "progress.csv").read_text().splitlines() == ["loss", "1.0", "3.0"]
    assert "after the block" in (outer / "log.txt").read_text()
