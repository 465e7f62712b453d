"""``torch.profiler`` traces of a window of steps (``--profile_dir``).

Counterpart of ``guided_diffusion_clip_tpu/utils/profiling.py``: the train
and sample CLIs take ``--profile_dir <dir>`` and write a TensorBoard trace
(``*.pt.trace.json``, from ``torch.profiler.tensorboard_trace_handler``) of
the steps in a window, with named scopes (``annotate``) around the data,
step and validation work so host and card time line up in the timeline. The
card's kernels are traced where a CUDA device is present, the host's ops
always.
"""

from __future__ import annotations

import contextlib

import torch


class StepProfiler:
    """Trace a window of steps.

    Usage:
        prof = StepProfiler(profile_dir, first_step=1, num_steps=3)
        for step in ...:
            prof.maybe_start(step)
            with prof.step_scope(step): ...
            prof.maybe_stop(step)

    Tracing starts at ``first_step`` (step 0, with its set-up and first
    launches, would drown the trace) and stops after ``num_steps``; ``stop``
    ends a window that the loop left open. Does nothing when ``profile_dir``
    is empty.
    """

    def __init__(self, profile_dir: str | None, first_step: int = 1, num_steps: int = 3):
        self.profile_dir = profile_dir or None
        self.first_step = first_step
        self.last_step = first_step + num_steps - 1
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.profile_dir and self._prof is None and step == self.first_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.profile_dir),
            )
            self._prof.start()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.last_step:
            self.stop()

    def step_scope(self, step: int):
        if not self.profile_dir:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"step#{step}")

    def stop(self) -> None:
        """End the window; the trace handler writes the file."""
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the window's kernels end inside it
            self._prof.stop()
            self._prof = None


def annotate(name: str):
    """A named scope in the trace's timeline (host ops and the kernels they launch)."""
    return torch.profiler.record_function(name)
