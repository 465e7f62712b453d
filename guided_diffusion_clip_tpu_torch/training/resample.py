"""Timestep samplers for training (reference resample.py).

The port's own copy of ``guided_diffusion_clip_tpu/training/resample.py``,
numpy only: ``UniformSampler`` (resample.py:61) and
``LossSecondMomentResampler`` (resample.py:124) importance-sample the
training timesteps on the host and return per-example weights
1 / (T * p[t]), so that the expected loss is unbiased (resample.py:42-59).
With the same ``np.random.Generator`` they draw the same t and weights as the
JAX package's samplers. A loss-aware sampler gathers every rank's (t, loss)
pairs before it updates, so every rank keeps the same history.
"""

from __future__ import annotations

import numpy as np

from ..parallel.dist import all_gather_host


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """resample.py:8-23."""
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class ScheduleSampler:
    """Base: ``weights()`` -> unnormalized per-timestep weights (resample.py:26-59)."""

    num_timesteps: int

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, batch_size: int, rng: np.random.Generator):
        """Importance-sample timesteps; returns (t int32, loss weights f32)."""
        w = self.weights()
        p = w / np.sum(w)
        indices = rng.choice(len(p), size=(batch_size,), p=p)
        weights = 1.0 / (len(p) * p[indices])
        return indices.astype(np.int32), weights.astype(np.float32)


class UniformSampler(ScheduleSampler):
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps
        self._weights = np.ones([num_timesteps], dtype=np.float64)

    def weights(self):
        return self._weights


class LossAwareSampler(ScheduleSampler):
    def update_with_local_losses(self, local_ts, local_losses) -> None:
        """Gather every rank's (t, loss) pairs in rank order, then update
        (resample.py:71-104; JAX ``training/resample.py:60-76``)."""
        ts = np.ravel(all_gather_host(np.asarray(local_ts)))
        losses = np.ravel(all_gather_host(np.asarray(local_losses)))
        self.update_with_all_losses(ts.tolist(), losses.tolist())

    def update_with_all_losses(self, ts, losses) -> None:
        raise NotImplementedError


class LossSecondMomentResampler(LossAwareSampler):
    """weights ∝ sqrt(E[loss^2]) over a length-10 history, plus a uniform
    floor (resample.py:124-154)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=int)

    def weights(self):
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        weights = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        weights /= np.sum(weights)
        weights *= 1 - self.uniform_prob
        weights += self.uniform_prob / len(weights)
        return weights

    def update_with_all_losses(self, ts, losses):
        for t, loss in zip(ts, losses):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()
