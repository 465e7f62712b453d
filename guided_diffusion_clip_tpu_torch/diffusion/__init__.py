"""Diffusion schedules, q/p math and sampling loops on torch tensors."""

from .api import Diffusion
from .schedules import (
    DiffusionSchedule,
    LossType,
    ModelMeanType,
    ModelVarType,
    build_schedule,
    get_named_beta_schedule,
    space_timesteps,
)

__all__ = [
    "Diffusion",
    "DiffusionSchedule",
    "LossType",
    "ModelMeanType",
    "ModelVarType",
    "build_schedule",
    "get_named_beta_schedule",
    "space_timesteps",
]
