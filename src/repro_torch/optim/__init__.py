"""Optimizer substrate (no external deps): AdamW, schedules, clipping and
error-feedback gradient compression, functional over nested dicts and
lists of tensors (the counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_init, adamw_update
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim.compression import (
    ErrorFeedbackState,
    compress_grads_int8,
    decompress_grads_int8,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "OptState",
    "cosine_schedule",
    "linear_warmup_cosine",
    "constant_schedule",
    "global_norm",
    "clip_by_global_norm",
    "compress_grads_int8",
    "decompress_grads_int8",
    "ErrorFeedbackState",
]
