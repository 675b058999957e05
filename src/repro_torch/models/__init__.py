"""Model substrate of the port: every family of the reference (dense,
moe, ssm, hybrid, vlm, encdec) behind one API (`model.api`), as plain
functions over nested dicts of tensors."""
from . import (attention, convert, layers, model, moe, rglru, ssm,
               transformer, whisper)
from .model import api, count_params, init_model_params
