"""Model substrate of the port: the dense family behind one API
(`model.api`), as plain functions over nested dicts of tensors."""
from . import attention, convert, layers, model, transformer
from .model import api, count_params, init_model_params
