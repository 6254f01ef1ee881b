"""The port's decoder-only models (``build_model``: dense and MoE, with
attention or MLA) and their config."""
from .config import ModelConfig  # noqa: F401
from .model import build_model  # noqa: F401
