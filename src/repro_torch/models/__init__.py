"""The dense decoder of the port (``build_model``) and its config."""
from .config import ModelConfig  # noqa: F401
from .model import build_model  # noqa: F401
