"""The LM model plane of the port: the dense decoder family of
``repro.models`` (``common``, ``attention``, ``transformer``, ``model``)
and ``convert``, which loads the reference's parameter tree."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
