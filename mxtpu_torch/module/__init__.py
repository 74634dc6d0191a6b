"""Module system — the port of ``mxtpu/module/`` (reference
``python/mxnet/module/``)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
