"""The device plane: the broker and the flowgraph block running a pipeline."""

from .instance import TpuInstance, instance
from .kernel_block import TpuKernel

__all__ = ["TpuInstance", "instance", "TpuKernel"]
