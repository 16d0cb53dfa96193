"""The device plane: the broker, the kernel blocks running a pipeline, and
the device-frame plane."""

from .autotune import autotune, autotune_streamed
from .frames import TpuD2H, TpuH2D, TpuMergeStage, TpuStage
from .instance import TpuInstance, instance
from .kernel_block import TpuDagKernel, TpuFanoutKernel, TpuKernel

__all__ = ["TpuInstance", "instance", "TpuKernel", "TpuFanoutKernel", "TpuDagKernel",
           "TpuH2D", "TpuStage", "TpuMergeStage", "TpuD2H", "autotune", "autotune_streamed"]
