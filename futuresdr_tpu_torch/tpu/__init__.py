"""The device plane: the broker, the kernel blocks running a pipeline, the
device-frame plane, and the blocks sharded over a mesh (``SpKernel``,
``PpKernel``)."""

from .autotune import autotune, autotune_streamed
from .frames import TpuD2H, TpuH2D, TpuMergeStage, TpuStage
from .instance import TpuInstance, instance
from .kernel_block import TpuDagKernel, TpuFanoutKernel, TpuKernel
from .pp_block import PpKernel
from .sp_block import SpKernel

__all__ = ["TpuInstance", "instance", "TpuKernel", "TpuFanoutKernel", "TpuDagKernel",
           "TpuH2D", "TpuStage", "TpuMergeStage", "TpuD2H", "SpKernel", "PpKernel", "autotune",
           "autotune_streamed"]
