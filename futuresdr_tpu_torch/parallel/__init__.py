"""Multi-device parallelism: meshes, sequence-parallel stream operators, GPipe
pipelines, the sharded train step, and meshes across processes.

The counterpart of ``futuresdr_tpu/parallel``: within a process one controller
drives every device of a :class:`Mesh`; shards are lists of per-device
tensors, and every transfer between shards is an explicit, counted peer copy
(``mesh.py``). Across processes (``multihost.py``) every rank runs the same
program over one global mesh whose entries carry their ranks, each rank
holding its own shards, and a transfer between two ranks is a send and its
receive over ``torch.distributed``.
"""

from . import multihost
from .mesh import (Mesh, Sharded, describe_devices, factor_devices, make_mesh,
                   on_device, shard_params, visible_devices)
from .pipeline_pp import make_pp_pipeline
from .sharded_train import ShardedTrainStep
from .stream_sp import (place, sp_channelizer, sp_channelizer_a2a, sp_dechirp_scan,
                        sp_fir, sp_fir_fft_mag2, sp_fir_fft_mag2_stream, sp_fir_stream,
                        to_host)

__all__ = ["Mesh", "Sharded", "make_mesh", "factor_devices", "shard_params",
           "visible_devices", "describe_devices", "on_device", "place", "to_host",
           "sp_fir", "sp_fir_fft_mag2", "sp_fir_stream", "sp_fir_fft_mag2_stream",
           "sp_channelizer", "sp_channelizer_a2a", "sp_dechirp_scan", "make_pp_pipeline",
           "ShardedTrainStep", "multihost"]
