"""Multi-device parallelism: meshes, sequence-parallel stream operators, GPipe
pipelines.

The counterpart of ``futuresdr_tpu/parallel``: one process drives every device
of a :class:`Mesh`; shards are lists of per-device tensors, and every transfer
between shards is an explicit, counted peer copy (``mesh.py``). The
multi-host form (one process a host over ``torch.distributed``) is a later
slice.
"""

from .mesh import (Mesh, Sharded, describe_devices, factor_devices, make_mesh,
                   on_device, shard_params, visible_devices)
from .pipeline_pp import make_pp_pipeline
from .stream_sp import (place, sp_channelizer, sp_channelizer_a2a, sp_dechirp_scan,
                        sp_fir, sp_fir_fft_mag2, sp_fir_fft_mag2_stream, sp_fir_stream,
                        to_host)

__all__ = ["Mesh", "Sharded", "make_mesh", "factor_devices", "shard_params",
           "visible_devices", "describe_devices", "on_device", "place", "to_host",
           "sp_fir", "sp_fir_fft_mag2", "sp_fir_stream", "sp_fir_fft_mag2_stream",
           "sp_channelizer", "sp_channelizer_a2a", "sp_dechirp_scan", "make_pp_pipeline"]
