"""Channel parallelism over a device mesh.

The reference's only parallelism is one independent detector per audio
channel fanned out from the input callback (reference:
SyllableDetector/Processor.swift:57-59, 102-149) — embarrassingly parallel.
The multi-device design: stack per-channel network parameters on a leading
axis, ``vmap`` the detector over it, and shard that axis across a
``jax.sharding.Mesh`` with ``shard_map``. No collectives are needed inside a
hop (channels never communicate); ``psum`` appears only for aggregate
metrics, mirroring the reference's SummaryStat reductions. For one stream
too long for a single device, the time axis shards instead, with a one-hop
``ppermute`` halo exchange (sequence parallelism; SURVEY.md section 5).
"""

from syllable_detector_tpu.parallel.mesh import (
    make_mesh,
    batch_offline_outputs,
    sharded_offline_outputs,
    sharded_detection_counts,
    sharded_streaming_step,
    time_sharded_offline_outputs,
    tensor_sharded_offline_outputs,
)

__all__ = [
    "make_mesh",
    "batch_offline_outputs",
    "sharded_offline_outputs",
    "sharded_detection_counts",
    "sharded_streaming_step",
    "time_sharded_offline_outputs",
    "tensor_sharded_offline_outputs",
]
