"""Multi-process scale-out of the port over torch.distributed: frames shard
across ranks, per-shard stream statistics reduce through all-reduces, and
per-frame encoded byte lengths go through an all-gather and a prefix sum so
that every rank knows its frames' final stream offsets (the port of
flac_tpu.parallel, SURVEY.md §5.8)."""

from flac_tpu_torch.parallel.sharding import (
    ShardedEncodeResult,
    build_sharded_encode_step,
    make_mesh,
)

__all__ = ["make_mesh", "build_sharded_encode_step", "ShardedEncodeResult"]
