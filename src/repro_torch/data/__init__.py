"""Host-side batch assembly for the training stream: message payloads to
fixed-size batches, and their copy onto the training device."""
from repro_torch.data.batching import batch_messages, shard_batch
from repro_torch.data.prefetch import DevicePrefetcher

__all__ = ["DevicePrefetcher", "batch_messages", "shard_batch"]
