from repro_torch.data.pipeline import (PackedLMDataset, data_iterator,
                                       shard_batch)

__all__ = ["PackedLMDataset", "data_iterator", "shard_batch"]
