from repro_torch.data.pipeline import PackedLMDataset, data_iterator

__all__ = ["PackedLMDataset", "data_iterator"]
