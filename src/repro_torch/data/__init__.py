from .pipeline import SyntheticLM, TokenFileDataset, batch_for_step

__all__ = ["SyntheticLM", "TokenFileDataset", "batch_for_step"]
