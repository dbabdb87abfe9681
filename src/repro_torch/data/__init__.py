from .pipeline import (SyntheticLM, TokenFileDataset, batch_for_step,
                       embedding_table)

__all__ = ["SyntheticLM", "TokenFileDataset", "batch_for_step",
           "embedding_table"]
