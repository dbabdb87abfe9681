from .adamw import AdamW, clip_by_global_norm, cosine_schedule, global_norm

__all__ = ["AdamW", "cosine_schedule", "clip_by_global_norm", "global_norm"]
