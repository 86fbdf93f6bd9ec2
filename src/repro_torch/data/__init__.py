from .pipeline import DataConfig, PrefetchingLoader, synth_batch

__all__ = ["DataConfig", "PrefetchingLoader", "synth_batch"]
