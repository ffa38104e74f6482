"""Client workload pieces the engine's lane construction needs."""

from .key_gen import zipf_weights

__all__ = ["zipf_weights"]
