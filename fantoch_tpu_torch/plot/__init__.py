"""Results persistence (the reference's ``plot`` package, its JSONL
store so far; the plots are ROADMAP item 18)."""

from .db import load_results, save_results

__all__ = ["load_results", "save_results"]
