from .engine import Engine, GenParams, GenerationResult, Timings

__all__ = ["Engine", "GenParams", "GenerationResult", "Timings"]
