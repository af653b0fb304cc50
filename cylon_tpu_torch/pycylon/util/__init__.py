from .benchutils import benchmark_with_repitions

__all__ = ["benchmark_with_repitions"]
