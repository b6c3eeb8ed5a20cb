from .timer import Timer

__all__ = ['Timer']
