from .villain import Villain

__all__ = ['Villain']
