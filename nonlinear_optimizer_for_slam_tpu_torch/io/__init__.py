from . import g2o

__all__ = ["g2o"]
