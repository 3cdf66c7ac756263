from . import evaluation, testing

__all__ = ["evaluation", "testing"]
