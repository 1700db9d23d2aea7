from .basic import cg, cgls

__all__ = ["cg", "cgls"]
