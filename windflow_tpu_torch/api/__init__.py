"""Pipeline composition of the port: ``MultiPipe`` and
``union_multipipes`` (copies of ``windflow_tpu/api/multipipe.py``).  The
builders (``*_Builder``) come with the device farms' slice (ROADMAP.md)."""

from .multipipe import MultiPipe, union_multipipes

__all__ = ["MultiPipe", "union_multipipes"]
