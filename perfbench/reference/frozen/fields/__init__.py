"""Host-int fields of the frozen copy: ``get_field`` is ``get_int_field``."""

from .int_field import get_int_field as get_field

__all__ = ["get_field"]
