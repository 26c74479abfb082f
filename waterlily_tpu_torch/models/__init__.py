"""Canonical simulation cases."""
from .cases import sphere_3d, heaving_sphere_3d  # noqa: F401
