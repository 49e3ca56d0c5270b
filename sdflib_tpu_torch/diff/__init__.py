"""Differentiable octree queries and depth rendering."""
from .query import octree_coefficients, octree_query_diff  # noqa: F401
