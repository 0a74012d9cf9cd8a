"""Planner, routing, mesh, distributed runtime and checkpoint."""
