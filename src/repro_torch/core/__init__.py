"""Transitive Array core: host planner (numpy) and device plans (torch)."""
