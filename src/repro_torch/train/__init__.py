"""Greedy generation of the port (training is not part of this slice)."""
