"""Distributed runtime (port of ``repro.distributed``): checkpoints, the
fault policy and the logical-axis sharding rules (``sharding``).
Collectives (``collectives.py``) are ROADMAP item A10.2."""
