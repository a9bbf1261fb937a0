"""Distributed runtime (port of ``repro.distributed``): checkpoints and
the fault policy. Sharding and collectives are not ported yet."""
