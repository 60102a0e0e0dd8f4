"""Fault tolerance: checkpoints with integrity checks, fault injection and
the elastic kill-and-restart supervisor (the JAX package's ``repro.ft``
without its mesh resharding)."""
