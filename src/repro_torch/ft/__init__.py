"""Fault tolerance: checkpoints with integrity checks, fault injection, the
elastic kill-and-restart supervisor and the reshard of a restored state
onto a new mesh (the JAX package's ``repro.ft``)."""
