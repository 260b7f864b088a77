"""Atomic, sha256-checked checkpoints of tensor trees: ``checkpoint.manager``."""
