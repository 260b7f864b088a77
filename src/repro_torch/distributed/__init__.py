"""Fault tolerance of long runs: the port of ``repro.distributed.fault_tolerance``."""
