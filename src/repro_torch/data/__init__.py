"""The synthetic token pipeline of training: ``data.tokens``."""
