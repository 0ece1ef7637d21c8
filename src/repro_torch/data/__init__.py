"""The synthetic token stream of training, mirroring ``repro.data``."""
