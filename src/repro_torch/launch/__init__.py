"""Step builders and the training driver, mirroring ``repro.launch``."""
