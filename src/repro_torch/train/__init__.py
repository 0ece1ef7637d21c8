"""Training state, mirroring ``repro.train``: AdamW and checkpoints."""
