"""Batched serving, mirroring ``repro.serve``: ``engine.ServeEngine``."""
