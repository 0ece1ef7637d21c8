"""Model configurations, mirroring ``repro.configs``: ``base`` holds the
dataclasses, one module per architecture the published numbers (``CONFIG``)
and a small twin for the CPU tests (``REDUCED``), and ``registry`` the
lookup by name."""
