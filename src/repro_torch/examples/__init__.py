"""The examples' twins: the JAX package's ``examples/`` scripts on the
port, each a short CLI (``python -m repro_torch.examples.<name>``) around a
function that the tests call.  They run on the card unless given
``--device cpu``."""
