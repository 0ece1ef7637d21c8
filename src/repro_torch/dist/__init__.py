"""The training side of the co-simulation, mirroring ``repro.dist``:

  * ``collectives`` — ``PathPlan``, ``PinnedPlan``, ``apply_plan`` and
    ``replan_chunk_paths`` (the multipath plan of a chunked ring
    all-reduce), and the ring itself: ``seqbalance_all_reduce`` over a
    ``LocalAxis`` (every member on one device) or a ``ProcessAxis`` (one
    member a process of a ``torch.distributed`` group), its wire
    encodings (``quantize_int8``), ``baseline_all_reduce`` and
    ``tree_all_reduce_mean``;
  * ``sharding``    — the FSDP + TP rules of the production meshes as
    pure functions of shapes (``param_specs``, ``batch_specs``,
    ``cache_specs``) and their DTensor ``placements``;
  * ``elastic``     — ``LinkHealth`` (phi-window path quarantine),
    ``TelemetryWatchdog``, ``remesh_plan`` and ``StragglerPolicy``;
  * ``netfeed``     — one feedback cycle: plan -> ring trace -> fluid
    simulation -> per-path congestion -> ``LinkHealth`` -> next plan;
  * ``cosim``       — the multi-epoch driver ``run_cosim`` over a fault
    schedule (killed and recovering spines, brown-outs, chaos campaigns,
    degraded telemetry), each epoch simulated on the card, and
    ``run_cosim_grid``.

``_compat`` (a jax-version shim) has nothing to port.
"""
from repro_torch.dist import collectives, cosim, elastic, netfeed, sharding  # noqa: F401
