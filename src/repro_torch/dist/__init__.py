"""The training side of the co-simulation, mirroring ``repro.dist``:

  * ``collectives`` — ``PathPlan``, ``PinnedPlan``, ``apply_plan`` and
    ``replan_chunk_paths``: the multipath plan of a chunked ring
    all-reduce, host side;
  * ``elastic``     — ``LinkHealth`` (phi-window path quarantine),
    ``TelemetryWatchdog``, ``remesh_plan`` and ``StragglerPolicy``;
  * ``netfeed``     — one feedback cycle: plan -> ring trace -> fluid
    simulation -> per-path congestion -> ``LinkHealth`` -> next plan;
  * ``cosim``       — the multi-epoch driver ``run_cosim`` over a fault
    schedule (killed and recovering spines, brown-outs, chaos campaigns,
    degraded telemetry), each epoch simulated on the card, and
    ``run_cosim_grid``.

Not ported yet: the ring all-reduce itself over ``torch.distributed``
(``seqbalance_all_reduce``, its wire encodings and ``quantize_int8``) and
``sharding``.
"""
from repro_torch.dist import collectives, cosim, elastic, netfeed  # noqa: F401
