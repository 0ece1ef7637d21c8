"""The distributed layer of the simulator's users: for now only what the
collective trace (``netsim.workloads.collective_trace``) needs, the ring
plan and the ring's members.  The rest of ``dist/`` (the epoch loop, the
collectives themselves) is a later slice of the port."""
