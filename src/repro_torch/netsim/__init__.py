"""Fluid network simulator (paper §IV) on PyTorch.

  topology   leaf_spine / hetero_leaf_spine / sim_2tier / three_tier fabrics,
             and the paper's testbed (testbed_symmetric / testbed_asymmetric)
  workloads  Poisson traces from the paper's flow-size CDFs (numpy)
  dataplane  hop cascade -> queues -> ECN marks; DRILL's spray
  dcqcn      fluid DCQCN rate control
  engine     SimConfig, per-flow constants
  compact    the active-window engine
  sweep      batched sweeps with spill retry
  profile    per-phase timing of the compact step, quiescence occupancy
  metrics    FCT / slowdown statistics (numpy)
  carry      configuration, trace and state from the JAX package's values
"""
