"""Hand-written Hopper kernels, each with its plain PyTorch version.

  cascade_tiered   NIC-tiered dataplane hop cascade (CUDA C++, sm_90a)
  linkload         flat hop cascade (``linkload_cascade``) and one-pass
                   link load (``linkload``) (CUDA C++, sm_90a)
  flash_attention  causal GQA flash attention (CUDA C++, sm_90a)
  cascade_common   what the three link-load wrappers share: the cluster
                   size and its occupancy check, the segment helpers

``ops`` holds the entry points and ``ref`` the plain versions under the
JAX package's names.
"""
