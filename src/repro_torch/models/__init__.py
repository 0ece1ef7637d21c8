"""The model stack, mirroring ``repro.models``, for serving:

  common       norms, RoPE, activations, the truncated-normal init
  mlp          gated, ungated and squared-ReLU channel mixers
  attention    GQA attention with RoPE, qk-norm, window and softcap; full
               causal self-attention runs ``kernels.ops.flash_attention``
               (the hand-written kernel on the card), decode and
               cross-attention plain einsums, as in the JAX package
  transformer  units, superblock programs and the layer loop
  model        init / forward / loss / prefill / decode_step
  weights      parameter trees carried across from the JAX package's
               layout, and drawn with numpy for both packages

Ported: every unit (``attn``, ``cross``, ``mlp``, ``moe``, ``mlstm``,
``slstm`` and ``rglru``, the last four in ``moe`` and ``recurrent``), so
all ten configurations serve, forward only.  Training waits in
ROADMAP.md's queue 1: no backward through the kernels, no remat, no
optimizer or checkpoints.
"""
