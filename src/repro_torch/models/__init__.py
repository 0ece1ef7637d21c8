"""The model stack, mirroring ``repro.models``, for serving and training:

  common       norms, RoPE, activations, the truncated-normal init, and
               ``ParamModule`` (frozen weights, or float32 masters cast
               at each use)
  mlp          gated, ungated and squared-ReLU channel mixers
  attention    GQA attention with RoPE, qk-norm, window and softcap; full
               causal self-attention runs ``kernels.ops.flash_attention``
               (the hand-written kernel on the card), but where autograd
               records (training) the plain ``_sdpa`` / ``_sdpa_chunked``
               as the JAX package does; decode and cross-attention plain
               einsums, as in the JAX package
  transformer  units, superblock programs, the layer loop and remat
  model        init / forward / loss / prefill / decode_step
  weights      parameter trees carried across from the JAX package's
               layout and back, drawn with numpy for both packages, and
               the JAX package's leaf names

Ported: every unit (``attn``, ``cross``, ``mlp``, ``moe``, ``mlstm``,
``slstm`` and ``rglru``, the last four in ``moe`` and ``recurrent``), so
all ten configurations serve and train (``loss_fn`` under autograd; the
optimizer, the checkpoints and the train step are in ``repro_torch.train``
and ``repro_torch.launch``).
"""
