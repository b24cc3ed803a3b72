"""Model zoo of the port: the dense LM transformers, the GNNs and AutoInt.

The JAX package's functional contract, on torch tensors:

* ``init(cfg, seed, device)`` — parameters from a ``torch.Generator``
  (the same distributions as the JAX initialisers, not the same bits);
  ``params_from_arrays(cfg, tree, device)`` carries a JAX parameter tree,
  as numpy arrays, across;
* ``forward``/``prefill``/``decode_step_``/``sage_minibatch_forward``/
  ``retrieval_score`` as the
  family dictates, forward only (training is a later slice); the LM's
  decode step updates its cache in place (``model.decode_step_``).

Hot paths go through the port's CUDA kernels on the card: prefill
attention through ``kernels.flash_attention``, the GNNs' message passing
through ``kernels.gather_rows`` and ``kernels.segment_reduce``, AutoInt's
lookup through ``kernels.embedding_bag``.
"""
