"""Models of the port, every family of the registry: decoder-only
transformers (dense GQA, MoE, MLA), xLSTM, the Hymba hybrid and the
encoder-decoder; params, forward, loss, prefill and decode."""
