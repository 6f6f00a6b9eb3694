"""Models of the port: the decoder-only transformer family (dense GQA,
MoE, MLA): params, forward, loss, prefill and decode."""
