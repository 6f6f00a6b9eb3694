"""The distributed layer of the port: the mesh context (``axes``), the
sharding rules (``sharding``) and the BDI-compressed gradient collectives
(``compress_comm``), over ``torch.distributed``."""
