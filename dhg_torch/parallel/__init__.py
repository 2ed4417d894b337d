"""Multi-process training and sampling over torch.distributed (port of
dhg/parallel): process-group start-up (distributed), the (data, model)
grid of ranks and its process groups (mesh), the tensor-parallel rules and
the collectives of the seam in ops/ (sharding)."""
