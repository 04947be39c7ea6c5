"""Multi-card rendering over ``torch.distributed`` (``sharded``)."""
