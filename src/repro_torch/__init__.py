"""PyTorch/CUDA port of the SharedMap process mapper (see ``repro_torch.core.api``)."""
