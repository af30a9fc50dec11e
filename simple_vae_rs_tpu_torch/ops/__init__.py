"""Conv kernels, their plain versions, blocks and reshapes."""
