"""graphtpu_torch.algorithms — counterpart of graphtpu.algorithms."""
