"""graphtpu_torch.core — counterpart of graphtpu.core."""
