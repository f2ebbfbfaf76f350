"""graphtpu_torch.utils — counterpart of graphtpu.utils."""
