"""graphtpu_torch.ops — counterpart of graphtpu.ops."""
