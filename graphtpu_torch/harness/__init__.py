"""graphtpu_torch.harness — counterpart of graphtpu.harness."""
