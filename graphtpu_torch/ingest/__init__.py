"""graphtpu_torch.ingest — counterpart of graphtpu.ingest."""
