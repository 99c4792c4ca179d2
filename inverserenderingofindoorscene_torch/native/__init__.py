"""Native (C) host code: the RGBE (.hdr) decoder with its fused envmap
pool (:mod:`inverserenderingofindoorscene_torch.native.hdr`).  Nothing is
built at import."""
