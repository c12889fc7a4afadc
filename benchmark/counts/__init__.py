"""The card's published peaks and the kernels' frozen operation and byte
counts, from which the per-layer readers work out roofline shares."""
