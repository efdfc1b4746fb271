"""Training launch: the per-architecture optimizer choice (`cells`), the
train step (`steps`) and the training driver (`train`)."""
