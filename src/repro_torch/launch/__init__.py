"""Launch entry points: the per-architecture optimizer choice (`cells`),
the train step (`steps`), the training loop (`train`) and the serving
command line with optional PIM protection (`serve`)."""
